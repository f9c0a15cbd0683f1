// 5-LUT stage-A filter: packed Karnaugh-cell constraints of 5-tuples.
//
// Replaces the TPU kernel sboxgates_tpu/ops/pallas_filter.py:58
// (lut5_filter_cells), and fuses in the candidate gather
// tables[combos] that the TPU version left to XLA.
//
// For candidate n with gates (g0..g4) the 32 cells are the positions where
// the five tables take the bit pattern j (input i on cell-index bit 4-i, so
// input 0 is the MSB).  Cell j is required-1 when it meets
// need1 = mask & target on some position, required-0 when it meets
// need0 = mask & ~target; bit j of req1/req0 records that.
//
// Bound on the H100: integer operations.  Per candidate the doubling tree
// builds 62 cell words per table word and tests each against need1/need0
// (about 1.1k 32-bit logic operations over the 8 words), while the memory
// traffic is 20 B of gate ids in and 8 B of constraint words out.  The
// design keeps everything else off the memory path: the <= 512 x 8 table
// words sit in shared memory for the block, each thread owns one candidate,
// its cells live in registers, and the 32 required bits are OR-accumulated
// per cell over the 8 words before the one compare-and-pack at the end.
//
// The lane form (sbgt_lut5_filter_lanes) runs the filters of many search
// jobs in one launch: blockIdx.y picks the lane, whose block stages that
// lane's tables (at most 512 x 32 B = 16 KB) and runs the same body.  Its
// bound is the lanes' summed operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_timing.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 8;

// The block's work: stage one lane's tables and need words in shared
// memory, then one candidate per thread.  Shared by the single-lane kernel
// and the lane form (each block of which serves one lane).
__device__ __forceinline__ void filter_block(
    const uint32_t* __restrict__ tables, int n_tables,
    const int32_t* __restrict__ combos, int n,
    const uint32_t* __restrict__ target, const uint32_t* __restrict__ mask,
    uint32_t* __restrict__ req1, uint32_t* __restrict__ req0,
    uint32_t* s_tab) {
  __shared__ uint32_t s_need1[kWords], s_need0[kWords];
  for (int i = threadIdx.x; i < n_tables * kWords; i += blockDim.x) {
    s_tab[i] = tables[i];
  }
  if (threadIdx.x < kWords) {
    uint32_t m = mask[threadIdx.x], t = target[threadIdx.x];
    s_need1[threadIdx.x] = m & t;
    s_need0[threadIdx.x] = m & ~t;
  }
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int32_t* c = combos + (size_t)idx * 5;
  const uint32_t* r[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    // Gate ids are in [0, n_tables) by contract; the clamp only keeps a
    // bad id inside the shared table instead of faulting.
    const int g = min(max(c[i], 0), n_tables - 1);
    r[i] = s_tab + g * kWords;
  }

  uint32_t acc1[32], acc0[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    acc1[j] = 0u;
    acc0[j] = 0u;
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const uint32_t n1 = s_need1[w], n0 = s_need0[w];
    const uint32_t t0 = r[0][w], t1 = r[1][w], t2 = r[2][w], t3 = r[3][w],
                   t4 = r[4][w];
    // Doubling tree: level L holds the cells of inputs 0..L, index =
    // pattern of those inputs with input 0 as the MSB.
    uint32_t a[2] = {~t0, t0};
    uint32_t b[4], d[8], e[16];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      b[2 * i] = a[i] & ~t1;
      b[2 * i + 1] = a[i] & t1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[2 * i] = b[i] & ~t2;
      d[2 * i + 1] = b[i] & t2;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      e[2 * i] = d[i] & ~t3;
      e[2 * i + 1] = d[i] & t3;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t lo = e[i] & ~t4, hi = e[i] & t4;
      acc1[2 * i] |= lo & n1;
      acc0[2 * i] |= lo & n0;
      acc1[2 * i + 1] |= hi & n1;
      acc0[2 * i + 1] |= hi & n0;
    }
  }
  uint32_t p1 = 0u, p0 = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    p1 |= (acc1[j] != 0u ? 1u : 0u) << j;
    p0 |= (acc0[j] != 0u ? 1u : 0u) << j;
  }
  req1[idx] = p1;
  req0[idx] = p0;
}

__global__ void __launch_bounds__(kThreads)
lut5_filter_kernel(const uint32_t* __restrict__ tables, int n_tables,
                   const int32_t* __restrict__ combos, int n,
                   const uint32_t* __restrict__ target,
                   const uint32_t* __restrict__ mask,
                   uint32_t* __restrict__ req1, uint32_t* __restrict__ req0) {
  extern __shared__ uint32_t s_tab[];  // [n_tables][8]
  filter_block(tables, n_tables, combos, n, target, mask, req1, req0, s_tab);
}

// Lane form: blockIdx.y is the lane.  Lane l reads tables[l] ([n_tables][8]),
// combos[l] ([n][5]), target[l] and mask[l] ([8]) and writes req1[l] and
// req0[l] ([n]); each block stages its own lane's tables as above.
__global__ void __launch_bounds__(kThreads)
lut5_filter_lanes_kernel(const uint32_t* __restrict__ tables, int n_tables,
                         const int32_t* __restrict__ combos, int n,
                         const uint32_t* __restrict__ target,
                         const uint32_t* __restrict__ mask,
                         uint32_t* __restrict__ req1,
                         uint32_t* __restrict__ req0) {
  extern __shared__ uint32_t s_tab[];  // [n_tables][8]
  const size_t lane = blockIdx.y;
  filter_block(tables + lane * n_tables * kWords, n_tables,
               combos + lane * (size_t)n * 5, n, target + lane * kWords,
               mask + lane * kWords, req1 + lane * (size_t)n,
               req0 + lane * (size_t)n, s_tab);
}

}  // namespace

// ev0/ev1: the launch's timing events or null (launch_timing.cuh).
extern "C" int sbgt_lut5_filter(const void* tables, int n_tables,
                                const void* combos, int n, const void* target,
                                const void* mask, void* req1, void* req0,
                                void* stream, void* ev0, void* ev1) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return sbgt_no_launch(ev0, ev1, s);
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = (size_t)n_tables * kWords * sizeof(uint32_t);
  const cudaError_t e = sbgt_record(ev0, s);
  if (e != cudaSuccess) return (int)e;
  lut5_filter_kernel<<<blocks, kThreads, smem, s>>>(
      (const uint32_t*)tables, n_tables, (const int32_t*)combos, n,
      (const uint32_t*)target, (const uint32_t*)mask, (uint32_t*)req1,
      (uint32_t*)req0);
  return sbgt_launched(ev1, s);
}

// The lane form: ``lanes`` independent filters in one launch (tables
// [lanes][n_tables][8], combos [lanes][n][5], target/mask [lanes][8],
// req1/req0 [lanes][n]).
extern "C" int sbgt_lut5_filter_lanes(const void* tables, int n_tables,
                                      const void* combos, int n, int lanes,
                                      const void* target, const void* mask,
                                      void* req1, void* req0, void* stream,
                                      void* ev0, void* ev1) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || lanes <= 0) return sbgt_no_launch(ev0, ev1, s);
  const dim3 grid((n + kThreads - 1) / kThreads, lanes);
  const size_t smem = (size_t)n_tables * kWords * sizeof(uint32_t);
  const cudaError_t e = sbgt_record(ev0, s);
  if (e != cudaSuccess) return (int)e;
  lut5_filter_lanes_kernel<<<grid, kThreads, smem, s>>>(
      (const uint32_t*)tables, n_tables, (const int32_t*)combos, n,
      (const uint32_t*)target, (const uint32_t*)mask, (uint32_t*)req1,
      (uint32_t*)req0);
  return sbgt_launched(ev1, s);
}

extern "C" const char* sbgt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
