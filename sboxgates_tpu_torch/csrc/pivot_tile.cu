// Pivot 5-LUT tile: packed Karnaugh-cell constraints of one (low pair x
// high pair) tile of candidates {a<b<m<d<e} around a pivot gate m.
//
// Replaces the TPU kernel sboxgates_tpu/ops/pallas_pivot.py:133
// (pivot_constraints_pallas, packed operands: K1).  It computes, for every
// low row l, high row h and cell (s, j, c2)
//   bit (j << 3) | (s << 2) | c2 of req[l][h] = OR_w (L[j][l][w] & PM_s[w]
//                                                     & H[c2][h][w]) != 0
// where L is the low pair's cell j pre-intersected with the required-1 (or
// required-0) positions, PM_0/PM_1 are the pivot gate's table inverted /
// plain, and H[c2] is the high pair's cell c2.  The TPU form counts the
// intersections with two int8 matrix products per block and tests > 0;
// a count is > 0 exactly when the three masks share a position
// (sboxgates_tpu/ops/sweeps.py:858-861), so here each verdict is an
// AND-OR chain on the integer pipe (one lop3 per word) and no count
// matrix exists at all.  The TPU's int8 form of the same function, from
// operands expanded to lanes (:218, K2), runs on the tensor cores in
// pivot_pre.cu.
//
// Bound on the H100: integer operations.  A candidate costs 2 (req1, req0)
// x 32 cells x 8 words = 512 AND-OR steps plus 64 compare-and-pack steps,
// against 8 B of output; the inputs are a few KB per tile.  Design: a block
// of 128 threads owns 128 high rows (one per thread, its 4 x 8 high words
// in registers) and 8 low rows, whose pivot-masked words (2 req x 2 s x 4 j
// x 8 w) are built once in shared memory and read as broadcasts.  Writes
// are coalesced along the high axis.
//
// The pivot sweep itself launches the window kernel (sbgt_pivot_window):
// the same body for many tiles per launch (the grid's third axis is the
// tile), each block reading its tile descriptor and pivot table itself and
// fusing what followed every tile on the host — validity, the conflict test
// (req1 & req0) == 0 and the feasible count — so that a whole window costs
// one launch and one small copy of counts to the host, where the JAX
// package's lut5_pivot_stream (sboxgates_tpu/ops/sweeps.py:1121) runs its
// tile loop in one device dispatch.  The fused epilogue adds about 4
// operations per candidate to the body's 576.
//
// The lane form (sbgt_pivot_window_lanes) sweeps the windows of many
// search jobs in one launch, the lane flattened into the grid's third
// axis (z = lane * n + tile): each lane reads its own tables, cell words,
// validity and descriptors through lane strides and its own t0 and t_end
// from the card, so jobs at different tiles share the launch.  Its bound
// is the lanes' summed work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_timing.cuh"

namespace {

constexpr int kBH = 128;  // threads per block = high rows per block
constexpr int kBL = 8;    // low rows per block
constexpr int kWords = 8;

// Low-row words staged per block: [low][req][s][j][w].
struct LowTile {
  uint32_t w[kBL][2][2][4][kWords];
};

// Verdict words of one candidate: this thread's high row against staged
// low row l.
__device__ __forceinline__ void cell_words(const LowTile& lt,
                                           const uint32_t (&hw)[4][kWords],
                                           int l, uint32_t& r1, uint32_t& r0) {
  r1 = 0u;
  r0 = 0u;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t x1[kWords], x0[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        x1[w] = lt.w[l][0][s][j][w];
        x0[w] = lt.w[l][1][s][j][w];
      }
#pragma unroll
      for (int c2 = 0; c2 < 4; ++c2) {
        uint32_t a1 = 0u, a0 = 0u;
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          a1 |= x1[w] & hw[c2][w];
          a0 |= x0[w] & hw[c2][w];
        }
        const int bit = (j << 3) | (s << 2) | c2;
        r1 |= (a1 != 0u ? 1u : 0u) << bit;
        r0 |= (a0 != 0u ? 1u : 0u) << bit;
      }
    }
  }
}

// The shared tile body: verdict words for this thread's high row against
// the block's staged low rows.
__device__ __forceinline__ void tile_body(const LowTile& lt,
                                          const uint32_t (&hw)[4][kWords],
                                          int lo_base, int tl, int h, int th,
                                          uint32_t* __restrict__ req1,
                                          uint32_t* __restrict__ req0) {
  for (int l = 0; l < kBL; ++l) {
    const int lo = lo_base + l;
    if (lo >= tl) break;
    uint32_t r1, r0;
    cell_words(lt, hw, l, r1, r0);
    req1[(size_t)lo * th + h] = r1;
    req0[(size_t)lo * th + h] = r0;
  }
}

__global__ void __launch_bounds__(kBH)
pivot_packed_kernel(const uint32_t* __restrict__ l1,
                    const uint32_t* __restrict__ l0, int lstride,
                    const uint32_t* __restrict__ hcs, int hstride,
                    const uint32_t* __restrict__ pmw, int tl, int th,
                    uint32_t* __restrict__ req1, uint32_t* __restrict__ req0) {
  __shared__ LowTile lt;
  const int lo_base = blockIdx.y * kBL;
  // 8 lows x 2 req x 2 s x 4 j x 8 w = 1024 words, 8 per thread.
  for (int i = threadIdx.x; i < kBL * 128; i += blockDim.x) {
    const int w = i & 7, j = (i >> 3) & 3, s = (i >> 5) & 1,
              rq = (i >> 6) & 1, l = i >> 7;
    const int lo = lo_base + l;
    uint32_t v = 0u;
    if (lo < tl) {
      const uint32_t* src = rq ? l0 : l1;
      v = src[(size_t)j * lstride + (size_t)lo * kWords + w] &
          pmw[s * kWords + w];
    }
    lt.w[l][rq][s][j][w] = v;
  }
  __syncthreads();
  const int h = blockIdx.x * kBH + threadIdx.x;
  if (h >= th) return;
  uint32_t hw[4][kWords];
#pragma unroll
  for (int c2 = 0; c2 < 4; ++c2) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      hw[c2][w] = hcs[(size_t)c2 * hstride + (size_t)h * kWords + w];
    }
  }
  tile_body(lt, hw, lo_base, tl, h, th, req1, req0);
}

// The pivot window: tiles [t0, t0 + gridDim.z) of the descriptor list in
// one launch, each tile's validity, conflict test and feasible count fused
// behind the tile body above.  Descriptor row t is (m, lo0, lo_end, hi0,
// hi_end); the pivot's polarity words come from tables[m] here.  A
// candidate (l, h) of tile t is feasible when lo0 + l < lo_end,
// lowvalid[lo0 + l], hi0 + h < hi_end, highvalid[hi0 + h], t < t_end and
// (req1 & req0) == 0.  Per tile z of the window it writes req1/req0 (the
// raw words, as K1) and feas (0/1 bytes) at [z][l][h], and adds the
// feasible count to counts[z] (warp ballot + popc, one atomicAdd per
// block; counts is zeroed by the launcher).  Tiles at or past t_end write
// all-ones words and no feasible candidate, and read no descriptor.
// One block of the window: tile t of descs, its outputs at req1/req0/feas
// (already offset to the tile) and its feasible count at *tile_count.  Shared by the
// single-lane window kernel and its lane form.
__device__ __forceinline__ void window_block(
    const uint32_t* __restrict__ tables, const uint32_t* __restrict__ l1,
    const uint32_t* __restrict__ l0, int lstride,
    const uint32_t* __restrict__ hcs, int hstride,
    const uint8_t* __restrict__ lowvalid,
    const uint8_t* __restrict__ highvalid, const int32_t* __restrict__ descs,
    int t, int t_end, int tl, int th, uint32_t* __restrict__ req1,
    uint32_t* __restrict__ req0, uint8_t* __restrict__ feas,
    int32_t* __restrict__ tile_count) {
  __shared__ LowTile lt;
  __shared__ uint32_t pm[kWords];
  __shared__ int lvalid[kBL];
  __shared__ int warp_count[kBH / 32];
  const int lo_base = blockIdx.y * kBL;
  const int h = blockIdx.x * kBH + threadIdx.x;
  const bool h_in = h < th;
  if (t >= t_end) {  // block-uniform
    if (!h_in) return;
    for (int l = 0; l < kBL && lo_base + l < tl; ++l) {
      const size_t o = (size_t)(lo_base + l) * th + h;
      req1[o] = 0xffffffffu;
      req0[o] = 0xffffffffu;
      feas[o] = 0;
    }
    return;
  }
  const int* d = descs + (size_t)t * 5;
  const int m = d[0], lo0 = d[1], lo_end = d[2], hi0 = d[3], hi_end = d[4];
  if (threadIdx.x < kWords) pm[threadIdx.x] = tables[(size_t)m * kWords + threadIdx.x];
  if (threadIdx.x < kBL) {
    const int lo = lo_base + threadIdx.x;
    lvalid[threadIdx.x] =
        lo < tl && lo0 + lo < lo_end && lowvalid[lo0 + lo] != 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBL * 128; i += blockDim.x) {
    const int w = i & 7, j = (i >> 3) & 3, s = (i >> 5) & 1,
              rq = (i >> 6) & 1, l = i >> 7;
    const int lo = lo_base + l;
    uint32_t v = 0u;
    if (lo < tl) {
      const uint32_t* src = rq ? l0 : l1;
      v = src[(size_t)j * lstride + (size_t)(lo0 + lo) * kWords + w] &
          (s ? pm[w] : ~pm[w]);
    }
    lt.w[l][rq][s][j][w] = v;
  }
  __syncthreads();
  // Every thread stays to the ballot; rows past th only vote "infeasible".
  const bool h_ok = h_in && hi0 + h < hi_end && highvalid[hi0 + h] != 0;
  uint32_t hw[4][kWords];
#pragma unroll
  for (int c2 = 0; c2 < 4; ++c2) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      hw[c2][w] = h_in ? hcs[(size_t)c2 * hstride +
                             (size_t)(hi0 + h) * kWords + w]
                       : 0u;
    }
  }
  int count = 0;
  for (int l = 0; l < kBL; ++l) {
    const int lo = lo_base + l;
    if (lo >= tl) break;  // block-uniform
    uint32_t r1, r0;
    cell_words(lt, hw, l, r1, r0);
    const bool f = h_ok && lvalid[l] && (r1 & r0) == 0u;
    count += __popc(__ballot_sync(0xffffffffu, f));
    if (h_in) {
      const size_t o = (size_t)lo * th + h;
      req1[o] = r1;
      req0[o] = r0;
      feas[o] = f ? 1 : 0;
    }
  }
  if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kBH / 32; ++i) sum += warp_count[i];
    if (sum) atomicAdd(tile_count, sum);
  }
}

__global__ void __launch_bounds__(kBH)
pivot_window_kernel(const uint32_t* __restrict__ tables,
                    const uint32_t* __restrict__ l1,
                    const uint32_t* __restrict__ l0, int lstride,
                    const uint32_t* __restrict__ hcs, int hstride,
                    const uint8_t* __restrict__ lowvalid,
                    const uint8_t* __restrict__ highvalid,
                    const int32_t* __restrict__ descs, int t0, int t_end,
                    int tl, int th, uint32_t* __restrict__ req1,
                    uint32_t* __restrict__ req0, uint8_t* __restrict__ feas,
                    int32_t* __restrict__ counts) {
  const int z = blockIdx.z;
  const size_t tile_off = (size_t)z * tl * th;
  window_block(tables, l1, l0, lstride, hcs, hstride, lowvalid, highvalid,
               descs, t0 + z, t_end, tl, th, req1 + tile_off,
               req0 + tile_off, feas + tile_off, counts + z);
}

// The lane form: blockIdx.z = lane * n + tile.  Lane l has its own
// tables, cell words, validity and descriptors (each operand's lane
// stride in elements: tab_lane, l_lane, h_lane, valid_lane, desc_lane) and
// its own window [t0[l], t0[l] + n) cut at t_end[l]; a lane with
// t0 >= t_end (done, or past its last tile) writes all-ones words and no
// feasible candidate, as a tile past t_end does.  Outputs [lanes][n][tl][th]
// and counts [lanes][n].
__global__ void __launch_bounds__(kBH)
pivot_window_lanes_kernel(
    const uint32_t* __restrict__ tables, int tab_lane,
    const uint32_t* __restrict__ l1, const uint32_t* __restrict__ l0,
    int lstride, int l_lane, const uint32_t* __restrict__ hcs, int hstride,
    int h_lane, const uint8_t* __restrict__ lowvalid,
    const uint8_t* __restrict__ highvalid, int valid_lane,
    const int32_t* __restrict__ descs, int desc_lane,
    const int32_t* __restrict__ t0, const int32_t* __restrict__ t_end, int n,
    int tl, int th, uint32_t* __restrict__ req1, uint32_t* __restrict__ req0,
    uint8_t* __restrict__ feas, int32_t* __restrict__ counts) {
  const int z = blockIdx.z;
  const int lane = z / n;
  const size_t tile_off = (size_t)z * tl * th;
  window_block(tables + (size_t)lane * tab_lane, l1 + (size_t)lane * l_lane,
               l0 + (size_t)lane * l_lane, lstride,
               hcs + (size_t)lane * h_lane, hstride,
               lowvalid + (size_t)lane * valid_lane,
               highvalid + (size_t)lane * valid_lane,
               descs + (size_t)lane * desc_lane, t0[lane] + z % n, t_end[lane],
               tl, th, req1 + tile_off, req0 + tile_off, feas + tile_off,
               counts + z);
}

}  // namespace

extern "C" int sbgt_pivot_packed(const void* l1, const void* l0, int lstride,
                                 const void* hcs, int hstride, const void* pmw,
                                 int tl, int th, void* req1, void* req0,
                                 void* stream) {
  if (tl <= 0 || th <= 0) return 0;
  const dim3 grid((th + kBH - 1) / kBH, (tl + kBL - 1) / kBL);
  pivot_packed_kernel<<<grid, kBH, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)l1, (const uint32_t*)l0, lstride,
      (const uint32_t*)hcs, hstride, (const uint32_t*)pmw, tl, th,
      (uint32_t*)req1, (uint32_t*)req0);
  return (int)cudaGetLastError();
}

// tiles [t0, t0 + n) of descs (int32[*, 5], only rows below t_end are read):
// req1/req0 uint32[n, tl, th], feas uint8[n, tl, th], counts int32[n]
// (zeroed here, on the same stream).
// ev0/ev1: the launch's timing events or null (launch_timing.cuh).
extern "C" int sbgt_pivot_window(const void* tables, const void* l1,
                                 const void* l0, int lstride, const void* hcs,
                                 int hstride, const void* lowvalid,
                                 const void* highvalid, const void* descs,
                                 int t0, int n, int t_end, int tl, int th,
                                 void* req1, void* req0, void* feas,
                                 void* counts, void* stream, void* ev0,
                                 void* ev1) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || tl <= 0 || th <= 0) return sbgt_no_launch(ev0, ev1, s);
  cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)n * sizeof(int32_t), s);
  if (e == cudaSuccess) e = sbgt_record(ev0, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((th + kBH - 1) / kBH, (tl + kBL - 1) / kBL, n);
  pivot_window_kernel<<<grid, kBH, 0, s>>>(
      (const uint32_t*)tables, (const uint32_t*)l1, (const uint32_t*)l0,
      lstride, (const uint32_t*)hcs, hstride, (const uint8_t*)lowvalid,
      (const uint8_t*)highvalid, (const int32_t*)descs, t0, t_end, tl, th,
      (uint32_t*)req1, (uint32_t*)req0, (uint8_t*)feas, (int32_t*)counts);
  return sbgt_launched(ev1, s);
}

// The lane form of sbgt_pivot_window: ``lanes`` windows of n tiles in one
// launch; t0 and t_end are int32[lanes] on the card, counts int32[lanes][n]
// (zeroed here, on the same stream).
extern "C" int sbgt_pivot_window_lanes(
    const void* tables, int tab_lane, const void* l1, const void* l0,
    int lstride, int l_lane, const void* hcs, int hstride, int h_lane,
    const void* lowvalid, const void* highvalid, int valid_lane,
    const void* descs, int desc_lane, const void* t0, const void* t_end,
    int lanes, int n, int tl, int th, void* req1, void* req0, void* feas,
    void* counts, void* stream, void* ev0, void* ev1) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes <= 0 || n <= 0 || tl <= 0 || th <= 0) {
    return sbgt_no_launch(ev0, ev1, s);
  }
  if ((long long)lanes * n > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(
      counts, 0, (size_t)lanes * n * sizeof(int32_t), s);
  if (e == cudaSuccess) e = sbgt_record(ev0, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((th + kBH - 1) / kBH, (tl + kBL - 1) / kBL, lanes * n);
  pivot_window_lanes_kernel<<<grid, kBH, 0, s>>>(
      (const uint32_t*)tables, tab_lane, (const uint32_t*)l1,
      (const uint32_t*)l0, lstride, l_lane, (const uint32_t*)hcs, hstride,
      h_lane, (const uint8_t*)lowvalid, (const uint8_t*)highvalid, valid_lane,
      (const int32_t*)descs, desc_lane, (const int32_t*)t0,
      (const int32_t*)t_end, n, tl, th, (uint32_t*)req1, (uint32_t*)req0,
      (uint8_t*)feas, (int32_t*)counts);
  return sbgt_launched(ev1, s);
}
