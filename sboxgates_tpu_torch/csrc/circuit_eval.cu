// Bitslice evaluation of a found circuit: one LOP3 per gate and word.
//
// Replaces the TPU kernel sboxgates_tpu/codegen/pallas_kernel.py:26
// (compile_pallas), which unrolled one circuit into a Pallas kernel.  Here
// one kernel serves every circuit: it walks a straight-line program that
// codegen/cuda_kernel.py:pack_program lowers from the circuit, one
// instruction per live gate,
//
//   (imm8, a, b, c, dst):  vals[dst] = lop3.b32(vals[a], vals[b], vals[c], imm8)
//
// over value slots.  The host turns every gate into the lop3 immediate over
// (a = 0xF0, b = 0xCC, c = 0xAA): a 3-LUT's function byte is that immediate
// already (bit k is the output for k = A<<2 | B<<1 | C), a 2-input gate of
// type f (core/ttable.py: f(1,1) = bit 0, f(1,0) = bit 1, f(0,1) = bit 2,
// f(0,0) = bit 3) the immediate that ignores c, NOT 0x0F.  A liveness pass
// keeps only the gates an output needs, in depth-first order from the
// outputs, and gives each value a slot that is reused after its last
// reader, so a thread keeps the circuit's peak number of live values, not
// G.  Outputs stay live to the end and are stored from their slots.
//
//   inputs uint32[n_in, W]  ->  out uint32[n_out, W]
//
// Design: each thread evaluates 4 word columns — 4 consecutive words with
// 16-byte loads and stores when W is a multiple of 4 and the rows are
// aligned, else words base + j T (coalesced 4-byte accesses, the ragged
// edge of W masked here).  Its 4 words of a value sit in one 16-byte
// shared-memory cell vals[slot][t] (a warp reads 512 consecutive bytes: no
// bank conflicts).  Each instruction's immediate is warp-uniform.  One that
// reads c (a 3-LUT) selects one of 256 inline lop3.b32 variants — a switch
// generated from a template, which the compiler lowers to one jump table —
// and the variant runs on all 4 words, so one dispatch serves 4 words.  One
// that ignores c (NOT, a 2-input gate) runs as a select tree of 3 fixed
// LOP3 (1 when it reads a alone) over the immediate's bits as masks, with
// no branch; operands an immediate ignores are not loaded.
//
// Bound on the H100: bytes for the circuits users evaluate (4 (n_in +
// n_out) B per word against one LOP3 per live gate and word); the kernel
// itself is held by the latency of its per-gate chain (program word, operand
// loads, dispatch, store through shared memory) at the few warps per SM
// that the slots leave room for.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_timing.cuh"

namespace {

constexpr int kWordsPerThread = 4;
constexpr int kInputBatch = 4;

template <int kImm>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(r) : "r"(a), "r"(b), "r"(c), "n"(kImm));
  return r;
}

template <int kImm>
__device__ __forceinline__ uint4 lop3x4(const uint4& a, const uint4& b,
                                        const uint4& c) {
  return make_uint4(lop3<kImm>(a.x, b.x, c.x), lop3<kImm>(a.y, b.y, c.y),
                    lop3<kImm>(a.z, b.z, c.z), lop3<kImm>(a.w, b.w, c.w));
}

#define SBGT_CASE(i) \
  case (i):          \
    return lop3x4<(i)>(a, b, c);
#define SBGT_CASE4(i) SBGT_CASE(i) SBGT_CASE(i + 1) SBGT_CASE(i + 2) SBGT_CASE(i + 3)
#define SBGT_CASE16(i) \
  SBGT_CASE4(i) SBGT_CASE4(i + 4) SBGT_CASE4(i + 8) SBGT_CASE4(i + 12)
#define SBGT_CASE64(i) \
  SBGT_CASE16(i) SBGT_CASE16(i + 16) SBGT_CASE16(i + 32) SBGT_CASE16(i + 48)

// The 256 lop3 variants, one per immediate.
__device__ __forceinline__ uint4 lop3_dispatch(uint32_t imm, const uint4& a,
                                               const uint4& b, const uint4& c) {
  switch (imm) {
    SBGT_CASE64(0)
    SBGT_CASE64(64)
    SBGT_CASE64(128)
    SBGT_CASE64(192)
  }
  return a;  // unreachable: imm < 256
}

#undef SBGT_CASE64
#undef SBGT_CASE16
#undef SBGT_CASE4
#undef SBGT_CASE

__device__ __forceinline__ uint32_t sel(uint32_t s, uint32_t x1, uint32_t x0) {
  return lop3<0xCA>(s, x1, x0);  // s ? x1 : x0, bitwise
}

// Mask of bit k of the immediate: all ones where the function is 1 at
// (a, b, c) = (k >> 2, k >> 1, k) & 1.
__device__ __forceinline__ uint32_t imm_mask(uint32_t imm, int k) {
  return 0u - ((imm >> k) & 1u);
}

// One instruction on 4 words: ctrl = imm | use_b << 8 | use_c << 9 | ...
__device__ __forceinline__ uint4 eval_gate(uint32_t ctrl, const uint4& a,
                                           const uint4& b, const uint4& c) {
  const uint32_t imm = ctrl & 0xffu;
  if (ctrl & 0x200u) return lop3_dispatch(imm, a, b, c);
  const uint32_t m0 = imm_mask(imm, 0), m2 = imm_mask(imm, 2),
                 m4 = imm_mask(imm, 4), m6 = imm_mask(imm, 6);
  if (ctrl & 0x100u) {
#define SBGT_TREE2(x) sel(a.x, sel(b.x, m6, m4), sel(b.x, m2, m0))
    return make_uint4(SBGT_TREE2(x), SBGT_TREE2(y), SBGT_TREE2(z), SBGT_TREE2(w));
#undef SBGT_TREE2
  }
  return make_uint4(sel(a.x, m4, m0), sel(a.y, m4, m0), sel(a.z, m4, m0),
                    sel(a.w, m4, m0));
}

template <bool kVec>
__device__ __forceinline__ uint4 load_row(const uint32_t* __restrict__ row,
                                          size_t base, int T, size_t W,
                                          bool ok) {
  if (kVec) {
    return ok ? *reinterpret_cast<const uint4*>(row + base) : make_uint4(0, 0, 0, 0);
  }
  uint32_t v[kWordsPerThread];
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    const size_t w = base + (size_t)j * T;
    v[j] = w < W ? row[w] : 0u;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool kVec>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ row, size_t base,
                                          int T, size_t W, bool ok, uint4 v) {
  if (kVec) {
    if (ok) *reinterpret_cast<uint4*>(row + base) = v;
    return;
  }
  const uint32_t vv[kWordsPerThread] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    const size_t w = base + (size_t)j * T;
    if (w < W) row[w] = vv[j];
  }
}

// prog: per instruction (imm | use_b << 8 | use_c << 9 | dst << 16, a, b, c)
// over slots; slots 0..n_in-1 hold the inputs on entry; outs: the slot of
// each output row.  At most 128 threads and 64 registers a thread, so 8
// blocks fit an SM where the slots' shared memory allows.
template <bool kVec>
__global__ void __launch_bounds__(128, 8)
circuit_eval_kernel(const uint4* __restrict__ prog, int n_prog, int n_in,
                    const int32_t* __restrict__ outs, int n_out,
                    const uint32_t* __restrict__ inputs, int w_total,
                    uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint4* s_prog = smem;            // [n_prog]
  uint4* vals = smem + n_prog;     // [n_slots][T]
  const int t = threadIdx.x;
  const int T = blockDim.x;
  for (int i = t; i < n_prog; i += T) s_prog[i] = prog[i];

  const size_t W = (size_t)w_total;
  const size_t blk = (size_t)blockIdx.x * T * kWordsPerThread;
  const size_t base = kVec ? blk + (size_t)t * kWordsPerThread : blk + t;
  const bool ok = base < W;  // the vector path's 4 words, as W % 4 == 0
  // Inputs in batches of 4 rows, every load of a batch issued before the
  // first store.
  for (int i0 = 0; i0 < n_in; i0 += kInputBatch) {
    uint4 v[kInputBatch];
#pragma unroll
    for (int ii = 0; ii < kInputBatch; ++ii) {
      v[ii] = i0 + ii < n_in
                  ? load_row<kVec>(inputs + (size_t)(i0 + ii) * W, base, T, W, ok)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int ii = 0; ii < kInputBatch; ++ii) {
      if (i0 + ii < n_in) vals[(i0 + ii) * T + t] = v[ii];
    }
  }
  __syncthreads();
  for (int g = 0; g < n_prog; ++g) {
    const uint4 p = s_prog[g];
    const uint4 a = vals[p.y * T + t];
    const uint4 b = (p.x & 0x100u) ? vals[p.z * T + t] : a;
    const uint4 c = (p.x & 0x200u) ? vals[p.w * T + t] : a;
    vals[(p.x >> 16) * T + t] = eval_gate(p.x, a, b, c);
  }
  for (int r = 0; r < n_out; ++r) {
    store_row<kVec>(out + (size_t)r * W, base, T, W, ok, vals[outs[r] * T + t]);
  }
}

template <bool kVec>
int launch(const void* prog, int n_prog, int n_in, const void* outs, int n_out,
           const void* inputs, int w, void* out, int threads, int smem,
           cudaStream_t stream, void* ev0, void* ev1) {
  cudaError_t e = cudaFuncSetAttribute(
      circuit_eval_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess) e = sbgt_record(ev0, stream);
  if (e != cudaSuccess) return (int)e;
  const long long per_block = (long long)threads * kWordsPerThread;
  const int blocks = (int)((w + per_block - 1) / per_block);
  circuit_eval_kernel<kVec><<<blocks, threads, smem, stream>>>(
      (const uint4*)prog, n_prog, n_in, (const int32_t*)outs, n_out,
      (const uint32_t*)inputs, w, (uint32_t*)out);
  return sbgt_launched(ev1, stream);
}

}  // namespace

// prog: uint32[4 n_prog] (see the kernel); outs: int32[n_out] slots;
// threads (at most 128) and smem (16 (n_prog + n_slots threads) bytes) as
// chosen by the caller (codegen/cuda_kernel.py:block_shape).  The vector
// path runs when W is a multiple of 4 and inputs and out are 16-byte
// aligned.  The dynamic shared-memory limit is raised to smem on every
// launch: the attribute is per device, and the call is cheap.  A size the
// card cannot give fails here.
// ev0/ev1: the launch's timing events or null (launch_timing.cuh).
extern "C" int sbgt_circuit_eval(const void* prog, int n_prog, int n_in,
                                 const void* outs, int n_out,
                                 const void* inputs, int w, void* out,
                                 int threads, int smem, void* stream,
                                 void* ev0, void* ev1) {
  cudaStream_t s = (cudaStream_t)stream;
  if (w <= 0 || n_out <= 0) return sbgt_no_launch(ev0, ev1, s);
  const bool vec = w % 4 == 0 && ((uintptr_t)inputs & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  return vec ? launch<true>(prog, n_prog, n_in, outs, n_out, inputs, w, out,
                            threads, smem, s, ev0, ev1)
             : launch<false>(prog, n_prog, n_in, outs, n_out, inputs, w, out,
                             threads, smem, s, ev0, ev1);
}
