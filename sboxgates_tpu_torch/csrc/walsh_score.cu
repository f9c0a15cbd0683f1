// Walsh-spectral gate scores for best-first candidate ordering.
//
// Replaces the TPU kernel sboxgates_tpu/ops/spectral.py:119
// (_gate_scores_pallas).  For gate g with 8-word truth table t[g]:
//   x[p]   = 1 - 2 * bit(t[g][p / 32], p % 32)          (p = 0..255)
//   X      = WHT(x)  (8-stage radix-2 butterfly, the JAX package's order)
//   corr   = sum_p X[p] * spectrum[p]   (int32, wrapping like JAX's int32)
//   out[g] = |floor(corr / 256)|
// The division floors (an arithmetic shift by 8), so the kernel agrees with
// the plain version on any spectrum, not only on a real target's.
//
// Design: one warp per gate.  Lane l owns the 8 positions p = 8 l + i,
// which are bits 8 (l % 4) .. 8 (l % 4) + 7 of word l / 4, so every lane
// reads one table word.  Butterfly stages h = 1, 2, 4 stay in registers;
// stages h = 8 .. 128 pair lane l with lane l ^ (h / 8) through
// __shfl_xor_sync.  The dot product is reduced across the warp by shuffles.
//
// Bound on the H100: at the search's shapes (B = 64 or 512 gates) one
// launch is bound by launch latency.  Over many gates the function's least
// work is about 256 integer adds and 36 B per gate: the transform is
// symmetric, so dot(WHT(x), s) = dot(x, WHT(s)) (also modulo 2^32), and
// WHT(s) is computed once.  This kernel runs the butterfly per gate
// instead, about 2.6 k operations per gate, ten times that least work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
walsh_score_kernel(const uint32_t* __restrict__ tables, int n_gates,
                   const int32_t* __restrict__ spectrum,
                   int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // This lane's 8 spectrum values, reused for every gate of the warp.
  int32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = spectrum[lane * 8 + i];

  for (int g = blockIdx.x * kWarpsPerBlock + warp; g < n_gates;
       g += gridDim.x * kWarpsPerBlock) {
    const uint32_t word = tables[(size_t)g * 8 + (lane >> 2)];
    const uint32_t bits = word >> ((lane & 3) * 8);
    int32_t x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = 1 - 2 * (int32_t)((bits >> i) & 1u);
    // In-register stages: h = 1, 2, 4 over the lane's 8 positions.
#pragma unroll
    for (int h = 1; h < 8; h <<= 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if ((i & h) == 0) {
          const int32_t a = x[i], b = x[i + h];
          x[i] = a + b;
          x[i + h] = a - b;
        }
      }
    }
    // Cross-lane stages: position bit h is lane bit h / 8.
#pragma unroll
    for (int hl = 1; hl < 32; hl <<= 1) {
      const bool upper = (lane & hl) != 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int32_t other = __shfl_xor_sync(kFull, x[i], hl);
        x[i] = upper ? other - x[i] : x[i] + other;
      }
    }
    // Wrapping int32 dot product with the spectrum (unsigned arithmetic,
    // so overflow is defined and matches two's-complement wrap).
    uint32_t acc = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += (uint32_t)x[i] * (uint32_t)s[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) {
      const int32_t q = ((int32_t)acc) >> 8;  // floor division by 256
      out[g] = q < 0 ? -q : q;
    }
  }
}

}  // namespace

extern "C" int sbgt_walsh_scores(const void* tables, int n_gates,
                                 const void* spectrum, void* out,
                                 void* stream) {
  if (n_gates <= 0) return 0;
  int blocks = (n_gates + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 65535) blocks = 65535;
  walsh_score_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tables, n_gates, (const int32_t*)spectrum,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
