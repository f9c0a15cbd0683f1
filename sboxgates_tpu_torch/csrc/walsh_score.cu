// Walsh-spectral gate scores for best-first candidate ordering (K5).
//
// Replaces the TPU kernel sboxgates_tpu/ops/spectral.py:119
// (_gate_scores_pallas).  For gate g with 8-word truth table t[g]:
//   x[p]   = 1 - 2 * bit(t[g][p / 32], p % 32)          (p = 0..255)
//   corr   = sum_p WHT(x)[p] * spectrum[p]   (int32, wrapping like JAX's)
//   out[g] = |floor(corr / 256)|
// The Sylvester Walsh-Hadamard matrix is symmetric, so the correlation is
// also dot(x, WHT(spectrum)), exactly modulo 2^32 (an integer matrix):
//   corr = sum_p S'[p] - 2 * sum_{p: bit p set} S'[p],   S' = WHT(spectrum)
// in wrapping uint32 arithmetic.  The division floors (an arithmetic shift
// by 8), so the kernel agrees with the plain version on any spectrum, not
// only on a real target's.
//
// Design (a byte table of partial sums): each block transforms the
// spectrum once in shared memory (8 stages of 256 wrapping adds), builds
// the byte table T[i][v] = sum of S'[8 i + b] over the set bits b of v
// (32 x 256 words, 32 KB, from 64 nibble tables of 16), and then strides
// over the gates, one gate per thread: 32 lookups and adds.  A grid of two
// blocks per SM pays the table once per block, not once per gate.
//
// Bound on the H100: bytes, 36 per gate (32 B of table in, 4 B of score
// out), against about 64 operations per gate.  What holds it short of that
// bound is shared memory: the 32 lanes of a lookup hit random banks, so a
// lookup instruction takes as many wavefronts as its most-loaded bank
// (about 3.5 expected for 32 random lookups).  At the search's shapes
// (B = 64 or 512 gates) one launch is bound by launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_timing.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
walsh_score_kernel(const uint4* __restrict__ tables, int n_gates,
                   const int32_t* __restrict__ spectrum,
                   int32_t* __restrict__ out) {
  __shared__ uint32_t s[256];
  __shared__ uint32_t nib[64][16];
  __shared__ uint32_t table[32 * 256];
  __shared__ uint32_t total;
  const int tid = threadIdx.x;
  if (tid < 256) s[tid] = (uint32_t)spectrum[tid];
  __syncthreads();
  // S' = WHT(spectrum), the JAX package's butterfly order; wrapping adds.
  for (int h = 1; h < 256; h <<= 1) {
    if (tid < 128) {
      const int p = (tid / h) * 2 * h + (tid % h);
      const uint32_t a = s[p], b = s[p + h];
      s[p] = a + b;
      s[p + h] = a - b;
    }
    __syncthreads();
  }
  // Nibble tables: nib[k][u] = sum of S'[4 k + b] over the set bits b of u.
  for (int e = tid; e < 64 * 16; e += kThreads) {
    const int k = e >> 4, u = e & 15;
    uint32_t acc = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) acc += ((u >> b) & 1) ? s[4 * k + b] : 0u;
    nib[k][u] = acc;
  }
  if (tid < 32) {  // the sum of S' (all bits clear)
    uint32_t acc = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += s[tid * 8 + i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (tid == 0) total = acc;
  }
  __syncthreads();
  // Byte table: byte i of a table covers positions 8 i .. 8 i + 7, its low
  // nibble 2 i and its high nibble 2 i + 1.
  for (int e = tid; e < 32 * 256; e += kThreads) {
    const int i = e >> 8, v = e & 255;
    table[e] = nib[2 * i][v & 15] + nib[2 * i + 1][v >> 4];
  }
  __syncthreads();
  const uint32_t sum = total;
  for (int g = blockIdx.x * kThreads + tid; g < n_gates;
       g += gridDim.x * kThreads) {
    const uint4 w0 = tables[2 * (size_t)g], w1 = tables[2 * (size_t)g + 1];
    const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    uint32_t acc = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc += table[(4 * k + q) * 256 + ((w[k] >> (8 * q)) & 255u)];
    }
    const int32_t c = (int32_t)(sum - 2u * acc) >> 8;  // floor division by 256
    out[g] = c < 0 ? -c : c;
  }
}

}  // namespace

// ev0/ev1: the launch's timing events or null (launch_timing.cuh).
extern "C" int sbgt_walsh_scores(const void* tables, int n_gates,
                                 const void* spectrum, void* out,
                                 void* stream, void* ev0, void* ev1) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_gates <= 0) return sbgt_no_launch(ev0, ev1, s);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = sbgt_record(ev0, s);
  if (e != cudaSuccess) return (int)e;
  int blocks = (n_gates + kThreads - 1) / kThreads;
  if (blocks > kBlocksPerSm * sms) blocks = kBlocksPerSm * sms;
  walsh_score_kernel<<<blocks, kThreads, 0, s>>>(
      (const uint4*)tables, n_gates, (const int32_t*)spectrum, (int32_t*)out);
  return sbgt_launched(ev1, s);
}
