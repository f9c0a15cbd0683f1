// Bitslice evaluation of a found circuit: an interpreter over its gate
// program.
//
// Replaces the TPU kernel sboxgates_tpu/codegen/pallas_kernel.py:26
// (compile_pallas), which unrolled one circuit into a Pallas kernel.  Here
// one kernel serves every circuit: it walks the straight-line program
// (type, in1, in2, in3, func) that codegen/executor.py:gate_arrays gives,
// one gate after the other, for every word column of the input.
//
//   inputs uint32[n_in, W]  ->  out uint32[n_out, W]
//
// Bit j of inputs[i][w] is input variable i of evaluation 32 w + j; row r
// of out is the value of gate outs[r].  Gate semantics match the JAX
// package's core/ttable.py: a NOT gate is ~a; a 2-input gate of type f
// (0..15) is eval_gate2, f(1,1) = bit 0, f(1,0) = bit 1, f(0,1) = bit 2,
// f(0,0) = bit 3; a 3-LUT is eval_lut, bit k of func is the output for
// k = A<<2 | B<<1 | C.  Both are evaluated as sums of minterms.
//
// Design: one thread per word column w, neighbouring threads on
// neighbouring w, so every input load and output store is coalesced and the
// ragged edge of W is masked here (no padding).  The block stages the
// packed program (8 B per gate) in shared memory once, and keeps every gate
// value in dynamic shared memory laid out [gate][thread]: all threads of a
// warp read the same gate row at consecutive addresses, so there are no
// bank conflicts.  The block size is chosen by the caller from the gate
// count so that 8 G + 4 G T bytes fit in the 227 KB an SM gives one block
// (500 gates -> 64 threads, 128 KB).
//
// Bound on the H100: bytes for a small circuit (4 (n_in + n_out) B per
// word against a few operations per gate), integer operations for a large
// one: the minterm forms take several logic operations per gate and word
// where one LOP3 would do, and the shared-memory traffic of every gate
// value rides with them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kNot = 16;
constexpr uint32_t kLut = 18;

__device__ __forceinline__ uint32_t minterm(uint32_t f, int k) {
  return 0u - ((f >> k) & 1u);
}

__global__ void circuit_eval_kernel(const uint2* __restrict__ prog,
                                    int n_gates, int n_in,
                                    const int32_t* __restrict__ outs,
                                    int n_out,
                                    const uint32_t* __restrict__ inputs,
                                    int w_total, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint2* s_prog = reinterpret_cast<uint2*>(smem);  // [n_gates]
  uint32_t* vals = smem + 2 * n_gates;             // [n_gates][T]
  const int t = threadIdx.x;
  const int T = blockDim.x;
  for (int i = t; i < n_gates; i += T) s_prog[i] = prog[i];
  __syncthreads();

  const size_t w = (size_t)blockIdx.x * T + t;
  if (w >= (size_t)w_total) return;
  const size_t W = (size_t)w_total;
  for (int i = 0; i < n_in; ++i) vals[i * T + t] = inputs[i * W + w];
  for (int g = n_in; g < n_gates; ++g) {
    const uint2 p = s_prog[g];
    const uint32_t type = (p.y >> 16) & 0xffu;
    const uint32_t a = vals[(p.x & 0xffffu) * T + t];
    uint32_t r;
    if (type == kNot) {
      r = ~a;
    } else if (type == kLut) {
      const uint32_t b = vals[(p.x >> 16) * T + t];
      const uint32_t c = vals[(p.y & 0xffffu) * T + t];
      const uint32_t f = p.y >> 24;
      r = (minterm(f, 0) & ~a & ~b & ~c) | (minterm(f, 1) & ~a & ~b & c) |
          (minterm(f, 2) & ~a & b & ~c) | (minterm(f, 3) & ~a & b & c) |
          (minterm(f, 4) & a & ~b & ~c) | (minterm(f, 5) & a & ~b & c) |
          (minterm(f, 6) & a & b & ~c) | (minterm(f, 7) & a & b & c);
    } else {
      const uint32_t b = vals[(p.x >> 16) * T + t];
      r = (minterm(type, 0) & a & b) | (minterm(type, 1) & a & ~b) |
          (minterm(type, 2) & ~a & b) | (minterm(type, 3) & ~a & ~b);
    }
    vals[g * T + t] = r;
  }
  for (int r = 0; r < n_out; ++r) out[r * W + w] = vals[outs[r] * T + t];
}

}  // namespace

// prog: uint32[2 n_gates], per gate (in1 | in2 << 16, in3 | type << 16 |
// func << 24); outs: int32[n_out]; threads and smem as chosen by the caller.
// The dynamic shared-memory limit is raised to smem on every launch: the
// attribute is per device, and the call is cheap.  A size the card cannot
// give fails here.
extern "C" int sbgt_circuit_eval(const void* prog, int n_gates, int n_in,
                                 const void* outs, int n_out,
                                 const void* inputs, int w, void* out,
                                 int threads, int smem, void* stream) {
  if (w <= 0 || n_out <= 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      circuit_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (w + threads - 1) / threads;
  circuit_eval_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint2*)prog, n_gates, n_in, (const int32_t*)outs, n_out,
      (const uint32_t*)inputs, w, (uint32_t*)out);
  return (int)cudaGetLastError();
}
