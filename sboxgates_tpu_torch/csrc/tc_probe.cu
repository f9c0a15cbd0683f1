// Tensor-core rate probe: back-to-back products from registers (mma.sync)
// or from shared memory (wgmma), timed by the caller, for the 1-bit route
// of K1's lane form (pivot_tile.cu) and int8 beside it.  Replaces no TPU
// kernel and runs on no search path: NVIDIA publishes no 1-bit rate for
// Hopper, so the port's 1-bit peak (telemetry/attribution.py: PEAKS) is
// this probe's reading; chip_smoke.py runs it and prints the rates.
//
// kind 0: mma.sync.m16n8k256.b1.and.popc, kind 1: mma.sync.m16n8k32.s8
//   (8 warps a block, 8 independent products a warp per step);
// kind 2: wgmma m64n128k256.b1.and.popc, kind 3: wgmma m64n128k32.s8
//   (one warpgroup a block, 4 products per commit group, operands from 16
//   KB of shared memory without swizzle);
// kinds 4-6: whether the 1-bit products overlap integer work on one SM, as
//   the lane kernel needs them to: 8 b1 mma.sync a warp per step (4), 64
//   independent LOP3 a thread per step (5), or both (6), on the same grid.
// The operands' values do not matter to the rate; the sums go to `sink`
// so nothing is optimised away.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaThreads = 256;
constexpr int kMmaPerStep = 8;
constexpr int kWgThreads = 128;
constexpr int kWgPerStep = 4;

template <bool kB1>
__global__ void __launch_bounds__(kMmaThreads)
probe_mma_kernel(int iters, int* __restrict__ sink) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x * 2654435761u) ^ (iters + i);
  for (int i = 0; i < 2; ++i) b[i] = (threadIdx.x * 40503u) ^ (iters * 7 + i);
  int c[kMmaPerStep][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kMmaPerStep; ++u) {
      if constexpr (kB1) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(c[u][0]), "+r"(c[u][1]), "+r"(c[u][2]), "+r"(c[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(c[u][0]), "+r"(c[u][1]), "+r"(c[u][2]), "+r"(c[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      }
    }
  }
  int s = 0;
  for (int u = 0; u < kMmaPerStep; ++u)
    for (int i = 0; i < 4; ++i) s += c[u][i];
  sink[(blockIdx.x * blockDim.x + threadIdx.x) & 0xffff] = s;
}

template <bool kMma, bool kInt>
__global__ void __launch_bounds__(kMmaThreads)
probe_mix_kernel(int iters, int* __restrict__ sink) {
  uint32_t a[4], b[2], z[16];
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x * 2654435761u) ^ (iters + i);
  for (int i = 0; i < 2; ++i) b[i] = (threadIdx.x * 40503u) ^ (iters * 7 + i);
  for (int i = 0; i < 16; ++i) z[i] = threadIdx.x * 7 + i;
  int c[kMmaPerStep][4] = {};
  for (int it = 0; it < iters; ++it) {
    if constexpr (kMma) {
#pragma unroll
      for (int u = 0; u < kMmaPerStep; ++u)
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(c[u][0]), "+r"(c[u][1]), "+r"(c[u][2]), "+r"(c[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0] + it),
              "r"(b[1]));
    }
    if constexpr (kInt) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 16; ++i) z[i] = (z[i] & (it + k)) | z[(i + 3) & 15];
    }
  }
  int s = 0;
  for (int u = 0; u < kMmaPerStep; ++u)
    for (int i = 0; i < 4; ++i) s += c[u][i];
  for (int i = 0; i < 16; ++i) s += z[i];
  sink[(blockIdx.x * blockDim.x + threadIdx.x) & 0xffff] = s;
}

// K-major shared-memory descriptor without swizzle: 8 x 16 B core
// matrices, 128 B apart along K and 256 B apart along M or N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

template <bool kB1>
__global__ void __launch_bounds__(kWgThreads)
probe_wgmma_kernel(int iters, int* __restrict__ sink) {
  __shared__ __align__(1024) uint32_t sm[4096];
  for (int i = threadIdx.x; i < 4096; i += kWgThreads)
    sm[i] = (i * 2654435761u) ^ iters;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sm);
  const uint64_t da = smem_desc(base), db = smem_desc(base + 2048);
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < kWgPerStep; ++u) {
      if constexpr (kB1) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
          "%64, %65, p;\n}\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
          : "l"(da), "l"(db), "r"(1));
      } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
          "%64, %65, p;\n}\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
          : "l"(da), "l"(db), "r"(1));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += d[i];
  sink[(blockIdx.x * blockDim.x + threadIdx.x) & 0xffff] = s;
}

}  // namespace

// One probe launch of `blocks` blocks x `iters` steps of kind 0-6 (above);
// *issued (host) gets the number of tensor-core instructions it issues (for
// kind 5, of LOP3 instructions).
extern "C" int sbgt_tc_probe(int kind, int blocks, int iters, void* sink,
                             void* issued, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long* out = (long long*)issued;
  if (blocks <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case 0:
    case 1:
      *out = (long long)blocks * (kMmaThreads / 32) * iters * kMmaPerStep;
      if (kind == 0)
        probe_mma_kernel<true><<<blocks, kMmaThreads, 0, s>>>(iters, (int*)sink);
      else
        probe_mma_kernel<false><<<blocks, kMmaThreads, 0, s>>>(iters, (int*)sink);
      break;
    case 2:
    case 3:
      *out = (long long)blocks * iters * kWgPerStep;
      if (kind == 2)
        probe_wgmma_kernel<true><<<blocks, kWgThreads, 0, s>>>(iters, (int*)sink);
      else
        probe_wgmma_kernel<false><<<blocks, kWgThreads, 0, s>>>(iters, (int*)sink);
      break;
    case 4:
    case 5:
    case 6: {
      const long long mma = (long long)blocks * (kMmaThreads / 32) * iters *
                            kMmaPerStep;
      *out = kind == 5 ? mma * 8 : mma;  // 64 LOP3 a thread = 8 x 8 a warp
      if (kind == 4)
        probe_mix_kernel<true, false><<<blocks, kMmaThreads, 0, s>>>(iters, (int*)sink);
      else if (kind == 5)
        probe_mix_kernel<false, true><<<blocks, kMmaThreads, 0, s>>>(iters, (int*)sink);
      else
        probe_mix_kernel<true, true><<<blocks, kMmaThreads, 0, s>>>(iters, (int*)sink);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
