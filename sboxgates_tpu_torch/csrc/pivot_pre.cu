// Pivot 5-LUT tile from int8 lanes on the tensor cores (K2).
//
// Replaces the TPU kernel sboxgates_tpu/ops/pallas_pivot.py:218
// (pivot_constraints_pallas_pre).  It computes K1's function by the TPU's
// own route: for low row l, high row h and cell (s, j, c2) the count
//   C[s, j, l; c2, h] = sum_k A[s, j, l, k] * H[c2, h, k]      (k < 256)
// of positions where the low pair's cell j (pre-intersected with the
// required-1, or required-0, positions), the pivot polarity s and the high
// pair's cell c2 meet, for req1 and for req0, with A and H int8 0/1 lanes;
// bit (j << 3) | (s << 2) | c2 of req[l][h] is C > 0.  No count is written:
// each s32 accumulator becomes its bit in registers.  Counts never exceed
// 256, so s32 cannot overflow.
//
// Bound on the H100: int8 tensor-core operations, 2 x 2 x (8 tl) x (4 th)
// x 256 per tile (8.6e9 at 512 x 512, 0.0043 ms at 1,979 T/s), half the
// integer pipe's bound for K1's AND-OR form of the same function.
//
// Design.  mma.sync.m16n8k32.s8 from ldmatrix fragments, not wgmma: the
// accumulator layout of mma.sync is fixed and documented per lane, which
// the epilogue below is built on, and its operands need no shared-memory
// descriptors.  wgmma forms of the same item (A from registers, B from
// 128-byte-swizzled shared memory) were correct but not faster: the
// tensor pipe is not what holds this kernel, its per-item instructions
// are (fragment loads and masks, one bit per accumulator; PERF.md §6).
//   - The M index of a fragment is the low row (16 per fragment) and the N
//     index is 2 h + (c2 & 1) for 4 high rows; (req, s, j) and c2 >> 1
//     select the fragment.  Lane (g = lane / 4, t = lane % 4) then holds, in
//     its accumulators c0/c1 (c2) and c2/c3 (c3), all 32 cells of the two
//     candidates (l = g, h = t) and (l = g + 8, h = t) of its 16 x 4 unit:
//     the epilogue packs them with no ballot or shuffle, and the fused
//     window epilogue (validity, (req1 & req0) == 0, feasible count) runs
//     on words a lane owns.
//   - The pivot polarity is folded into the B fragments in registers: the
//     lanes of H are ANDed with the pivot's lanes (s = 1) or their
//     complement (s = 0), from 64 mask words staged beside the rows, so A
//     is staged once for both s.
//   - A warp runs its unit one req at a time: 64 accumulators, 16
//     independent mma per k-step of 32 lanes, from 4 A fragments and one B
//     ldmatrix.x4, within 128 registers, so a block of 16 warps fits an SM
//     (8 warps holding both req at once ran slower on the card).
//   - Work item = 32 low x 32 high rows of one tile: A (2 req x 4 j x 32
//     rows) and H (4 c2 x 32 rows) at the full depth of 256 lanes, 96 KB,
//     staged with cp.async into rows of 256 B whose 16-byte chunks are
//     XOR-swizzled by the row (ldmatrix reads 8 rows without bank
//     conflicts).  Blocks are persistent (one per SM, 16 warps) and
//     double-buffered across their work items: the next item's cp.async
//     copies run while the tensor cores work on this one.
//   - One kernel serves the window of the pivot sweep (descriptors,
//     polarity from tables[m], validity, feasible flags and counts, as K1's
//     sbgt_pivot_window) and the single tile of the TPU kernel's contract,
//     whose A operands already carry the polarity (kFolded: A staged per s,
//     16 low rows per item, no mask).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_timing.cuh"

namespace {

constexpr int kThreads = 512;            // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBH = 32;                  // high rows per work item
constexpr int kRow = 256;                // bytes (lanes) per row
constexpr int kHRows = 4 * kBH;          // H rows: [c2 >> 1][h][c2 & 1]
constexpr int kARows = 256;              // A rows per item (both variants)
constexpr int kMasks = (kARows + kHRows) * kRow;  // offset of the masks
constexpr int kStage = kMasks + 64 * 4;  // 96 KB of rows + 256 B of masks

struct Params {
  const int8_t* a[2];    // low lanes of req1, req0
  long long a_plane;     // elements between (s, j) planes of A
  const int8_t* h;       // high lanes
  long long h_plane;     // elements between c2 planes of H
  const uint32_t* tables;       // window: pivot tables (polarity)
  const uint8_t* lowvalid;      // window only
  const uint8_t* highvalid;     // window only
  const int32_t* descs;         // window: (m, lo0, lo_end, hi0, hi_end);
                                // null: the single tile
  int t0, n, t_end, tl, th;
  uint32_t* req1;
  uint32_t* req0;
  uint8_t* feas;                // window only
  int32_t* counts;              // window only
};

template <bool kFolded>
struct Shape {
  static constexpr int kS = kFolded ? 2 : 1;     // A row sets per (req, j)
  static constexpr int kBL = kFolded ? 16 : 32;  // low rows per item
  static_assert(2 * kS * 4 * kBL == kARows, "A rows per item");
};

// A tile's place in the descriptor list, or the single tile.
struct Tile {
  bool live;
  int m, lo0, lo_end, hi0, hi_end;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int z) {
  Tile t{true, 0, 0, 0, 0, 0};
  if (p.descs == nullptr) return t;
  const int ti = p.t0 + z;
  if (ti >= p.t_end) {
    t.live = false;
    return t;
  }
  const int32_t* d = p.descs + (size_t)ti * 5;
  t.m = d[0];
  t.lo0 = d[1];
  t.lo_end = d[2];
  t.hi0 = d[3];
  t.hi_end = d[4];
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of staged row r (chunks XOR-swizzled).
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return (uint32_t)(r * kRow + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros (rows past the tile's edge).
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 bits -> 4 bytes of 0/1 (bit i -> byte i).
__device__ __forceinline__ uint32_t bytes01(uint32_t x) {
  x &= 0xFu;
  return (x | (x << 7) | (x << 14) | (x << 21)) & 0x01010101u;
}

template <bool kFolded>
__device__ __forceinline__ void item_coords(const Params& p, int item, int& z,
                                            int& ly, int& hx) {
  const int nly = (p.tl + Shape<kFolded>::kBL - 1) / Shape<kFolded>::kBL;
  const int nhx = (p.th + kBH - 1) / kBH;
  z = item / (nly * nhx);
  const int rem = item - z * nly * nhx;
  ly = rem / nhx;
  hx = rem - ly * nhx;
}

// Issues the cp.async copies of one work item's A and H rows into a stage.
template <bool kFolded>
__device__ __forceinline__ void stage_item(const Params& p, int item,
                                           unsigned char* stage) {
  using S = Shape<kFolded>;
  int z, ly, hx;
  item_coords<kFolded>(p, item, z, ly, hx);
  const Tile tile = tile_of(p, z);
  if (!tile.live) return;
  // Polarity masks of the B bytes a lane holds, per k-step ks and lane
  // column t: b0 holds lanes 32 ks + 4 t .. + 3, b1 lanes 32 ks + 16 + 4 t
  // .. + 3 (bits of word ks of the pivot table); [ks][t][b0, b1].
  if (!kFolded && threadIdx.x < 64) {
    const int i = threadIdx.x;
    const uint32_t w = __ldg(p.tables + (size_t)tile.m * 8 + (i >> 3));
    reinterpret_cast<uint32_t*>(stage + kMasks)[i] =
        bytes01(w >> (4 * ((i >> 1) & 3) + 16 * (i & 1)));
  }
  const uint32_t base = smem_addr(stage);
  constexpr int kChunks = (kARows + kHRows) * (kRow / 16);
  for (int idx = threadIdx.x; idx < kChunks; idx += kThreads) {
    const int r = idx >> 4, c = idx & 15;
    const int8_t* src;
    bool valid;
    if (r < kARows) {
      // A row r = ((req * kS + s) * 4 + j) * kBL + l
      const int l = r % S::kBL;
      const int q = r / S::kBL;
      const int j = q & 3, s = (q >> 2) % S::kS, req = (q >> 2) / S::kS;
      const int lt = ly * S::kBL + l;
      valid = lt < p.tl;
      src = (req ? p.a[1] : p.a[0]) + (long long)(s * 4 + j) * p.a_plane +
            (long long)(tile.lo0 + (valid ? lt : 0)) * kRow + c * 16;
    } else {
      // H row r - kARows = ((c2 >> 1) * kBH + h) * 2 + (c2 & 1)
      const int hr = r - kARows;
      const int c2 = ((hr >> 1) / kBH) * 2 + (hr & 1);
      const int ht = hx * kBH + (hr >> 1) % kBH;
      valid = ht < p.th;
      src = p.h + (long long)c2 * p.h_plane +
            (long long)(tile.hi0 + (valid ? ht : 0)) * kRow + c * 16;
    }
    cp_async16(base + chunk_off(r, c), src, valid);
  }
}

// One work item from a staged buffer: every warp takes units of 16 low x 4
// high rows, both req, and writes their words (and, in a window, flags and
// its feasible count).
template <bool kFolded>
__device__ __forceinline__ void compute_item(const Params& p, int item,
                                             const unsigned char* stage) {
  using S = Shape<kFolded>;
  int z, ly, hx;
  item_coords<kFolded>(p, item, z, ly, hx);
  const Tile tile = tile_of(p, z);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t tile_off = (size_t)z * p.tl * p.th;
  constexpr int kUnits = (S::kBL / 16) * (kBH / 4);

  if (!tile.live) {  // block-uniform: tiles at or past t_end
    for (int u = warp; u < kUnits; u += kWarps) {
      const int h = hx * kBH + (u % (kBH / 4)) * 4 + t;
      const int l0 = ly * S::kBL + (u / (kBH / 4)) * 16 + g;
      for (int half = 0; half < 2; ++half) {
        const int l = l0 + 8 * half;
        if (l < p.tl && h < p.th) {
          const size_t o = tile_off + (size_t)l * p.th + h;
          p.req1[o] = 0xffffffffu;
          p.req0[o] = 0xffffffffu;
          p.feas[o] = 0;
        }
      }
    }
    return;
  }

  const uint32_t base = smem_addr(stage);
  const uint2* masks = reinterpret_cast<const uint2*>(stage + kMasks);
  int count = 0;
  for (int u = warp; u < kUnits; u += kWarps) {
    const int lg = u / (kBH / 4), hg = u % (kBH / 4);
    uint32_t words[2][2];  // [req][l = g, g + 8]
    for (int rq = 0; rq < 2; ++rq) {
      int acc[2][4][2][4];  // [s][j][c2 >> 1][c0..c3]
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int ch = 0; ch < 2; ++ch)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[s][j][ch][i] = 0;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        // B: matrices (c2 >> 1 = 0, chunk 2 ks), (0, 2 ks + 1), (1, 2 ks),
        // (1, 2 ks + 1); lane's row is column n = lane & 7 of the fragment.
        uint32_t hb[4];
        {
          const int mi = lane >> 3;
          const int r = kARows + ((mi >> 1) * kBH + hg * 4) * 2 + (lane & 7);
          ldsm_x4(hb, base + chunk_off(r, 2 * ks + (mi & 1)));
        }
        uint32_t bf[2][2][2];  // [s][c2 >> 1][b0, b1]
        if (kFolded) {
#pragma unroll
          for (int ch = 0; ch < 2; ++ch)
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              bf[s][ch][0] = hb[2 * ch];
              bf[s][ch][1] = hb[2 * ch + 1];
            }
        } else {
          const uint2 pm = masks[ks * 4 + t];
#pragma unroll
          for (int ch = 0; ch < 2; ++ch) {
            bf[1][ch][0] = hb[2 * ch] & pm.x;
            bf[1][ch][1] = hb[2 * ch + 1] & pm.y;
            bf[0][ch][0] = hb[2 * ch] & (pm.x ^ 0x01010101u);
            bf[0][ch][1] = hb[2 * ch + 1] & (pm.y ^ 0x01010101u);
          }
        }
#pragma unroll
        for (int sa = 0; sa < S::kS; ++sa) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // A: rows 0-7 / 8-15 of the unit, chunks 2 ks / 2 ks + 1.
            uint32_t af[4];
            const int r = ((rq * S::kS + sa) * 4 + j) * S::kBL + lg * 16 +
                          (lane & 15);
            ldsm_x4(af, base + chunk_off(r, 2 * ks + (lane >> 4)));
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              if (kFolded && s != sa) continue;
#pragma unroll
              for (int ch = 0; ch < 2; ++ch)
                mma_s8(acc[s][j][ch], af, bf[s][ch][0], bf[s][ch][1]);
            }
          }
        }
      }
      // c0/c1: row g, columns 2 t, 2 t + 1 (h = t, c2 & 1 = 0, 1); c2/c3:
      // row g + 8, the same columns.  A count c in [0, 256] is > 0 exactly
      // when bit 31 of c + 0x7fffffff is set; the funnel shift moves that bit
      // in, cell bit 31 first.
      uint32_t wa = 0u, wb = 0u;
#pragma unroll
      for (int bit = 31; bit >= 0; --bit) {
        const int j = bit >> 3, s = (bit >> 2) & 1, ch = (bit >> 1) & 1,
                  lo = bit & 1;
        wa = __funnelshift_l((uint32_t)acc[s][j][ch][lo] + 0x7fffffffu, wa, 1);
        wb = __funnelshift_l((uint32_t)acc[s][j][ch][2 + lo] + 0x7fffffffu,
                             wb, 1);
      }
      words[rq][0] = wa;
      words[rq][1] = wb;
    }
    const int h = hx * kBH + hg * 4 + t;
    const bool h_in = h < p.th;
    bool h_ok = h_in;
    if (p.descs != nullptr && h_in) {
      h_ok = tile.hi0 + h < tile.hi_end && p.highvalid[tile.hi0 + h] != 0;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int l = ly * S::kBL + lg * 16 + g + 8 * half;
      const bool in = l < p.tl && h_in;
      const uint32_t r1 = words[0][half], r0 = words[1][half];
      const size_t o = tile_off + (size_t)l * p.th + h;
      if (in) {
        p.req1[o] = r1;
        p.req0[o] = r0;
      }
      if (p.descs != nullptr) {  // uniform
        const bool f = in && h_ok && tile.lo0 + l < tile.lo_end &&
                       p.lowvalid[tile.lo0 + l] != 0 && (r1 & r0) == 0u;
        count += __popc(__ballot_sync(0xffffffffu, f));
        if (in) p.feas[o] = f ? 1 : 0;
      }
    }
  }
  if (p.descs != nullptr && lane == 0 && count) atomicAdd(&p.counts[z], count);
}

template <bool kFolded>
__global__ void __launch_bounds__(kThreads, 1) pivot_pre_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nly = (p.tl + Shape<kFolded>::kBL - 1) / Shape<kFolded>::kBL;
  const int nhx = (p.th + kBH - 1) / kBH;
  const int n_items = p.n * nly * nhx;
  int item = blockIdx.x;
  int stage = 0;
  if (item < n_items) stage_item<kFolded>(p, item, smem);
  cp_async_commit();
  for (; item < n_items; item += gridDim.x) {
    const int next = item + gridDim.x;
    if (next < n_items)
      stage_item<kFolded>(p, next, smem + (stage ^ 1) * kStage);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    compute_item<kFolded>(p, item, smem + stage * kStage);
    __syncthreads();  // the next iteration refills this stage
    stage ^= 1;
  }
}

template <bool kFolded>
int launch(const Params& p, cudaStream_t stream, void* ev0 = nullptr,
           void* ev1 = nullptr) {
  const int nly = (p.tl + Shape<kFolded>::kBL - 1) / Shape<kFolded>::kBL;
  const int nhx = (p.th + kBH - 1) / kBH;
  const long long n_items = (long long)p.n * nly * nhx;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Per launch: the attribute belongs to the current device.
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pivot_pre_kernel<kFolded>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * kStage);
  if (e == cudaSuccess) e = sbgt_record(ev0, stream);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(n_items < sms ? n_items : sms);
  pivot_pre_kernel<kFolded><<<grid, kThreads, 2 * kStage, stream>>>(p);
  return sbgt_launched(ev1, stream);
}

}  // namespace

// One tile of the TPU kernel's contract: lhs1/lhs0 int8 [2 s][4 j][tl][256]
// (polarity folded in), rhsb int8 [4][th][256] -> req1/req0 uint32[tl, th].
extern "C" int sbgt_pivot_pre(const void* lhs1, const void* lhs0,
                              const void* rhsb, int tl, int th, void* req1,
                              void* req0, void* stream) {
  if (tl <= 0 || th <= 0) return 0;
  Params p{};
  p.a[0] = (const int8_t*)lhs1;
  p.a[1] = (const int8_t*)lhs0;
  p.a_plane = (long long)tl * kRow;
  p.h = (const int8_t*)rhsb;
  p.h_plane = (long long)th * kRow;
  p.n = 1;
  p.t_end = 1;
  p.tl = tl;
  p.th = th;
  p.req1 = (uint32_t*)req1;
  p.req0 = (uint32_t*)req0;
  return launch<true>(p, (cudaStream_t)stream);
}

// The window of the pivot sweep, K1's sbgt_pivot_window contract on int8
// lanes: l1/l0/hc int8 [4][rows][256] (rows apart by `rows` * 256 bytes per
// cell plane), tables uint32[*, 8] (the pivot polarity), tiles [t0, t0 + n)
// of descs (only rows below t_end read) -> req1/req0 uint32[n, tl, th],
// feas uint8[n, tl, th], counts int32[n] (zeroed here, on the stream).
// ev0/ev1: the launch's timing events or null (launch_timing.cuh).
extern "C" int sbgt_pivot_pre_window(const void* tables, const void* l1,
                                     const void* l0, const void* hc, int rows,
                                     const void* lowvalid,
                                     const void* highvalid, const void* descs,
                                     int t0, int n, int t_end, int tl, int th,
                                     void* req1, void* req0, void* feas,
                                     void* counts, void* stream, void* ev0,
                                     void* ev1) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || tl <= 0 || th <= 0) return sbgt_no_launch(ev0, ev1, s);
  const cudaError_t e =
      cudaMemsetAsync(counts, 0, (size_t)n * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  Params p{};
  p.a[0] = (const int8_t*)l1;
  p.a[1] = (const int8_t*)l0;
  p.a_plane = (long long)rows * kRow;
  p.h = (const int8_t*)hc;
  p.h_plane = (long long)rows * kRow;
  p.tables = (const uint32_t*)tables;
  p.lowvalid = (const uint8_t*)lowvalid;
  p.highvalid = (const uint8_t*)highvalid;
  p.descs = (const int32_t*)descs;
  p.t0 = t0;
  p.n = n;
  p.t_end = t_end;
  p.tl = tl;
  p.th = th;
  p.req1 = (uint32_t*)req1;
  p.req0 = (uint32_t*)req0;
  p.feas = (uint8_t*)feas;
  p.counts = (int32_t*)counts;
  return launch<false>(p, s, ev0, ev1);
}
