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
// search jobs in one launch; it has a body of its own, on the 1-bit tensor
// cores (its note is above pivot_window_lanes_kernel below).

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

// ---------------------------------------------------------------------------
// K1's lane form on the 1-bit tensor cores.
//
// Replaces K1's TPU kernel (sboxgates_tpu/ops/pallas_pivot.py:133) under a
// job axis: the window of every lane (search job) of a fleet in one launch,
// lane l with its own tables, cell words, validity and descriptors (lane
// strides tab_lane, l_lane, h_lane, valid_lane, desc_lane) and its own
// window [t0[l], t0[l] + n) cut at t_end[l]; its outputs are the window
// kernel's, word for word.
//
// Bound on the H100.  The AND-OR chain of window_block spends 576 + 4
// integer operations per candidate, and the lane form on it ran at 81% of
// that wall (PERF.md §6).  Here each verdict bit is one 1-bit tensor-core
// test: popc(L[j][l] & PM_s & H[c2][h]) over the 256 positions of a table
// is what mma.sync.m16n8k256.b1.and.popc computes for 16 x 8 (row, column)
// pairs, 128 tests per instruction, from the packed words as they are (K =
// 256 bits = one row's 8 words; nothing is expanded).  The tensor cores
// take these at 8x their int8 rate (the probe, csrc/tc_probe.cu), so the
// bound is the 9 bytes a candidate writes; what holds the kernel is the
// integer pipe's one operation per test that turns a count into its bit
// (64 per candidate against 580), which on this card does not overlap the
// products (PERF.md §6).  (K2 expanded bits to int8 lanes and lost
// to K1: its fragment loads and masks per item, not the tensor pipe, held
// it.)
//
// Design.
//   - A fragment (M = 16 high rows of one cell c2 per warp): thread (g, t)
//     holds words t and t + 4 of rows g and g + 8, loaded once per block by
//     ldmatrix.x4 and kept in registers for all c2 (16 registers).
//   - B fragment (N = 8 columns, n = 2 l' + s: four low rows of one (req,
//     j), each at both pivot polarities): lane (g, t) holds words t and t + 4
//     of column g.  The block stages every low row twice, ANDed with ~pm
//     (s = 0) and pm (s = 1) of its tile's pivot table tables[m], so one
//     ldmatrix.x4 loads two j of a req and nothing is masked per product.
//   - Accumulators: D = count - 1 (C = -1), so a lane's c0..c3 are the
//     cells (h = g, s = 0 / 1) and (h = g + 8, s = 0 / 1) of its two
//     candidates, both at low row l' = t.  D is all-ones or below 256, so
//     each of its bytes 1-3 is 0xff or 0 ("count == 0"): one AND with the
//     cell's bit places it (bit 8 j + 4 s + c2; cells of j = 0 go to byte 1
//     of a second word, moved down once), and the words are inverted once.
//     No shuffle, no ballot, no order among the products.  Both req run from
//     the same A fragments, so each lane ends with req1 and req0 of its
//     candidates and the fused epilogue (validity, (req1 & req0) == 0,
//     feasible flag, the tile's count by ballot and one atomicAdd per block)
//     runs on its own words.
//   - Block: 8 warps own 128 high rows x 32 low rows of one tile slot (z =
//     lane * n + tile on the grid's third axis).  The rows (32 KB, 32 B
//     each; the two 16-byte halves of a row swapped on every other group of
//     four rows, so that ldmatrix reads no bank twice) arrive by cp.async
//     (high) and 16-byte loads (low), rows past the tile's edge zero.
//     Stores: a warp writes 4 low rows x 32 contiguous bytes per
//     instruction.  128 registers, 2 blocks per SM: more blocks (fewer
//     registers), 4 warps a block, 64 low rows a block or split chains
//     were not faster on the card.
//   - A slot at or past its lane's t_end (done lanes, cut windows) reads no
//     descriptor and writes all-ones words and no feasible candidate.
constexpr int kLThreads = 256;             // 8 warps
constexpr int kLWarps = kLThreads / 32;
constexpr int kLH = 16 * kLWarps;          // high rows per block
constexpr int kLL = 32;                    // low rows per block
constexpr int kLHRows = 4 * kLH;           // staged high rows [c2][h]
constexpr int kLRows = kLHRows + 16 * kLL; // then low rows [req][j][l][s]

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte half c of staged row r (32 B rows, halves swapped
// on odd groups of four rows: an 8 x 16 B ldmatrix phase hits 32 banks).
__device__ __forceinline__ uint32_t lrow_off(int r, int c) {
  return (uint32_t)(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d = popc(A & B) - 1 over K = 256 bits, for the 16 x 8 block.
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(-1));
}

__global__ void __launch_bounds__(kLThreads, 2)
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
  __shared__ __align__(128) unsigned char rows[kLRows * 32];
  __shared__ int lvalid[kLL];
  __shared__ int warp_count[kLWarps];
  const int z = blockIdx.z;
  const int job = z / n;
  const int t = t0[job] + z % n;
  const size_t tile_off = (size_t)z * tl * th;
  req1 += tile_off;
  req0 += tile_off;
  feas += tile_off;
  const int lo_base = blockIdx.y * kLL, hi_base = blockIdx.x * kLH;
  if (t >= t_end[job]) {  // block-uniform: an inert slot
    for (int i = threadIdx.x; i < kLL * kLH; i += kLThreads) {
      const int lo = lo_base + i / kLH, h = hi_base + i % kLH;
      if (lo < tl && h < th) {
        const size_t o = (size_t)lo * th + h;
        req1[o] = 0xffffffffu;
        req0[o] = 0xffffffffu;
        feas[o] = 0;
      }
    }
    return;
  }
  const int* d = descs + (size_t)job * desc_lane + (size_t)t * 5;
  const int m = d[0], lo0 = d[1], lo_end = d[2], hi0 = d[3], hi_end = d[4];
  lowvalid += (size_t)job * valid_lane;
  highvalid += (size_t)job * valid_lane;

  // Stage the block's rows: high [c2][h] by cp.async, then low
  // [req][j][l][s] with the pivot polarity applied (s = 0: ~pm, 1: pm),
  // 2 halves each.
  const uint32_t base = smem_u32(rows);
  const uint32_t* pmw = tables + (size_t)job * tab_lane + (size_t)m * kWords;
  {
    const uint32_t* hsrc = hcs + (size_t)job * h_lane;
    for (int i = threadIdx.x; i < kLHRows * 2; i += kLThreads) {
      const int r = i >> 1, c = i & 1;
      const int h = hi_base + r % kLH;
      const bool valid = h < th;
      const uint32_t* src = hsrc + (size_t)(r / kLH) * hstride +
                            (size_t)(hi0 + (valid ? h : 0)) * kWords + 4 * c;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       base + lrow_off(r, c)),
                   "l"(src), "r"(valid ? 16 : 0));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const uint32_t* l1src = l1 + (size_t)job * l_lane;
    const uint32_t* l0src = l0 + (size_t)job * l_lane;
    for (int i = threadIdx.x; i < 8 * kLL * 2; i += kLThreads) {
      const int c = i & 1, pl = (i >> 1) / kLL;  // pl = req * 4 + j
      const int l = (i >> 1) % kLL, lo = lo_base + l;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (lo < tl)
        v = __ldg(reinterpret_cast<const uint4*>(
            ((pl >> 2) ? l0src : l1src) + (size_t)(pl & 3) * lstride +
            (size_t)(lo0 + lo) * kWords + 4 * c));
      const uint4 p = __ldg(reinterpret_cast<const uint4*>(pmw) + c);
      const int r = kLHRows + (pl * kLL + l) * 2;
      *reinterpret_cast<uint4*>(rows + lrow_off(r, c)) =
          make_uint4(v.x & ~p.x, v.y & ~p.y, v.z & ~p.z, v.w & ~p.w);
      *reinterpret_cast<uint4*>(rows + lrow_off(r + 1, c)) =
          make_uint4(v.x & p.x, v.y & p.y, v.z & p.z, v.w & p.w);
    }
  }
  if (threadIdx.x < kLL) {
    const int lo = lo_base + threadIdx.x;
    lvalid[threadIdx.x] =
        lo < tl && lo0 + lo < lo_end && lowvalid[lo0 + lo] != 0;
  }
  const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = ln >> 2, q = ln & 3;
  // This lane's candidates: high rows hr[0] = g and hr[1] = g + 8 of the
  // warp's 16, each at low row q of every group of four.
  int hr[2];
  bool hok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    hr[half] = hi_base + 16 * warp + g + 8 * half;
    hok[half] = hr[half] < th && hi0 + hr[half] < hi_end &&
                highvalid[hi0 + hr[half]] != 0;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  uint32_t af[4][4];  // [c2]: the warp's 16 high rows
#pragma unroll
  for (int c2 = 0; c2 < 4; ++c2)
    ldsm_x4(af[c2], base + lrow_off(c2 * kLH + 16 * warp + (ln & 15), ln >> 4));

  // B: matrices (j = 2 jp, half 0), (2 jp, 1), (2 jp + 1, 0), (2 jp + 1, 1)
  // of a req; lane ln gives row ln & 7 of matrix ln >> 3, column n = 2 l' +
  // s = staged row 8 qd + n of the plane.  [req][jp], quad 0 (a quad's rows
  // are 256 B further on: its halves are swapped as quad 0's).
  uint32_t baddr[2][2];
#pragma unroll
  for (int rq = 0; rq < 2; ++rq)
#pragma unroll
    for (int jp = 0; jp < 2; ++jp)
      baddr[rq][jp] =
          base + lrow_off(kLHRows + (rq * 4 + 2 * jp + (ln >> 4)) * 2 * kLL +
                              (ln & 7),
                          (ln >> 3) & 1);

  int count = 0;
  for (int qd = 0; qd < kLL / 4; ++qd) {
    const int lo = lo_base + 4 * qd + q;
    if (lo_base + 4 * qd >= tl) break;  // block-uniform
    uint32_t words[2][2];  // [req][half]
#pragma unroll
    for (int rq = 0; rq < 2; ++rq) {
      uint32_t bf[2][4];  // [jp]: b0, b1 of j = 2 jp, then of j = 2 jp + 1
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) ldsm_x4(bf[jp], baddr[rq][jp] + 256 * qd);
      // "count == 0" flags: D = count - 1 is all-ones or below 256, so its
      // bytes 1-3 are each 0xff or 0 and one AND places a cell's flag.
      // Cells of j = 1-3 go to their own byte of zf, those of j = 0 to byte
      // 1 of zf0, moved down once.  [half]
      uint32_t zf[2] = {0u, 0u}, zf0[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2) {
          int acc[4];
          mma_b1(acc, af[c2], bf[j >> 1][2 * (j & 1)],
                 bf[j >> 1][2 * (j & 1) + 1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // (half, s) = (i >> 1, i & 1)
            const uint32_t m = 1u << ((j ? j : 1) * 8 + (i & 1) * 4 + c2);
            if (j)
              zf[i >> 1] |= (uint32_t)acc[i] & m;
            else
              zf0[i >> 1] |= (uint32_t)acc[i] & m;
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
        words[rq][half] = ~(zf[half] | (zf0[half] >> 8));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool in = (lo < tl) & (hr[half] < th);
      const uint32_t r1 = words[0][half], r0 = words[1][half];
      const bool f = in & hok[half] & (lvalid[4 * qd + q] != 0) &
                     ((r1 & r0) == 0u);
      count += __popc(__ballot_sync(0xffffffffu, f));
      if (in) {
        const size_t o = (size_t)lo * th + hr[half];
        req1[o] = r1;
        req0[o] = r0;
        feas[o] = f ? 1 : 0;
      }
    }
  }
  if (ln == 0) warp_count[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kLWarps; ++i) sum += warp_count[i];
    if (sum) atomicAdd(counts + z, sum);
  }
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
  const dim3 grid((th + kLH - 1) / kLH, (tl + kLL - 1) / kLL, lanes * n);
  pivot_window_lanes_kernel<<<grid, kLThreads, 0, s>>>(
      (const uint32_t*)tables, tab_lane, (const uint32_t*)l1,
      (const uint32_t*)l0, lstride, l_lane, (const uint32_t*)hcs, hstride,
      h_lane, (const uint8_t*)lowvalid, (const uint8_t*)highvalid, valid_lane,
      (const int32_t*)descs, desc_lane, (const int32_t*)t0,
      (const int32_t*)t_end, n, tl, th, (uint32_t*)req1, (uint32_t*)req0,
      (uint8_t*)feas, (int32_t*)counts);
  return sbgt_launched(ev1, s);
}
