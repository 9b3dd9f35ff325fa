// Helpers shared by the port's kernels (predict.cu, svgp_proj.cu): the
// template bounds, cp.async copies into shared memory, the staging of
// per-cell m x m factors, and the wide body's pieces (large m, or d > 4).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace psvgp {

constexpr int kMaxD = 4;  // the narrow bodies' input dims d in [1, 4]; the wide body takes any d

// row stride of an m x m factor in shared memory: a multiple of 4 floats,
// so a row's values load as float4
template <int MMAX>
__host__ __device__ constexpr int row_stride() {
  return (MMAX + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async4(float* dst_shared, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst_shared, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// Stage rows r < m of nc cells' m x m matrices (src, contiguous) into
// shared memory as MMAX x LD blocks, zeros in columns m .. LD-1; rows past
// m are not read. 16-byte copies where m is a multiple of 4 and src is
// 16-byte aligned (then every row is), else 4-byte copies. The divisors
// are compile-time constants.
template <int MMAX, int LD>
__device__ __forceinline__ void stage_matrices(float* s, const float* src, int nc, int m) {
  constexpr int Q4 = LD / 4;
  if ((m & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < nc * MMAX * Q4; i += blockDim.x) {
      const int cs = i / (MMAX * Q4), r = i % (MMAX * Q4) / Q4, c4 = i % Q4;
      if (r >= m) continue;
      float* dst = s + (cs * MMAX + r) * LD + 4 * c4;
      if (4 * c4 < m) {
        cp_async16(dst, src + ((size_t)cs * m + r) * m + 4 * c4);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < nc * MMAX * LD; i += blockDim.x) {
      const int cs = i / (MMAX * LD), r = i % (MMAX * LD) / LD, col = i % LD;
      if (r >= m) continue;
      float* dst = s + (cs * MMAX + r) * LD + col;
      if (col < m) {
        cp_async4(dst, src + ((size_t)cs * m + r) * m + col);
      } else {
        *dst = 0.f;
      }
    }
  }
}

// Call f with the template bound MMAX for m <= kTop: m itself up to 8 (no
// padded columns at the paper's m = 5), then 16, 32, 64 as far as kTop.
template <int kTop, class F>
cudaError_t with_mmax(int m, F&& f) {
  switch (m) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: break;
  }
  if (kTop <= 16 || m <= 16) return f(std::integral_constant<int, 16>{});
  if (kTop <= 32 || m <= 32) return f(std::integral_constant<int, (kTop < 32 ? 16 : 32)>{});
  return f(std::integral_constant<int, (kTop < 64 ? 16 : 64)>{});
}


// ---------------------------------------------------------------------------
// The wide body: m from k*WideMinM (below) to kWideMaxM, or any m with
// d > kMaxD; m and d are runtime values. It is a GEMM of knm (rows x m,
// computed on the fly) by W^T (and U^T) in full float32 FFMA with expf.
//
// What bounds it: at m >= 128 the operations (m^2 FFMA a row and factor,
// W's triangle alone in the projection) at 67 TFLOP/s FP32: Hopper's
// tensor cores have no fp32 mode and TF32 is ruled out. Measured on the
// H100 (PERF.md; scripts/wide_ablate.py switches knm and the copies off):
// at m = 1,024 the FFMA loop alone reaches 62% of that rate in the
// prediction and 31% in the projection. The projection's loop feeds half
// the FFMA from each value it loads (8 rows x 4 columns of one factor:
// 10.7 FFMA a 16-byte shared load, against the prediction's 16) and runs
// half as many between two barriers; its 8 x 8 and 16 x 4 tiles, which
// would give it the prediction's ratio, spill at 128 registers and were
// slower at most shapes. knm's expf, which each column tile computes
// anew, and the factors' cp.async add 9-14% each: the prediction reaches
// 49% at m = 1,024, the projection 22%. At few rows the latency of a
// thread's chain bounds it.
//
// Design:
// - Column tiles of kWideBN = 128 outputs i, chunks of kWideBK = 16 depths
//   j. A block takes BM = MR TR rows of one cell and one or more column
//   tiles; for each tile it runs the tile's chunks in j order. knm is never
//   held whole: each step computes knm's BM x 16 chunk (j-major, one chunk
//   ahead, double-buffered) while W's (and U's) 128 x 16 chunk streams in
//   by cp.async as the matrix lays it out, 2 steps ahead in 3 slots, one
//   barrier a step. A block needs 31-97 KB of shared memory at every m up
//   to 2,048, so two blocks of 8 warps fit an SM.
// - Each thread holds MR rows x 4 columns a factor in registers (MR = 8: 64
//   FFMA a j in the prediction, 32 in the projection). Each 4 j it loads a
//   float4 of 4 consecutive j for each of its columns (8 consecutive rows
//   across a quarter warp, row stride 20 floats: distinct bank groups), and
//   each j a float4 of its knm rows (4 addresses a warp): 16 loads for 256
//   FFMA in the prediction. A warp owns 32 columns of the tile.
// - Blocks: the row tile and the rows a thread follow the shape (BM from 8
//   to 64). The prediction's block walks all its column tiles. The
//   projection's may be split over a thread-block cluster (cs blocks), so
//   that a few hundred rows still cover the card: it pairs tile t with
//   tile nt - 1 - t (tile t holds t + 1 shares of W's triangle); at m =
//   1,024 the pairs beat one block walking every tile, 299 to 356 us.
// - Every output's sum over j runs in j order; a row's squares fold in a
//   fixed order (the thread's columns in order, a butterfly over the 8 lanes
//   of its group, the 4 groups as (g0 + g1) + (g2 + g3), then the tiles in
//   order, each tile's partial in the shared memory of the block that
//   computed it, in a cluster read through distributed shared memory): no
//   atomics, and a
//   row's bits depend only on its x, its cell's factors, m and d, never on
//   the row tile, the rows a thread, the split or the launch.
// - W is lower triangular in the projection: a tile's chunks stop at its
//   last column, and a warp skips a chunk wholly above the diagonal of its
//   32 columns (those terms are zeros, so no bit changes).
// ---------------------------------------------------------------------------

// The least m each source's wide body takes; below it, the narrow bodies.
// Measured on the H100 (PERF.md; scripts/kernel_ab.py --set thresholds
// against a copy with both set to 9, d = 2): the prediction's wide body
// loses to the narrow instances at (400, 9, 32) at every m from 9 to 64
// (59 us against 20 at m = 20); the projection's wins at (400, 32) for m =
// 9, 12 and 16 (5.2, 4.9, 4.9 us against 5.7, 5.9, 7.6) but loses at
// (1, 65,536), where the narrow body's slab stores win (18.5 against 8.5 us
// at m = 12). The instance may follow m and d only, so both stay.
constexpr int kPredictWideMinM = 65;
constexpr int kProjectionWideMinM = 17;

constexpr int kWideMaxM = 2048;
constexpr int kWideBN = 128;           // columns i of a column tile
constexpr int kWideBK = 16;            // depth j of a chunk
constexpr int kWideLDS = kWideBK + 4;  // row stride of a staged factor chunk (20: no bank conflict)
constexpr int kWideTC = 32;            // column threads of a block: 4 warps of 8 across a tile
constexpr int kWideMC = kWideBN / kWideTC;  // columns a thread, a factor: 4
constexpr int kWideGroups = 4;         // column groups of a tile (32 columns, one warp each)
constexpr int kWideFewWarps = 8;       // warps an SM below which a launch takes 2 rows a thread
constexpr int kWideInv = 64;           // 1/l staged for the first 64 dims; past them, recomputed
constexpr int kWideMaxSmem = 232448;   // bytes of shared memory a block may opt in to (H100)

// A block of the wide body: TR row threads (4 or 8) x 32 column threads,
// MR rows a thread (8; in the projection 2 where the rows are few), BM =
// MR TR rows. Warp w takes row threads 4 (w / 4) .. + 3 and column group
// w % 4, its lanes 8 column threads x 4 row threads: a fragment load
// touches 8 (factors) or 4 (knm) addresses.
template <int NMAT, int MR>
struct WideLayout {
  static constexpr int TRMAX = 8, TRMIN = 4;
  static constexpr int TPR = kWideTC / MR;                 // threads computing a row's knm
  static constexpr int E = kWideBK / TPR;                  // knm values a thread a chunk
  static constexpr int SLOTS = 3;                          // staged factor chunks
  static constexpr int STAGE = NMAT * kWideBN * kWideLDS;  // floats of a staged factor chunk
};

// column thread tx = 8 g + l (group g, lane l): columns 32 g + l + 8 cc, cc < 4
__device__ __forceinline__ int wide_tx(int tid) {
  return (tid >> 5) % kWideGroups * 8 + (tid & 7);
}
__device__ __forceinline__ int wide_col(int tx) { return 32 * (tx >> 3) + (tx & 7); }
__device__ __forceinline__ int wide_ty(int tid) {  // row thread: rows MR ty .. MR ty + MR - 1
  return (tid >> 5) / kWideGroups * 4 + ((tid & 31) >> 3);
}

__host__ __device__ constexpr int wide_tiles(int m) { return (m + kWideBN - 1) / kWideBN; }

// chunks of column tile t (the projection's end at the tile's last column)
template <int NMAT>
__host__ __device__ constexpr int wide_chunks(int t, int m) {
  return ((NMAT == 1 && kWideBN * (t + 1) < m ? kWideBN * (t + 1) : m) + kWideBK - 1) / kWideBK;
}

// floats of dynamic shared memory of a block of BM rows: the staged factor
// chunks, two knm chunks, the column groups' and the tiles' row partials,
// 1/l, z/l (KD > 0)
template <int NMAT, int MR>
__host__ __device__ constexpr int wide_run_floats(int m, int kd, int bm) {
  using L = WideLayout<NMAT, MR>;
  return L::SLOTS * L::STAGE + 2 * kWideBK * bm + NMAT * (kWideGroups + wide_tiles(m)) * bm +
         kWideInv + m * kd;
}

// The column tiles of a block, in the order it runs them: all nt where cs =
// 1; else (the projection only) for rank r of a cluster of cs =
// ceil(nt / 2), the pair {r, nt - 1 - r} (tile t holds t + 1 of the nt
// shares of W's triangle, so a pair holds nt + 1).
struct WideTiles {
  int nt, cs, rank;
  __device__ int count() const { return cs == 1 ? nt : rank == nt - 1 - rank ? 1 : 2; }
  __device__ int tile(int k) const { return cs == 1 ? k : k == 0 ? rank : nt - 1 - rank; }
  __device__ int owner(int t) const { return cs == 1 ? 0 : min(t, nt - 1 - t); }  // runs tile t
};

// A step of a block: chunk c of its k-th tile.
struct WideStep {
  int k, c;
};

template <int NMAT>
__device__ __forceinline__ WideStep wide_next(WideStep s, const WideTiles& tl, int m) {
  if (++s.c == wide_chunks<NMAT>(tl.tile(s.k), m)) {
    s.c = 0;
    ++s.k;
  }
  return s;
}

// The column groups [lo, hi) of tile t that chunk c feeds (32 columns
// each): those with a column below m and, in the projection, not wholly
// above the diagonal (W_ij = 0 for j > i).
template <int NMAT>
__device__ __forceinline__ int2 wide_groups(int t, int c, int m) {
  const int i0 = kWideBN * t, jr = kWideBK * c - i0;
  const int hi = min(kWideGroups, (m - i0 + 31) / 32);
  const int lo = NMAT == 1 && jr > 31 ? jr / 32 : 0;
  return make_int2(lo, hi);
}

__device__ __forceinline__ void cp_async16_zfill(float* dst_shared, const float* src, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(float* dst_shared, const float* src, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of rows [i0 + r_lo, i0 + r_hi) x columns [j0, j0 + 16) of
// NMAT m x m matrices (a, then b) into a stage s (NMAT x 128 x LDS, as in
// the matrix), zeros outside the matrix; the stage's other rows are left as
// they are (no product reads them). A thread keeps one column offset and
// steps over rows. 16-byte copies, 4 to a row, where `vec` (m a multiple of
// 4, the matrices 16-byte aligned), else 4-byte ones.
template <int NMAT>
__device__ __forceinline__ void wide_load_chunk(float* s, const float* a, const float* b, int m,
                                                int i0, int j0, int r_lo, int r_hi, bool vec) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int per_row = vec ? kWideBK / 4 : kWideBK, width = vec ? 4 : 1;
  const int col = width * (tid % per_row), j = j0 + col;
  const int step = T / per_row;
  for (int row = r_lo + tid / per_row; row < r_hi; row += step) {
    const int i = i0 + row;
    const bool ok = i < m && j < m;
    const size_t off = ok ? (size_t)i * m + j : 0;
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
      const float* base = mat == 0 ? a : b;
      float* dst = s + (mat * kWideBN + row) * kWideLDS + col;
      if (vec) {
        cp_async16_zfill(dst, base + off, ok);
      } else {
        cp_async4_zfill(dst, base + off, ok);
      }
    }
  }
}

// Stage 1/l of the first kWideInv dims and, where KD = d > 0, z/l of all m
// inducing points (each thread reads them after a barrier); the same bits
// as where they are recomputed.
template <int KD>
__device__ __forceinline__ void wide_stage(float* s_inv, float* s_zs, const float* zc,
                                           const float* lp, int m, int d) {
  for (int k = threadIdx.x; k < d && k < kWideInv; k += blockDim.x) s_inv[k] = expf(-lp[k]);
  if constexpr (KD > 0) {
    float il[KD];
#pragma unroll
    for (int k = 0; k < KD; ++k) il[k] = expf(-lp[k]);
    for (int e = threadIdx.x; e < m * KD; e += blockDim.x) s_zs[e] = __fmul_rn(zc[e], il[e % KD]);
  }
}

// This thread's share of knm's chunk at columns [j0, j0 + 16): row kr,
// columns j0 + c0 .. j0 + c0 + E - 1, into the chunk buffer s (16 x lda:
// s[j - j0][r]) and v; zeros past m and for a row with no x (xrow null).
// Per element the sequence of the narrow bodies and of K(X, Z): x/l and z/l
// by __fmul_rn, the explicit difference, r2 by fmaf in k order, sigma^2
// exp(-r2/2).
template <int KD, int E>
__device__ __forceinline__ void wide_knm_chunk(float* s, int lda, int kr, int c0, int j0,
                                               const float (&xs)[KD > 0 ? KD : 1],
                                               const float* xrow, const float* s_zs,
                                               const float* zc, const float* lp,
                                               const float* s_inv, float var, int m, int d,
                                               float (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = j0 + c0 + e;
    const bool ok = xrow != nullptr && j < m;
    float kj = 0.f;
    if constexpr (KD > 0) {  // branch-free: every lane runs the element, a select keeps it
      const int jc = j < m ? j : 0;
      float r2 = 0.f;
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const float df = __fsub_rn(xs[k], s_zs[jc * KD + k]);
        r2 = fmaf(df, df, r2);
      }
      const float kv = __fmul_rn(var, expf(__fmul_rn(-0.5f, r2)));
      kj = ok ? kv : 0.f;
    } else if (ok) {
      float r2 = 0.f;
      for (int k = 0; k < d; ++k) {
        const float il = k < kWideInv ? s_inv[k] : expf(-lp[k]);
        const float df = __fsub_rn(__fmul_rn(xrow[k], il), __fmul_rn(zc[(size_t)j * d + k], il));
        r2 = fmaf(df, df, r2);
      }
      kj = __fmul_rn(var, expf(__fmul_rn(-0.5f, r2)));
    }
    s[(c0 + e) * lda + kr] = kj;
    v[e] = kj;
  }
}

// One chunk's products in j order: acc[mat][rr][cc] += T_mat[i][j]
// knm[r][j] for the thread's rows r = MR ty + rr (a: the knm chunk, j-major,
// at row MR ty, row stride lda) and columns i = c0 + 8 cc of each factor
// (b: the staged chunk, i-major, at row c0). Each 4 j load a float4 of
// each of the thread's 4 columns a factor (8 consecutive rows across a
// quarter warp: distinct bank groups) and, for each j, the MR rows' knm
// (those of j + 1 load meanwhile): 8 + 8 loads for 256 FFMA at MR = 8 in
// the prediction.
template <int NMAT, int MR>
__device__ __forceinline__ void wide_fma_chunk(float (&acc)[NMAT][MR][kWideMC], const float* a,
                                               int lda, const float* b) {
  auto load_a = [&](int k, float (&fa)[MR]) {
    if constexpr (MR % 4 == 0) {
#pragma unroll
      for (int q = 0; q < MR / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(a + k * lda + 4 * q);
        fa[4 * q] = v.x;
        fa[4 * q + 1] = v.y;
        fa[4 * q + 2] = v.z;
        fa[4 * q + 3] = v.w;
      }
    } else {
      static_assert(MR == 2, "rows a thread: 2 or a multiple of 4");
      const float2 v = *reinterpret_cast<const float2*>(a + k * lda);
      fa[0] = v.x;
      fa[1] = v.y;
    }
  };
#pragma unroll
  for (int kk = 0; kk < kWideBK; kk += 4) {
    float4 wv[NMAT][kWideMC];
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
      for (int cc = 0; cc < kWideMC; ++cc)
        wv[mat][cc] =
            *reinterpret_cast<const float4*>(b + (mat * kWideBN + 8 * cc) * kWideLDS + kk);
    float fa[2][MR];
    load_a(kk, fa[0]);
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      if (k4 < 3) load_a(kk + k4 + 1, fa[(k4 + 1) & 1]);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
#pragma unroll
        for (int cc = 0; cc < kWideMC; ++cc) {
          const float4 v = wv[mat][cc];
          const float w = k4 == 0 ? v.x : k4 == 1 ? v.y : k4 == 2 ? v.z : v.w;
#pragma unroll
          for (int rr = 0; rr < MR; ++rr)
            acc[mat][rr][cc] = fmaf(w, fa[k4 & 1][rr], acc[mat][rr][cc]);
        }
      }
    }
  }
}

// The sum over the W lanes of a group (lanes xor 1 .. W/2), a butterfly:
// every lane of the group gets the same bits.
template <int W>
__device__ __forceinline__ float wide_lane_sum(float v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The loop a wide block runs (both bodies): its column tiles' chunks in
// order, one barrier a chunk. At step s (chunk s of the block) it stages
// chunk s + SLOTS - 1 of the factors by cp.async (where chunk s - 1 was)
// and computes knm's chunk s + 1 into the other knm buffer, then runs chunk
// s's products (a warp whose column group the chunk does not feed skips
// them); so the factors land SLOTS - 2 steps ahead and nothing waits on
// its own writes. After a tile's last chunk
// each row's squares fold in a fixed order: each thread's 4 columns in
// order, a butterfly over the group's 8 lanes, then (g0 + g1) + (g2 + g3)
// over the 4 groups, into s_part[t][mat][r] (returned: nt x NMAT x BM).
// Hooks: on_knm(step, kr, j, v) with this thread's knm values of a row
// with x (row kr, columns j ..); on_step(step, knm chunk) once the step's
// knm chunk is visible; on_tile(t, acc) after tile t's last chunk.
template <int NMAT, int KD, int MR, class OnKnm, class OnStep, class OnTile>
__device__ __forceinline__ float* wide_run(float* smem, const WideTiles& tl, int n,
                                           const float* xblk, const float* zc, const float* lp,
                                           float var, const float* a, const float* b, int m,
                                           int d, OnKnm&& on_knm, OnStep&& on_step,
                                           OnTile&& on_tile) {
  using L = WideLayout<NMAT, MR>;
  const int BM = MR * (blockDim.x / kWideTC);
  float* s_stg = smem;                                     // SLOTS x NMAT x 128 x LDS
  float* s_knm = s_stg + L::SLOTS * L::STAGE;              // 2 x 16 x BM
  float* s_fold = s_knm + 2 * kWideBK * BM;                // NMAT x 4 x BM
  float* s_part = s_fold + NMAT * kWideGroups * BM;        // nt x NMAT x BM
  float* s_inv = s_part + NMAT * wide_tiles(m) * BM;       // kWideInv
  float* s_zs = s_inv + kWideInv;                          // m x KD
  const int tid = threadIdx.x, tx = wide_tx(tid), ty = wide_ty(tid);
  const int group = (tid >> 5) % kWideGroups, lane = tid & 31;
  const bool vec = (m & 3) == 0 && ((reinterpret_cast<uintptr_t>(a) |
                                     reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  auto issue_step = [&](WideStep s, int slot) {
    const int t = tl.tile(s.k);
    const int2 g = wide_groups<NMAT>(t, s.c, m);
    wide_load_chunk<NMAT>(s_stg + slot * L::STAGE, a, b, m, kWideBN * t, kWideBK * s.c, 32 * g.x,
                          32 * g.y, vec);
  };

  // chunks 0 .. SLOTS - 2 in flight while the inputs stage
  WideStep issue{0, 0};
  for (int s = 0; s < L::SLOTS - 1; ++s) {
    if (issue.k < tl.count()) {
      issue_step(issue, s);
      issue = wide_next<NMAT>(issue, tl, m);
    }
    cp_async_commit();
  }
  wide_stage<KD>(s_inv, s_zs, zc, lp, m, d);
  __syncthreads();  // the inputs staged
  const int kr = tid % BM, c0 = tid / BM * L::E;
  const float* xrow = kr < n ? xblk + (size_t)kr * d : nullptr;
  float xs[KD > 0 ? KD : 1] = {};
  if constexpr (KD > 0) {
    if (xrow != nullptr) {
#pragma unroll
      for (int k = 0; k < KD; ++k) xs[k] = __fmul_rn(xrow[k], s_inv[k]);
    }
  }
  auto knm_step = [&](WideStep s, float* buf) {
    float v[L::E];
    wide_knm_chunk<KD, L::E>(buf, BM, kr, c0, kWideBK * s.c, xs, xrow, s_zs, zc, lp, s_inv, var,
                             m, d, v);
    if (xrow != nullptr) on_knm(s, kr, kWideBK * s.c + c0, v);
  };
  knm_step(WideStep{0, 0}, s_knm);

  float acc[NMAT][MR][kWideMC];
#pragma unroll
  for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
    for (int rr = 0; rr < MR; ++rr)
#pragma unroll
      for (int cc = 0; cc < kWideMC; ++cc) acc[mat][rr][cc] = 0.f;
  WideStep cur{0, 0};
  for (int s = 0; cur.k < tl.count(); ++s) {
    cp_async_wait<L::SLOTS - 2>();
    __syncthreads();  // chunk s staged; knm's chunk s visible; step s - 1's buffers free
    if (issue.k < tl.count()) {
      issue_step(issue, (s + L::SLOTS - 1) % L::SLOTS);  // where chunk s - 1 was
      issue = wide_next<NMAT>(issue, tl, m);
    }
    cp_async_commit();
    on_step(cur, s_knm + (s & 1) * kWideBK * BM);
    const WideStep nxt = wide_next<NMAT>(cur, tl, m);
    if (nxt.k < tl.count()) knm_step(nxt, s_knm + ((s + 1) & 1) * kWideBK * BM);
    const int t = tl.tile(cur.k);
    const int2 g = wide_groups<NMAT>(t, cur.c, m);
    if (group >= g.x && group < g.y) {
      wide_fma_chunk<NMAT, MR>(acc, s_knm + (s & 1) * kWideBK * BM + MR * ty, BM,
                               s_stg + (s % L::SLOTS) * L::STAGE + wide_col(tx) * kWideLDS);
    }
    if (nxt.k != cur.k) {  // the tile's last chunk: its squares fold
      on_tile(t, acc);
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
#pragma unroll
        for (int rr = 0; rr < MR; ++rr) {
          float q = 0.f;
#pragma unroll
          for (int cc = 0; cc < kWideMC; ++cc) {
            q = fmaf(acc[mat][rr][cc], acc[mat][rr][cc], q);
            acc[mat][rr][cc] = 0.f;
          }
          q = wide_lane_sum<8>(q);
          if ((lane & 7) == 0) s_fold[(mat * kWideGroups + group) * BM + MR * ty + rr] = q;
        }
      }
      __syncthreads();
      if (tid < NMAT * BM) {
        const float* f = s_fold + tid / BM * kWideGroups * BM + tid % BM;
        s_part[(t * NMAT + tid / BM) * BM + tid % BM] =
            __fadd_rn(__fadd_rn(f[0], f[BM]), __fadd_rn(f[2 * BM], f[3 * BM]));
      }
    }
    cur = nxt;
  }
  return s_part;
}

// The launch of a wide body: its rows a thread MR, row threads TR, cluster
// size cs and row tiles. BM = MR TR starts at the most rows a block takes,
// no more than a cell's N rows need; then, while the blocks do not cover
// the card's SMs, the projection splits its column tiles over a cluster
// (into their pairs), and the row tile halves. The prediction takes 8 rows
// a thread; the projection 8, or 2 where that launch gives the card fewer
// than kWideFewWarps warps an SM at m <= 256. None of it changes a bit of
// any row.
struct WidePlan {
  int mr, tr, cs;
  long long tiles;  // row tiles of a cell
};

template <int NMAT, int MR>
WidePlan wide_plan_mr(int P, long long N, int m, int sms) {
  using L = WideLayout<NMAT, MR>;
  int tr = L::TRMAX, cs = 1;
  while (tr > L::TRMIN && (long long)MR * (tr / 2) >= N) tr /= 2;
  auto tiles = [&] { return (N + MR * tr - 1) / (MR * tr); };
  if (NMAT == 1 && tiles() * P < sms) cs = (wide_tiles(m) + 1) / 2;
  while (tiles() * cs * P < sms && tr > L::TRMIN) tr /= 2;
  return {MR, tr, cs, tiles()};
}

template <int NMAT>
WidePlan wide_plan(int P, long long N, int m, int sms) {
  if constexpr (NMAT == 2) {
    return wide_plan_mr<2, 8>(P, N, m, sms);
  } else {
    const WidePlan plan = wide_plan_mr<1, 8>(P, N, m, sms);
    const long long warps = plan.tiles * plan.cs * P * plan.tr;
    return warps < (long long)kWideFewWarps * sms && m <= 256 ? wide_plan_mr<1, 2>(P, N, m, sms)
                                                              : plan;
  }
}

// Launch a wide body: a cluster of cs blocks along x where cs > 1.
template <class K, class... Args>
cudaError_t wide_launch(K kernel, int cs, dim3 grid, int threads, int smem_bytes,
                        cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Opt a source's wide kernels in to the most dynamic shared memory a block
// may have, once per device (`done` is their own flags; never while a
// stream is being captured, since the first launch on a device does it),
// and read the device's SM count into sms[device].
constexpr int kMaxDevices = 64;

template <class... K>
cudaError_t wide_opt_in(bool (&done)[kMaxDevices], int (&sms)[kMaxDevices], int device,
                        K... kernels) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  cudaError_t err = cudaSuccess;
  ((err = err != cudaSuccess ? err
                             : cudaFuncSetAttribute(kernels,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    kWideMaxSmem)),
   ...);
  if (err == cudaSuccess && sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) done[device] = true;
  return err;
}

}  // namespace psvgp
