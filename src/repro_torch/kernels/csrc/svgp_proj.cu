// ELBO projection and RBF cross-covariance for Hopper (sm_90a), fp32 throughout.
//
// Replaces two Pallas TPU kernels:
//   svgp_projection_pallas  src/repro/kernels/svgp_proj.py:47 -- the ELBO's
//                           O(B m^2) hot path (entry psvgp_svgp_projection);
//   rbf_cross_cov_pallas    src/repro/kernels/rbf.py:46 -- K(X, Z) alone
//                           (entry psvgp_rbf_cross_cov).
// Both take a cell axis, so ONE launch covers every cell's B rows (the JAX
// package vmaps the Pallas kernels over the cells instead). Per row, with
// its cell's z/l and W:
//   knm_j  = sigma^2 * exp(-0.5 * sum_k (x_k/l_k - z_jk/l_k)^2)   explicit difference
//   lk_t_i = sum_j W_ij knm_j        (W = Lmm^{-1}, lower triangular)
//   q_diag = sum_i lk_t_i^2
// Every body runs the same sequence of operations per knm element (x/l and
// z/l by __fmul_rn, __fsub_rn, r2 by fmaf in k order, expf), so the two
// entries' knm agree bitwise at every m and d.
//
// The projection has two bodies, chosen by m and d alone:
//
// Narrow (m <= 16, d <= 4; templates on m and d). What bounds it: at the
// training step's shape (P = 400, B = 32, m = 5, d = 2) a launch reads
// ~0.16 MB, writes ~0.56 MB and does ~1.4 MFLOP: bytes-bound at ~0.2 us on
// paper, so the launch and the latency of the staging round trip bound it.
// One row per thread, a block's rows one contiguous range of the flat (P*B)
// rows. At small B a block packs C whole cells (4 cells x 32 rows in a
// 128-thread block at B = 32: 100 blocks); at large B it takes a tile of
// one cell's rows (512 blocks of 128 rows at B = 65,536). The block stages
// its cells' factors once, with one barrier: the rows' x are loaded first
// and stay in flight across it, W goes to shared memory by cp.async
// (16-byte copies where m is a multiple of 4, else 4-byte), and z/l (by the
// thread that stages it), 1/l and sigma^2 (by every thread) come from the
// inputs the thread loads itself. knm and lk_t are (P, B, m), and a block's
// rows form one contiguous slab of (rows x m) floats in each. A launch of
// 65,536 rows or more is bound by its stores: each thread puts its row in
// shared memory (odd row stride: no bank conflicts) and, after a second
// barrier, the block stores the slab with consecutive threads on
// consecutive addresses, in float4 from the slab's first 16-byte boundary
// and in single floats at its unaligned head and tail. A smaller launch is
// bound by latency: there a thread stores its row straight from registers
// as each value is ready (both paths measured on the H100: PERF.md).
//
// Wide (m in [17, 2048], or d > 4; m and d runtime): past m = 64 knm no
// longer fits a thread's registers nor W a block's shared memory, and from
// m = 17 it beats the narrow body (PERF.md); at m >= 128 the FFMA of knm
// W^T over W's triangle bound it (67 TFLOP/s FP32: no tensor cores, since
// Hopper's have no fp32 mode and TF32 is ruled out). The GEMM of
// kernel_common.cuh: knm computed a 16-column chunk at a time beside W's
// chunk (cp.async), W's tiles above the diagonal skipped.
//
// K(X, Z) has its own body: an elementwise pass bound by its stores, 4
// consecutive outputs a thread per step (one float4 store), consecutive
// threads on consecutive addresses, z/l staged (one barrier) only in a
// launch past one wave; any m and d.
//
// No atomics anywhere: every output element is written once by one thread,
// so the kernels are deterministic, and a row's bits do not depend on its
// block, packing or store path.
//
// Why not tensor cores or TMA: fp32 is required with no TF32 (the serving
// path's fitted mean cancels to ~1e-3 relative, and the ELBO takes the same
// rule). TMA bulk copies need 16-byte aligned addresses and sizes; cell p's
// (5, 5) W starts at 100 p bytes and a slab of the outputs at 20 g bytes,
// so neither the staging nor the stores fit it.
//
// Numerics: FFMA loops, expf (not __expf), no --use_fast_math. Any m in
// [1, 2048] for the projection and any m for K(X, Z); any B >= 1; any d;
// no padding contract.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>

#include "kernel_common.cuh"

namespace {

using namespace psvgp;

constexpr int kStageFloats = 4096;  // shared memory for staged factors (16 KB)
constexpr long long kSlabRows = 65536;  // launches this large store through slabs

// rows (threads) a block takes at most; each slab buffer is rows x (MMAX+1)
template <int MMAX>
__host__ __device__ constexpr int max_rows() {
  return MMAX <= 16 ? 128 : (MMAX <= 32 ? 64 : 32);
}

// cells a block stages at most: as many as fit kStageFloats, at least one
template <int MMAX>
__host__ __device__ constexpr int max_cells() {
  constexpr int per_cell = MMAX * row_stride<MMAX>() + MMAX * kMaxD;
  constexpr int fit = kStageFloats / per_cell;
  return fit < 1 ? 1 : (fit > max_rows<MMAX>() ? max_rows<MMAX>() : fit);
}

// Store the block's slab: `count` floats of rows x m (row stride `stride`
// in `buf`) to dst[0 .. count), consecutive threads on consecutive
// addresses; float4 from the first 16-byte boundary on.
__device__ __forceinline__ void store_slab(float* __restrict__ dst, const float* buf,
                                           int count, int m, int stride) {
  const int tid = threadIdx.x, T = blockDim.x;
  auto at = [&](int e) { return stride == m ? buf[e] : buf[e + e / m]; };  // stride m + 1
  int head = (int)((4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3);
  if (head > count) head = count;
  const int nvec = (count - head) / 4;
  for (int e = tid; e < head; e += T) dst[e] = at(e);
  float4* body = reinterpret_cast<float4*>(dst + head);
  for (int v = tid; v < nvec; v += T) {
    const int e = head + 4 * v;
    body[v] = make_float4(at(e), at(e + 1), at(e + 2), at(e + 3));
  }
  for (int e = head + 4 * nvec + tid; e < count; e += T) dst[e] = at(e);
}

template <int MMAX, int KD>
__global__ void __launch_bounds__(max_rows<MMAX>()) projection_kernel(
    const float* __restrict__ x,        // (P, B, d)
    const float* __restrict__ z,        // (P, m, d)
    const float* __restrict__ log_l,    // (P, d)
    const float* __restrict__ log_var,  // (P,)
    const float* __restrict__ w,        // (P, m, m)
    float* __restrict__ knm,            // (P, B, m)
    float* __restrict__ lk_t,           // (P, B, m)
    float* __restrict__ q_diag,         // (P, B)
    int P, int B, int m, int d, int cells, int tiles, int R, bool slab) {
  constexpr int CMAX = max_cells<MMAX>();
  constexpr int LD = row_stride<MMAX>();
  constexpr int kOut = max_rows<MMAX>() * (MMAX + 1);
  __shared__ __align__(16) float s_w[CMAX * MMAX * LD];
  __shared__ __align__(16) float s_zs[CMAX * MMAX * kMaxD];  // z / l, zero-padded
  __shared__ __align__(16) float s_knm[kOut];
  __shared__ __align__(16) float s_lk[kOut];

  // the block's rows: [g0, g0 + n) of the flat (P*B) rows, cells [p0, p0 + nc)
  const int tid = threadIdx.x;
  int p0, nc, n;
  long long g0;
  if (tiles == 1) {  // whole cells
    p0 = blockIdx.x * cells;
    nc = min(cells, P - p0);
    g0 = (long long)p0 * B;
    n = nc * B;
  } else {  // a tile of one cell
    p0 = blockIdx.x / tiles;
    const int t = blockIdx.x % tiles;
    nc = 1;
    g0 = (long long)p0 * B + (long long)t * R;
    n = min(R, B - t * R);
  }
  const bool active = tid < n;
  const int slot = tiles == 1 ? tid / B : 0;  // this row's cell, p0 + slot
  const int p = p0 + (active ? slot : 0);
  const long long g = g0 + tid;

  // 1. this row's x, in flight across the barrier
  float xs[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) xs[k] = 0.f;
  if (active) {
    if (KD == 2 && (reinterpret_cast<uintptr_t>(x) & 7) == 0) {
      const float2 q = reinterpret_cast<const float2*>(x)[g];
      xs[0] = q.x;
      xs[1] = q.y;
    } else {
#pragma unroll
      for (int k = 0; k < KD; ++k)
        if (k < d) xs[k] = x[g * d + k];
    }
  }

  // 2. the block's cells' factors: W by cp.async (zeros past column m),
  // z/l through registers; this row's 1/l and sigma^2
  stage_matrices<MMAX, LD>(s_w, w + (size_t)p0 * m * m, nc, m);
  for (int i = tid; i < nc * MMAX * kMaxD; i += blockDim.x) {
    const int cs = i / (MMAX * kMaxD), e = i % (MMAX * kMaxD);
    const int j = e / kMaxD, k = e % kMaxD;
    const size_t pc = (size_t)(p0 + cs);
    s_zs[i] = (j < m && k < d)
                  ? __fmul_rn(z[(pc * m + j) * d + k], expf(-log_l[pc * d + k]))
                  : 0.f;
  }
  float inv_l[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) inv_l[k] = k < d ? expf(-log_l[(size_t)p * d + k]) : 0.f;
  const float var = expf(log_var[p]);
  cp_async_wait_all();
  __syncthreads();

  // 3. the row's outputs in registers, then to the outputs: straight from
  // registers in a small launch (the stores then overlap the rest of the
  // row), through shared memory as coalesced slabs in a large one
  const int stride = m | 1;  // odd: no bank conflicts
  if (active) {
    const float* zs = s_zs + slot * MMAX * kMaxD;
    float kn[MMAX];
#pragma unroll
    for (int k = 0; k < KD; ++k) xs[k] = __fmul_rn(xs[k], inv_l[k]);
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      float kj = 0.f;
      if (j < m) {
        float r2 = 0.f;
#pragma unroll
        for (int k = 0; k < KD; ++k) {
          const float df = __fsub_rn(xs[k], zs[j * kMaxD + k]);
          r2 = fmaf(df, df, r2);
        }
        kj = __fmul_rn(var, expf(__fmul_rn(-0.5f, r2)));
        if (slab) {
          s_knm[tid * stride + j] = kj;
        } else {
          knm[g * m + j] = kj;
        }
      }
      kn[j] = kj;
    }
    // rows of W up to m: unrolled where MMAX = m (m <= 8), else by 4
    // (each row's sum over j is a dependent chain: rows side by side hide it)
    constexpr int kUnrollRows = MMAX <= 8 ? MMAX : 4;
    const float* wc = s_w + slot * MMAX * LD;
    float qd = 0.f;
#pragma unroll kUnrollRows
    for (int i = 0; i < (MMAX <= 8 ? MMAX : m); ++i) {
      float lk = 0.f;
#pragma unroll
      for (int j = 0; j < MMAX; ++j) lk = fmaf(wc[i * LD + j], kn[j], lk);
      if (slab) {
        s_lk[tid * stride + i] = lk;
      } else {
        lk_t[g * m + i] = lk;
      }
      qd = fmaf(lk, lk, qd);
    }
    q_diag[g] = qd;
  }
  if (!slab) return;
  __syncthreads();
  store_slab(knm + g0 * m, s_knm, n * m, m, stride);
  store_slab(lk_t + g0 * m, s_lk, n * m, m, stride);
}

template <int MMAX, int KD>
cudaError_t launch_m(const float* x, const float* z, const float* log_l,
                     const float* log_var, const float* w, float* knm, float* lk_t,
                     float* q_diag, int P, int B, int m, int d, cudaStream_t stream) {
  constexpr int rows = max_rows<MMAX>();
  int cells = 1, tiles = 1, R = B;
  long long blocks;
  if (B <= rows) {  // pack whole cells
    cells = rows / B < max_cells<MMAX>() ? rows / B : max_cells<MMAX>();
    if (cells > P) cells = P;
    blocks = (P + cells - 1) / cells;
  } else {  // balanced tiles of at most `rows` rows of one cell
    tiles = (B + rows - 1) / rows;
    R = (B + tiles - 1) / tiles;
    blocks = (long long)tiles * P;
  }
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int threads = ((tiles == 1 ? cells * B : R) + 31) / 32 * 32;
  const bool slab = (long long)P * B >= kSlabRows;
  projection_kernel<MMAX, KD><<<(unsigned)blocks, threads, 0, stream>>>(
      x, z, log_l, log_var, w, knm, lk_t, q_diag, P, B, m, d, cells, tiles, R, slab);
  return cudaSuccess;
}

// The wide body (m >= 17, or d > 4; m and d runtime): grid (row tiles x cs,
// P), 32 TR threads, a cluster of cs blocks along x where cs > 1. A block
// runs the loop of kernel_common.cuh (wide_run) over its column tiles of W:
// each thread holds MR rows x 4 columns of knm W^T. W is lower triangular:
// tile t's chunks stop at its last column, and a warp skips a chunk that
// lies wholly above the diagonal of its 32 columns (those terms are zeros,
// so no bit changes). Each tile computes knm anew up to its last column and
// stores its diagonal chunks' knm (float4 where m is a multiple of 4); its
// lk_t goes out from the registers (8 threads a row, 32 consecutive
// floats), and rank 0 adds the tiles' squares in tile order into q_diag.
template <int KD, int MR>
__global__ void __launch_bounds__(256, 2) projection_wide_kernel(
    const float* __restrict__ x, const float* __restrict__ z, const float* __restrict__ log_l,
    const float* __restrict__ log_var, const float* __restrict__ w, float* __restrict__ knm,
    float* __restrict__ lk_t, float* __restrict__ q_diag, int B, int m, int d, int cs) {
  using L = WideLayout<1, MR>;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  const int BM = MR * (blockDim.x / kWideTC), nt = wide_tiles(m);
  const int tid = threadIdx.x, tx = wide_tx(tid), ty = wide_ty(tid), p = blockIdx.y;
  const WideTiles tl{nt, cs, (int)(blockIdx.x % cs)};
  const int row0 = (int)(blockIdx.x / cs) * BM;
  const int n = min(BM, B - row0);
  const long long g0 = (long long)p * B + row0;  // the block's first row of the flat (P*B)
  const float* wp = w + (size_t)p * m * m;
  const bool vec = (m & 3) == 0 && (reinterpret_cast<uintptr_t>(knm) & 15) == 0;
  const float* s_part = wide_run<1, KD, MR>(
      smem, tl, n, x + (size_t)g0 * d, z + (size_t)p * m * d, log_l + (size_t)p * d,
      expf(log_var[p]), wp, wp, m, d,
      [&](WideStep s, int kr, int j, const auto& v) {  // a diagonal chunk's knm goes out
        if (kWideBK * s.c < kWideBN * tl.tile(s.k)) return;
        float* dst = knm + (size_t)(g0 + kr) * m + j;
        if (L::E % 4 == 0 && vec) {
#pragma unroll
          for (int e = 0; e < L::E; e += 4)
            if (j + e < m)
              *reinterpret_cast<float4*>(dst + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < L::E; ++e)
            if (j + e < m) dst[e] = v[e];
        }
      },
      [&](WideStep, const float*) {},
      [&](int t, const auto& acc) {  // the tile's lk_t out
        const int i = kWideBN * t + wide_col(tx);
#pragma unroll
        for (int rr = 0; rr < MR; ++rr) {
          const int r = MR * ty + rr;
          float* dst = lk_t + (size_t)(g0 + r) * m + i;
#pragma unroll
          for (int cc = 0; cc < kWideMC; ++cc)
            if (r < n && i + 8 * cc < m) dst[8 * cc] = acc[0][rr][cc];
        }
      });

  // rank 0 adds the tiles' partials in tile order into q_diag
  if (cs > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  if (tl.rank == 0 && tid < n) {
    float q = 0.f;
    for (int t = 0; t < nt; ++t) {
      const float* src = cs > 1 ? cg::this_cluster().map_shared_rank(s_part, tl.owner(t)) : s_part;
      q = __fadd_rn(q, src[t * BM + tid]);
    }
    q_diag[g0 + tid] = q;
  }
  if (cs > 1) cg::this_cluster().sync();  // the partials stay until rank 0 has read them
}

bool g_wide_opted[2][kMaxDevices];  // [KD > 0]
int g_sms[kMaxDevices];

template <int KD, int MR>
cudaError_t launch_wide_mr(const WidePlan& plan, const float* x, const float* z,
                           const float* log_l, const float* log_var, const float* w, float* knm,
                           float* lk_t, float* q_diag, int P, int B, int m, int d,
                           cudaStream_t stream) {
  if (plan.tiles * plan.cs > INT_MAX) return cudaErrorInvalidValue;
  const int smem = 4 * wide_run_floats<1, MR>(m, KD, MR * plan.tr);
  return wide_launch(projection_wide_kernel<KD, MR>, plan.cs,
                     dim3((unsigned)(plan.tiles * plan.cs), P), kWideTC * plan.tr,
                     smem, stream, x, z, log_l, log_var, w, knm, lk_t, q_diag, B, m, d, plan.cs);
}

template <int KD>
cudaError_t launch_wide_kd(const float* x, const float* z, const float* log_l,
                           const float* log_var, const float* w, float* knm, float* lk_t,
                           float* q_diag, int P, int B, int m, int d, int device,
                           cudaStream_t stream) {
  const cudaError_t err = wide_opt_in(g_wide_opted[KD > 0], g_sms, device,
                                      projection_wide_kernel<KD, 8>, projection_wide_kernel<KD, 2>);
  if (err != cudaSuccess) return err;
  const WidePlan plan = wide_plan<1>(P, B, m, g_sms[device]);
  return plan.mr == 8 ? launch_wide_mr<KD, 8>(plan, x, z, log_l, log_var, w, knm, lk_t, q_diag, P,
                                               B, m, d, stream)
                      : launch_wide_mr<KD, 2>(plan, x, z, log_l, log_var, w, knm, lk_t, q_diag, P,
                                               B, m, d, stream);
}

cudaError_t launch_wide(const float* x, const float* z, const float* log_l, const float* log_var,
                        const float* w, float* knm, float* lk_t, float* q_diag, int P, int B,
                        int m, int d, int device, cudaStream_t stream) {
  return d == 2 ? launch_wide_kd<2>(x, z, log_l, log_var, w, knm, lk_t, q_diag, P, B, m, d,
                                    device, stream)
                : launch_wide_kd<0>(x, z, log_l, log_var, w, knm, lk_t, q_diag, P, B, m, d,
                                    device, stream);
}

cudaError_t launch_projection(const float* x, const float* z, const float* log_l,
                              const float* log_var, const float* w, float* knm, float* lk_t,
                              float* q_diag, int P, int B, int m, int d, int device,
                              cudaStream_t stream) {
  // the instance is chosen by m and d alone
  static_assert(kProjectionWideMinM <= 17, "the narrow instances end at MMAX = 16");
  if (m >= kProjectionWideMinM || d > kMaxD) {
    return launch_wide(x, z, log_l, log_var, w, knm, lk_t, q_diag, P, B, m, d, device, stream);
  }
  return with_mmax<16>(m, [&](auto mmax) {
    constexpr int M = decltype(mmax)::value;
    return d == 2 ? launch_m<M, 2>(x, z, log_l, log_var, w, knm, lk_t, q_diag, P, B, m, d, stream)
                  : launch_m<M, kMaxD>(x, z, log_l, log_var, w, knm, lk_t, q_diag, P, B, m, d,
                                       stream);
  });
}

// K(X, Z) alone is a store-bound elementwise pass over cell p's flat (B * m)
// outputs (grid (tiles, P)). Each thread takes groups of 4 consecutive
// elements, consecutive threads on consecutive groups, and stores a group
// as one float4 where the cell's run is 16-byte aligned (else 4 floats):
// every store coalesced, no slab. A row's x/l stays in registers across
// the elements of its row; where m is a multiple of 4 a group lies in one
// row and takes no per-element row check. z/l: a launch past one wave of
// the card is bound by issue, so its blocks stage z/l in dynamic shared
// memory once (one barrier; 16 KB at most) and read it back as float4; a
// smaller one is bound by latency and computes z/l from z (L1-resident)
// where it is used, with no barrier and no shared memory (the two are
// separate instances: a runtime switch between them cost the small launch
// ~0.2 us on the H100, PERF.md). Every element runs the projection's sequence of
// operations, so the two entries' knm agree bitwise whichever path it
// takes. No m x m factor is staged: m has no ceiling.
// KD: 2 or 4 (1/l and x in registers), or 0 (any d, 1/l recomputed).
constexpr int kRbfStage = 4096;  // floats of z/l a block stages at most
constexpr int kRbfThreads = 256;
constexpr long long kOneWaveThreads = 270336;  // 132 SMs x 2,048 threads

// whether a launch stages z/l: past one wave (groups > 1) where it fits
__host__ __device__ inline bool rbf_staged(int kd, int groups, int m) {
  return kd > 0 && groups > 1 && (long long)m * kd <= kRbfStage;
}

template <int KD, bool kStaged>
__global__ void __launch_bounds__(kRbfThreads) rbf_kernel(
    const float* __restrict__ x, const float* __restrict__ z, const float* __restrict__ log_l,
    const float* __restrict__ log_var, float* __restrict__ knm, int B, int m, int d, int groups) {
  extern __shared__ __align__(16) float s_zs[];  // m * KR floats where staged
  constexpr int KR = KD > 0 ? KD : 1;
  const int p = blockIdx.y, T = blockDim.x, tid = threadIdx.x;
  const long long nel = (long long)B * m;
  const float* lp = log_l + (size_t)p * d;
  const float* xp = x + (size_t)p * B * d;
  const float* zp = z + (size_t)p * m * d;
  float* out = knm + (size_t)p * nel;
  float inv_l[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) inv_l[k] = (KD > 0 && k < d) ? expf(-lp[k]) : 0.f;
  const float var = expf(log_var[p]);
  constexpr bool staged = kStaged && KD > 0;
  if (staged) {
    for (int i = tid; i < m * KR; i += T) {
      const int j = i / KR, k = i % KR;
      s_zs[i] = k < d ? __fmul_rn(zp[(size_t)j * d + k], expf(-lp[k])) : 0.f;
    }
    __syncthreads();
  }
  float xs[KR];  // the current row's x/l
  // one element: the projection's sequence on the row's x/l and z_j / l
  auto element = [&](long long b, int j) {
    float r2 = 0.f;
    if (KD > 0) {
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        if (k < d) {
          const float zs =
              staged ? s_zs[j * KR + k] : __fmul_rn(zp[(size_t)j * d + k], inv_l[k]);
          const float df = __fsub_rn(xs[k], zs);
          r2 = fmaf(df, df, r2);
        }
      }
    } else {
      const float* xr = xp + (size_t)b * d;
      for (int k = 0; k < d; ++k) {
        const float il = expf(-lp[k]);
        const float df = __fsub_rn(__fmul_rn(xr[k], il), __fmul_rn(zp[(size_t)j * d + k], il));
        r2 = fmaf(df, df, r2);
      }
    }
    return __fmul_rn(var, expf(__fmul_rn(-0.5f, r2)));
  };
  const bool vec = (nel & 3) == 0 && (reinterpret_cast<uintptr_t>(knm) & 15) == 0;
  for (int g = 0; g < groups; ++g) {
    const long long e0 = 4 * (((long long)blockIdx.x * groups + g) * T + tid);
    if (e0 >= nel) break;
    long long b;
    int j;
    if (nel <= 0xffffffffLL) {
      const unsigned q = (unsigned)e0 / (unsigned)m;
      b = q;
      j = (int)((unsigned)e0 - q * (unsigned)m);
    } else {
      b = e0 / m;
      j = (int)(e0 - b * m);
    }
    auto load_row = [&]() {
#pragma unroll
      for (int k = 0; k < KR; ++k)
        xs[k] = (KD > 0 && k < d) ? __fmul_rn(xp[(size_t)b * d + k], inv_l[k]) : 0.f;
    };
    load_row();
    float v[4];
    if (KD > 0 && staged && (m & 3) == 0) {
      // the group is columns j .. j+3 of one row; their z/l as KR float4
      float zz[4 * KR];
#pragma unroll
      for (int q4 = 0; q4 < KR; ++q4) {
        const float4 f = reinterpret_cast<const float4*>(s_zs + j * KR)[q4];
        zz[4 * q4] = f.x;
        zz[4 * q4 + 1] = f.y;
        zz[4 * q4 + 2] = f.z;
        zz[4 * q4 + 3] = f.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float r2 = 0.f;
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          if (k < d) {
            const float df = __fsub_rn(xs[k], zz[t * KR + k]);
            r2 = fmaf(df, df, r2);
          }
        }
        v[t] = __fmul_rn(var, expf(__fmul_rn(-0.5f, r2)));
      }
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[t] = e0 + t < nel ? element(b, j) : 0.f;
        if (++j == m && t < 3) {
          j = 0;
          ++b;
          if (e0 + t + 1 < nel) load_row();
        }
      }
    }
    if (vec) {
      *reinterpret_cast<float4*>(out + e0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (e0 + t < nel) out[e0 + t] = v[t];
    }
  }
}

cudaError_t launch_rbf(const float* x, const float* z, const float* log_l, const float* log_var,
                       float* knm, int P, int B, int m, int d, cudaStream_t stream) {
  // groups of 4 elements a thread: 1 while one group a thread fits one wave
  // of the card, 4 (and z/l staged) past it; the bits do not depend on it
  const long long nel = (long long)B * m;
  const long long ngroups = (nel + 3) / 4;
  const int groups = (long long)P * ngroups > kOneWaveThreads ? 4 : 1;
  const int threads = ngroups >= kRbfThreads ? kRbfThreads : (int)((ngroups + 31) / 32 * 32);
  const long long per_block = (long long)threads * groups;
  const long long blocks = (ngroups + per_block - 1) / per_block;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, P);
  auto go = [&](auto kernel, int kd) {
    kernel<<<grid, threads, rbf_staged(kd, groups, m) ? 4 * m * kd : 0, stream>>>(
        x, z, log_l, log_var, knm, B, m, d, groups);
  };
  if (d == 2) {
    go(rbf_staged(2, groups, m) ? rbf_kernel<2, true> : rbf_kernel<2, false>, 2);
  } else if (d <= kMaxD) {
    go(rbf_staged(kMaxD, groups, m) ? rbf_kernel<kMaxD, true> : rbf_kernel<kMaxD, false>,
       kMaxD);
  } else {
    go(rbf_kernel<0, false>, 0);
  }
  return cudaSuccess;
}

int check_args(int P, int B, int m, int d, int max_m, int device) {
  if (P < 1 || P > 65535 || B < 1 || m < 1 || m > max_m || d < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSetDevice(device);
}

}  // namespace

// Plain C entries (loaded with ctypes). Every pointer is a CUDA device
// pointer to contiguous float32 data on device `device`; `stream` is the
// caller's cudaStream_t. Each launches asynchronously and returns
// cudaGetLastError() (0 on success); never synchronizes, never allocates.
extern "C" int psvgp_svgp_projection(
    const void* x, const void* z, const void* log_l, const void* log_var, const void* w,
    void* knm, void* lk_t, void* q_diag, int P, int B, int m, int d, int device,
    void* stream) {
  const int err = check_args(P, B, m, d, kWideMaxM, device);
  if (err != 0) return err;
  const cudaError_t bad = launch_projection(
      static_cast<const float*>(x), static_cast<const float*>(z),
      static_cast<const float*>(log_l), static_cast<const float*>(log_var),
      static_cast<const float*>(w), static_cast<float*>(knm), static_cast<float*>(lk_t),
      static_cast<float*>(q_diag), P, B, m, d, device, static_cast<cudaStream_t>(stream));
  if (bad != cudaSuccess) return (int)bad;
  return (int)cudaGetLastError();
}

extern "C" int psvgp_rbf_cross_cov(
    const void* x, const void* z, const void* log_l, const void* log_var, void* knm,
    int P, int B, int m, int d, int device, void* stream) {
  const int err = check_args(P, B, m, d, INT_MAX, device);
  if (err != 0) return err;
  const cudaError_t bad = launch_rbf(
      static_cast<const float*>(x), static_cast<const float*>(z),
      static_cast<const float*>(log_l), static_cast<const float*>(log_var),
      static_cast<float*>(knm), P, B, m, d, static_cast<cudaStream_t>(stream));
  if (bad != cudaSuccess) return (int)bad;
  return (int)cudaGetLastError();
}
