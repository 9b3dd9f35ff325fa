// ELBO projection and RBF cross-covariance for Hopper (sm_90a), fp32 throughout.
//
// Replaces two Pallas TPU kernels:
//   svgp_projection_pallas  src/repro/kernels/svgp_proj.py:47 -- the ELBO's
//                           O(B m^2) hot path (entry psvgp_svgp_projection);
//   rbf_cross_cov_pallas    src/repro/kernels/rbf.py:46 -- K(X, Z) alone
//                           (entry psvgp_rbf_cross_cov).
// Both are this one __global__ body with a cell axis, so ONE launch covers
// every cell's B rows of a training step (the JAX package vmaps the Pallas
// kernel over the cells instead). Per row, with its cell's z/l and W staged
// in shared memory:
//   knm_j  = sigma^2 * exp(-0.5 * sum_k (x_k/l_k - z_jk/l_k)^2)   explicit difference
//   lk_t_i = sum_j W_ij knm_j        (W = Lmm^{-1}, lower triangular)
//   q_diag = sum_i lk_t_i^2
// The rbf entry stops after knm, which is the same sequence of operations
// as the projection's, so the two entries' knm agree bitwise. knm never
// needs to be read back: the projection keeps it in registers and writes
// it once (the JAX signature returns it; the ELBO drops it).
//
// What bounds it: at the training step's shape (P = 400, B = 32, m = 5,
// d = 2) a launch reads ~0.16 MB, writes ~0.56 MB and does ~1.4 MFLOP:
// bytes-bound at ~0.2 us on paper, so the launch and the latency of the
// staging round trip bound it. At 65,536 rows of one cell it writes
// 2.6 MB, and the bytes and how the stores fall on sectors bound it.
//
// Design: one row per thread, a block's rows one contiguous range of the
// flat (P*B) rows. At small B a block packs C whole cells (4 cells x 32
// rows in a 128-thread block at B = 32: 100 blocks); at large B it takes a
// tile of one cell's rows (512 blocks of 128 rows at B = 65,536). The
// block stages its cells' factors once, with one barrier: the rows' x are
// loaded first and stay in flight across it, W goes to shared memory by
// cp.async (16-byte copies where m is a multiple of 4, else 4-byte), and
// z/l (by the thread that stages it), 1/l and sigma^2 (by every thread)
// come from the inputs the thread loads itself. knm and lk_t are (P, B, m), and a block's rows
// form one contiguous slab of (rows x m) floats in each. A launch of
// 65,536 rows or more is bound by its stores: each thread puts its row in
// shared memory (odd row stride: no bank conflicts) and, after a second
// barrier, the block stores the slab with consecutive threads on
// consecutive addresses, in float4 from the slab's first 16-byte boundary
// and in single floats at its unaligned head and tail. A smaller launch
// (the training step's 12,800 rows) is bound by latency: there a thread
// stores its row straight from registers as each value is ready, so the
// stores overlap the rest of the row and no barrier waits for them (both
// paths measured at both shapes on the H100: PERF.md). q_diag is one
// coalesced store per row. No atomics: every output element is written
// once by one thread, so the kernel is deterministic, and which store
// path a launch takes changes no value.
//
// Why not tensor cores or TMA: m = 5, and fp32 is required with no TF32
// (the serving path's fitted mean cancels to ~1e-3 relative, and the ELBO
// takes the same rule). TMA bulk copies need 16-byte aligned addresses and
// sizes; cell p's (5, 5) W starts at 100 p bytes and a slab of the outputs
// at 20 g bytes, so neither the staging nor the stores fit it.
//
// Numerics: FFMA loops, expf (not __expf), no --use_fast_math. Any m in
// [1, 64] (template bound MMAX: m itself up to 8, then 16, 32, 64; W's
// padded columns are staged as zeros, so the padded columns of knm are
// inert), any B >= 1, d in [1, 4] (template bound KD: 2 for the paper's
// (lon, lat), else 4 with the padded dims zero); no padding contract.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

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
template <int MMAX, bool kProject>
__host__ __device__ constexpr int max_cells() {
  constexpr int per_cell = (kProject ? MMAX * row_stride<MMAX>() : 0) + MMAX * kMaxD;
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

template <int MMAX, int KD, bool kProject>
__global__ void __launch_bounds__(max_rows<MMAX>()) projection_kernel(
    const float* __restrict__ x,        // (P, B, d)
    const float* __restrict__ z,        // (P, m, d)
    const float* __restrict__ log_l,    // (P, d)
    const float* __restrict__ log_var,  // (P,)
    const float* __restrict__ w,        // (P, m, m); unused without kProject
    float* __restrict__ knm,            // (P, B, m)
    float* __restrict__ lk_t,           // (P, B, m); unused without kProject
    float* __restrict__ q_diag,         // (P, B);    unused without kProject
    int P, int B, int m, int d, int cells, int tiles, int R, bool slab) {
  constexpr int CMAX = max_cells<MMAX, kProject>();
  constexpr int LD = row_stride<MMAX>();
  constexpr int kOut = max_rows<MMAX>() * (MMAX + 1);
  __shared__ __align__(16) float s_w[kProject ? CMAX * MMAX * LD : 1];
  __shared__ __align__(16) float s_zs[CMAX * MMAX * kMaxD];  // z / l, zero-padded
  __shared__ __align__(16) float s_knm[kOut];
  __shared__ __align__(16) float s_lk[kProject ? kOut : 1];

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
  if (kProject) stage_matrices<MMAX, LD>(s_w, w + (size_t)p0 * m * m, nc, m);
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
  if (kProject) cp_async_wait_all();
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
    if (kProject) {
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
  }
  if (!slab) return;
  __syncthreads();
  store_slab(knm + g0 * m, s_knm, n * m, m, stride);
  if (kProject) store_slab(lk_t + g0 * m, s_lk, n * m, m, stride);
}

template <int MMAX, int KD, bool kProject>
cudaError_t launch_m(const float* x, const float* z, const float* log_l,
                     const float* log_var, const float* w, float* knm, float* lk_t,
                     float* q_diag, int P, int B, int m, int d, cudaStream_t stream) {
  constexpr int rows = max_rows<MMAX>();
  int cells = 1, tiles = 1, R = B;
  long long blocks;
  if (B <= rows) {  // pack whole cells
    cells = rows / B < max_cells<MMAX, kProject>() ? rows / B : max_cells<MMAX, kProject>();
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
  projection_kernel<MMAX, KD, kProject><<<(unsigned)blocks, threads, 0, stream>>>(
      x, z, log_l, log_var, w, knm, lk_t, q_diag, P, B, m, d, cells, tiles, R, slab);
  return cudaSuccess;
}

template <bool kProject>
cudaError_t launch(const float* x, const float* z, const float* log_l, const float* log_var,
                   const float* w, float* knm, float* lk_t, float* q_diag,
                   int P, int B, int m, int d, cudaStream_t stream) {
  return with_mmax(m, [&](auto mmax) {
    constexpr int M = decltype(mmax)::value;
    return d == 2 ? launch_m<M, 2, kProject>(x, z, log_l, log_var, w, knm, lk_t, q_diag,
                                             P, B, m, d, stream)
                  : launch_m<M, kMaxD, kProject>(x, z, log_l, log_var, w, knm, lk_t, q_diag,
                                                 P, B, m, d, stream);
  });
}

int check_args(int P, int B, int m, int d, int device) {
  if (P < 1 || P > 65535 || B < 1 || m < 1 || m > 64 || d < 1 || d > kMaxD) {
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
  const int err = check_args(P, B, m, d, device);
  if (err != 0) return err;
  const cudaError_t bad = launch<true>(
      static_cast<const float*>(x), static_cast<const float*>(z),
      static_cast<const float*>(log_l), static_cast<const float*>(log_var),
      static_cast<const float*>(w), static_cast<float*>(knm), static_cast<float*>(lk_t),
      static_cast<float*>(q_diag), P, B, m, d, static_cast<cudaStream_t>(stream));
  if (bad != cudaSuccess) return (int)bad;
  return (int)cudaGetLastError();
}

extern "C" int psvgp_rbf_cross_cov(
    const void* x, const void* z, const void* log_l, const void* log_var, void* knm,
    int P, int B, int m, int d, int device, void* stream) {
  const int err = check_args(P, B, m, d, device);
  if (err != 0) return err;
  const cudaError_t bad = launch<false>(
      static_cast<const float*>(x), static_cast<const float*>(z),
      static_cast<const float*>(log_l), static_cast<const float*>(log_var), nullptr,
      static_cast<float*>(knm), nullptr, nullptr, P, B, m, d,
      static_cast<cudaStream_t>(stream));
  if (bad != cudaSuccess) return (int)bad;
  return (int)cudaGetLastError();
}
