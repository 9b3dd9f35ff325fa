// Fused cached-posterior prediction for Hopper (sm_90a), fp32 throughout.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/predict.py:
//   posterior_predict_slots_pallas  (the "fused" serving lane: S halo slots
//                                    of one model in one launch), and
//   posterior_predict_pallas        (the "pallas" lane: one query block).
// Both entries take a cell axis, so ONE launch evaluates every cell's model
// on its own S halo blocks (the slots entry) or its own (Q, d) block (the
// single-block entry, S = 1: the "pallas" lane's whole request).
//
// Per query row, with cell p's factors staged in shared memory:
//   knm_j = var * exp(-0.5 * sum_k (x_k/l_k - z_jk/l_k)^2)   explicit difference
//   mean  = sum_j knm_j c_j
//   fvar  = var - ||W knm||^2 + ||U knm||^2                  un-clamped
// W = Lmm^{-1}, U the S-factor, c the projected mean (repro_torch.core.
// posterior); in the narrow body knm never leaves registers. Rows are independent (the
// row-independence contract two-level routing relies on): every row runs
// the same explicit sequence of fmaf / __f*_rn / expf on its own query and
// its cell's factors, so a row's bits do not depend on the tile, thread,
// row slot, Q or launch it lands in, and a block may mix owner, spill and
// padded rows.
//
// What bounds it: at the serving path's shape (P = 400, S = 9, q_max = 32,
// m = 5, d = 2) a launch reads and writes ~2 MB (bound ~0.6 us) and does
// ~20 MFLOP: far below both rates, so the launch and the latency of one
// thread's work bound it. At larger q_max the instruction issue of ~150
// instructions a row (m exps, the two m x m projections) comes first, then
// the bytes.
//
// Design: a cell's S x Q rows are one flat range (hx is (P, S, Q, d)
// contiguous). The grid is (ceil(S*Q / R), P): a block takes a tile of R
// rows of one cell, RB rows per thread, the rows of one row slot on
// consecutive threads (coalesced loads and stores). R is chosen on the
// host so that a few blocks cover a cell at the serving shape (1,200
// blocks of 96 threads at (400, 9, 32): one wave) while a single cell's
// 65,536 rows still spread over 512 blocks (the P = 1 lane). RB is 1 while
// one row per thread fits the card in one wave (latency-bound: the
// shortest thread wins) and 4 past it at m <= 8 (issue-bound: each W, U,
// z/l and c value read from shared memory serves 4 rows). A block stages
// its cell's factors once, with one barrier: the thread's queries are
// loaded first (a float2 per row where d = 2 and the address allows) and
// stay in flight across the barrier; W, U and c go to shared memory by
// cp.async (16-byte copies where m is a multiple of 4, else 4-byte); z/l,
// 1/l and var are computed by each thread from the inputs it loads itself,
// so no value staged in shared memory feeds another staged value.
// Templates on m (exact up to 8, so the paper's m = 5 has no padded
// column) and on d (2, the paper's (lon, lat), or 4 padded) keep every
// loop unrolled and free of padding work.
//
// Why not tensor cores or TMA: m = 5, and fp32 is required with no TF32 --
// the fitted mean cancels (sum_j |k_j c_j| ~ 3e3 at |mean| < 3), so TF32's
// ~1e-3 relative error would put errors of order 1 on the mean. TMA bulk
// copies need 16-byte aligned addresses and sizes; a (P, 5, 5) factor slab
// of cell p starts at 100 p bytes, so the factor staging does not fit it.
//
// Wide body (m in [65, 2048], or d > 4; m and d runtime values): knm no
// longer fits a thread's registers nor W and U a block's shared memory (2 x
// 4 MB at m = 1,024), and at m >= 128 the 4 m^2 FLOP a row bound it (FFMA
// at 67 TFLOP/s: Hopper's tensor cores have no fp32 mode and TF32 is ruled
// out). It runs the GEMM of kernel_common.cuh: knm computed a 16-column
// chunk at a time beside W's and U's chunks (cp.async), 8 rows x 4 columns
// of each product a thread, the squares folded in a fixed order, the mean
// summed over j in order. The narrow or wide instance is chosen by m and d
// alone, never by P, S or Q, so a row's bits never depend on the launch it
// lands in.
//
// Numerics: FFMA loops, expf (not __expf), no --use_fast_math. Any m in
// [1, 2048] (narrow template bound MMAX: m itself up to 8, then 16, 32, 64;
// padded columns of W/U/c are staged as zeros so they are inert), any
// Q >= 1, any d (narrow template bound KD: 2 for the paper's (lon, lat),
// else 4 with the padded dims zero; d > 4 takes the wide body); no padding
// contract for the caller.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "kernel_common.cuh"

namespace {

using namespace psvgp;

constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 264;             // two blocks per SM of an H100 (132 SMs)
constexpr long long kOneWaveRows = 270336;  // 132 SMs x 2,048 threads

// rows a thread computes together in a launch too large for one row per
// thread in one wave: as many as keep knm in registers
template <int MMAX>
__host__ __device__ constexpr int rows_per_thread() {
  return MMAX <= 8 ? 4 : (MMAX <= 16 ? 2 : 1);
}

template <int MMAX, int KD, int RB>
__global__ void __launch_bounds__(kMaxThreads) predict_kernel(
    const float* __restrict__ hx,       // (P, S*Q, d)
    const float* __restrict__ z,        // (P, m, d)
    const float* __restrict__ log_l,    // (P, d)
    const float* __restrict__ log_var,  // (P,)
    const float* __restrict__ w,        // (P, m, m)
    const float* __restrict__ u,        // (P, m, m)
    const float* __restrict__ c,        // (P, m)
    float* __restrict__ mean,           // (P, S*Q)
    float* __restrict__ fvar,           // (P, S*Q)
    long long N, int R, int m, int d) {
  constexpr int LD = row_stride<MMAX>();
  __shared__ __align__(16) float s_w[MMAX * LD];
  __shared__ __align__(16) float s_u[MMAX * LD];
  __shared__ __align__(16) float s_zs[MMAX * kMaxD];  // z / l, zero-padded
  __shared__ __align__(16) float s_c[MMAX];

  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const long long tile = (long long)blockIdx.x * R;
  const float* hxp = hx + (size_t)p * N * d;

  // 1. this thread's queries (rows tile + r*T + tid of the cell), in
  // flight across the barrier
  auto valid = [&](int r) { return r * T + tid < R && tile + r * T + tid < N; };
  float xs[RB][KD];
  const bool pairs = KD == 2 && (reinterpret_cast<uintptr_t>(hx) & 7) == 0;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const long long row = tile + r * T + tid;
#pragma unroll
    for (int k = 0; k < KD; ++k) xs[r][k] = 0.f;
    if (valid(r)) {
      if (pairs) {
        const float2 q = reinterpret_cast<const float2*>(hxp)[row];
        xs[r][0] = q.x;
        xs[r][1] = q.y;
      } else {
#pragma unroll
        for (int k = 0; k < KD; ++k)
          if (k < d) xs[r][k] = hxp[row * d + k];
      }
    }
  }

  // 2. cell p's factors: W, U, c by cp.async (zeros past column m), z/l
  // through registers
  stage_matrices<MMAX, LD>(s_w, w + (size_t)p * m * m, 1, m);
  stage_matrices<MMAX, LD>(s_u, u + (size_t)p * m * m, 1, m);
  for (int i = tid; i < MMAX; i += T) {
    if (i < m) {
      cp_async4(&s_c[i], c + (size_t)p * m + i);
    } else {
      s_c[i] = 0.f;
    }
  }
  for (int i = tid; i < MMAX * kMaxD; i += T) {
    const int j = i / kMaxD, k = i % kMaxD;
    s_zs[i] = (j < m && k < d)
                  ? __fmul_rn(z[((size_t)p * m + j) * d + k], expf(-log_l[(size_t)p * d + k]))
                  : 0.f;
  }
  float inv_l[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) inv_l[k] = k < d ? expf(-log_l[(size_t)p * d + k]) : 0.f;
  const float var = expf(log_var[p]);
  cp_async_wait_all();
  __syncthreads();

  // 3. the RB rows, together
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int k = 0; k < KD; ++k) xs[r][k] = __fmul_rn(xs[r][k], inv_l[k]);

  float knm[RB][MMAX];
  float mu[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) mu[r] = 0.f;
#pragma unroll
  for (int j = 0; j < MMAX; ++j) {
    if (j < m) {
      float zj[KD];
#pragma unroll
      for (int k = 0; k < KD; ++k) zj[k] = s_zs[j * kMaxD + k];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float r2 = 0.f;
#pragma unroll
        for (int k = 0; k < KD; ++k) {
          const float df = __fsub_rn(xs[r][k], zj[k]);
          r2 = fmaf(df, df, r2);
        }
        knm[r][j] = __fmul_rn(var, expf(__fmul_rn(-0.5f, r2)));
      }
    } else {
#pragma unroll
      for (int r = 0; r < RB; ++r) knm[r][j] = 0.f;
    }
    const float cj = s_c[j];
#pragma unroll
    for (int r = 0; r < RB; ++r) mu[r] = fmaf(knm[r][j], cj, mu[r]);
  }

  float qd[RB], sd[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) qd[r] = sd[r] = 0.f;
  // rows of W and U up to m: unrolled where MMAX = m (m <= 8), else by 4
  // (each row's sum over j is a dependent chain: rows side by side hide it)
  constexpr int kUnrollRows = MMAX <= 8 ? MMAX : 4;
#pragma unroll kUnrollRows
  for (int i = 0; i < (MMAX <= 8 ? MMAX : m); ++i) {
    float lk[RB], su[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) lk[r] = su[r] = 0.f;
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      const float wij = s_w[i * LD + j];
      const float uij = s_u[i * LD + j];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        lk[r] = fmaf(wij, knm[r][j], lk[r]);
        su[r] = fmaf(uij, knm[r][j], su[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      qd[r] = fmaf(lk[r], lk[r], qd[r]);
      sd[r] = fmaf(su[r], su[r], sd[r]);
    }
  }

  float* meanp = mean + (size_t)p * N;
  float* fvarp = fvar + (size_t)p * N;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (valid(r)) {
      meanp[tile + r * T + tid] = mu[r];
      fvarp[tile + r * T + tid] = __fadd_rn(__fsub_rn(var, qd[r]), sd[r]);
    }
  }
}

template <int MMAX, int KD, int RB>
cudaError_t launch_tiles(const float* hx, const float* z, const float* log_l,
                         const float* log_var, const float* w, const float* u, const float* c,
                         float* mean, float* fvar, int P, int S, int Q, int m, int d,
                         cudaStream_t stream) {
  // tile: enough rows that a block covers a cell's S*Q rows where it can,
  // enough blocks (kMinBlocks) that the card fills when P is small, but no
  // tile under one warp's worth of rows (32 threads x RB), and no smaller
  // tile than the cap where a block stages two m x m matrices of m >= 17
  constexpr long long kCap = (long long)kMaxThreads * RB;
  const long long N = (long long)S * Q;
  long long blocks = (N + kCap - 1) / kCap;
  long long spread = (kMinBlocks + P - 1) / P;
  const long long floor_rows = MMAX >= 32 ? kCap : 32 * RB;
  const long long most = (N + floor_rows - 1) / floor_rows;
  if (spread > most) spread = most;
  if (blocks < spread) blocks = spread;
  const long long R = (N + blocks - 1) / blocks;
  blocks = (N + R - 1) / R;  // no empty tiles
  const int threads = (int)(((R + RB - 1) / RB + 31) / 32 * 32);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, P);
  predict_kernel<MMAX, KD, RB><<<grid, threads, 0, stream>>>(
      hx, z, log_l, log_var, w, u, c, mean, fvar, N, (int)R, m, d);
  return cudaSuccess;
}

// One row per thread while that fits the card in one wave (the launch is
// bound by latency, and the shortest thread wins); RB rows per thread past
// it (bound by issue: each value read from shared memory serves RB rows).
template <int MMAX, int KD>
cudaError_t launch(const float* hx, const float* z, const float* log_l, const float* log_var,
                   const float* w, const float* u, const float* c, float* mean, float* fvar,
                   int P, int S, int Q, int m, int d, cudaStream_t stream) {
  constexpr int RB = rows_per_thread<MMAX>();
  if ((long long)P * S * Q <= kOneWaveRows) {
    return launch_tiles<MMAX, KD, 1>(hx, z, log_l, log_var, w, u, c, mean, fvar, P, S, Q, m, d,
                                     stream);
  }
  return launch_tiles<MMAX, KD, RB>(hx, z, log_l, log_var, w, u, c, mean, fvar, P, S, Q, m, d,
                                    stream);
}

// The wide body (m >= 65, or d > 4; m and d runtime): grid (row tiles,
// P), 32 TR threads. A block runs the loop of kernel_common.cuh (wide_run)
// over every column tile of W and U: each thread holds 8 rows x 4 columns
// of knm W^T and of knm U^T. The mean folds over tile 0's knm chunks,
// thread r summing row r's knm_j c_j in j order; thread r then adds row
// r's tile squares in tile order. Per row the sequence is fixed by m and d
// alone.
template <int KD>
__global__ void __launch_bounds__(256, 2) predict_wide_kernel(
    const float* __restrict__ hx, const float* __restrict__ z, const float* __restrict__ log_l,
    const float* __restrict__ log_var, const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ c, float* __restrict__ mean, float* __restrict__ fvar,
    long long N, int m, int d) {
  constexpr int MR = 8;
  extern __shared__ __align__(16) float smem[];
  const int BM = MR * (blockDim.x / kWideTC), nt = wide_tiles(m);
  const int tid = threadIdx.x, p = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * BM;
  const int n = (int)min((long long)BM, N - row0);
  const float* cp = c + (size_t)p * m;
  const float var = expf(log_var[p]);
  float mu = 0.f;  // thread r < BM: row r's mean
  const float* s_part = wide_run<2, KD, MR>(
      smem, WideTiles{nt, 1, 0}, n, hx + ((size_t)p * N + row0) * d, z + (size_t)p * m * d,
      log_l + (size_t)p * d, var, w + (size_t)p * m * m, u + (size_t)p * m * m, m, d,
      [&](WideStep, int, int, const auto&) {},
      [&](WideStep s, const float* chunk) {  // tile 0's knm chunks fold the mean
        if (s.k == 0 && tid < BM) {
          const int j0 = kWideBK * s.c;
#pragma unroll
          for (int jj = 0; jj < kWideBK; ++jj)
            if (j0 + jj < m) mu = fmaf(chunk[jj * BM + tid], cp[j0 + jj], mu);
        }
      },
      [&](int, const auto&) {});

  __syncthreads();  // the last tile's partials
  if (tid < n) {
    float qd = 0.f, sd = 0.f;
    for (int t = 0; t < nt; ++t) {
      qd = __fadd_rn(qd, s_part[(t * 2) * BM + tid]);
      sd = __fadd_rn(sd, s_part[(t * 2 + 1) * BM + tid]);
    }
    mean[(size_t)p * N + row0 + tid] = mu;
    fvar[(size_t)p * N + row0 + tid] = __fadd_rn(__fsub_rn(var, qd), sd);
  }
}

bool g_wide_opted[2][kMaxDevices];  // [KD > 0]
int g_sms[kMaxDevices];

template <int KD>
cudaError_t launch_wide_kd(const float* hx, const float* z, const float* log_l,
                           const float* log_var, const float* w, const float* u, const float* c,
                           float* mean, float* fvar, int P, long long N, int m, int d, int device,
                           cudaStream_t stream) {
  const cudaError_t err = wide_opt_in(g_wide_opted[KD > 0], g_sms, device, predict_wide_kernel<KD>);
  if (err != cudaSuccess) return err;
  const WidePlan plan = wide_plan<2>(P, N, m, g_sms[device]);
  if (plan.tiles > INT_MAX) return cudaErrorInvalidValue;
  const int smem = 4 * wide_run_floats<2, 8>(m, KD, 8 * plan.tr);
  predict_wide_kernel<KD><<<dim3((unsigned)plan.tiles, P), kWideTC * plan.tr, smem, stream>>>(
      hx, z, log_l, log_var, w, u, c, mean, fvar, N, m, d);
  return cudaSuccess;
}

cudaError_t launch_wide(const float* hx, const float* z, const float* log_l, const float* log_var,
                        const float* w, const float* u, const float* c, float* mean, float* fvar,
                        int P, int S, int Q, int m, int d, int device, cudaStream_t stream) {
  const long long N = (long long)S * Q;
  return d == 2 ? launch_wide_kd<2>(hx, z, log_l, log_var, w, u, c, mean, fvar, P, N, m, d,
                                    device, stream)
                : launch_wide_kd<0>(hx, z, log_l, log_var, w, u, c, mean, fvar, P, N, m, d,
                                    device, stream);
}

}  // namespace

// Plain C entry (loaded with ctypes). Every pointer is a CUDA device
// pointer to contiguous float32 data on device `device`; `stream` is the
// caller's cudaStream_t. Launches asynchronously and returns
// cudaGetLastError() (0 on success); never synchronizes, never allocates.
extern "C" int psvgp_posterior_predict(
    const void* hx, const void* z, const void* log_l, const void* log_var,
    const void* w, const void* u, const void* c, void* mean, void* fvar,
    int P, int S, int Q, int m, int d, int device, void* stream) {
  if (P < 1 || S < 1 || Q < 1 || m < 1 || m > kWideMaxM || d < 1 || S > 65535 || P > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* args = static_cast<const float*>(hx);
  const auto* zf = static_cast<const float*>(z);
  const auto* lf = static_cast<const float*>(log_l);
  const auto* vf = static_cast<const float*>(log_var);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* cf = static_cast<const float*>(c);
  auto* mf = static_cast<float*>(mean);
  auto* ff = static_cast<float*>(fvar);
  auto st = static_cast<cudaStream_t>(stream);
  // the instance is chosen by m and d alone
  static_assert(kPredictWideMinM <= 65, "the narrow instances end at MMAX = 64");
  if (m >= kPredictWideMinM || d > kMaxD) {
    err = launch_wide(args, zf, lf, vf, wf, uf, cf, mf, ff, P, S, Q, m, d, device, st);
  } else {
    err = with_mmax<64>(m, [&](auto mmax) {
      constexpr int M = decltype(mmax)::value;
      return d == 2 ? launch<M, 2>(args, zf, lf, vf, wf, uf, cf, mf, ff, P, S, Q, m, d, st)
                    : launch<M, kMaxD>(args, zf, lf, vf, wf, uf, cf, mf, ff, P, S, Q, m, d, st);
    });
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
