// ELBO projection and RBF cross-covariance for Hopper (sm_90a), fp32 throughout.
//
// Replaces two Pallas TPU kernels:
//   svgp_projection_pallas  src/repro/kernels/svgp_proj.py:47 -- the ELBO's
//                           O(B m^2) hot path (entry psvgp_svgp_projection);
//   rbf_cross_cov_pallas    src/repro/kernels/rbf.py:46 -- K(X, Z) alone
//                           (entry psvgp_rbf_cross_cov).
// Both are this one __global__ body, with a cell axis: grid (ceil(B/128), P),
// 128 threads, one mini-batch row per thread, so ONE launch covers every
// cell's B rows of a training step (the JAX package vmaps the Pallas kernel
// over the cells instead). Per row, with cell p's z/l, 1/l, sigma^2 and W
// staged in shared memory once per block:
//   knm_j  = sigma^2 * exp(-0.5 * sum_k (x_k/l_k - z_jk/l_k)^2)   explicit difference
//   lk_t_i = sum_j W_ij knm_j        (W = Lmm^{-1}, lower triangular)
//   q_diag = sum_i lk_t_i^2
// The rbf entry stops after knm. knm never needs to be read back: the
// projection keeps it in registers and writes it once (the JAX signature
// returns it; the ELBO drops it).
//
// What bounds it: at the training step's shape (P = 400, B = 32, m = 5,
// d = 2) a launch reads ~0.16 MB, writes ~0.56 MB and does ~1.4 MFLOP:
// bytes-bound at ~0.2 us, and far below that in practice bound by the
// launch and by one short wave of 400 blocks of 128 threads of which only
// 32 work. The design keeps the cell's factors at one staging per block
// and the per-row traffic at x in, the three outputs out. Making it fast
// (several cells per block, rows of one cell across a warp) is later work.
//
// Numerics: FFMA loops (no tensor cores, no TF32), expf (not __expf), no
// --use_fast_math. Any m in [1, 64] (template bound MMAX in {8, 16, 32,
// 64}; W's padded entries are staged as zeros, so the padded columns of
// knm are inert), any B >= 1, d in [1, 4]; no padding contract.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 4;

template <int MMAX, bool kProject>
__global__ void __launch_bounds__(kThreads) projection_kernel(
    const float* __restrict__ x,        // (P, B, d)
    const float* __restrict__ z,        // (P, m, d)
    const float* __restrict__ log_l,    // (P, d)
    const float* __restrict__ log_var,  // (P,)
    const float* __restrict__ w,        // (P, m, m); unused without kProject
    float* __restrict__ knm,            // (P, B, m)
    float* __restrict__ lk_t,           // (P, B, m); unused without kProject
    float* __restrict__ q_diag,         // (P, B);    unused without kProject
    int B, int m, int d) {
  __shared__ float s_w[kProject ? MMAX * MMAX : 1];
  __shared__ float s_zs[MMAX * kMaxD];  // z / l, zero-padded
  __shared__ float s_inv_l[kMaxD];
  __shared__ float s_var;

  const int p = blockIdx.y;
  const int tid = threadIdx.x;

  // stage cell p's factors (zero outside the true m x m / d block)
  if (tid < kMaxD) s_inv_l[tid] = tid < d ? expf(-log_l[(size_t)p * d + tid]) : 0.f;
  if (tid == 0) s_var = expf(log_var[p]);
  if (kProject) {
    const float* wp = w + (size_t)p * m * m;
    for (int i = tid; i < MMAX * MMAX; i += kThreads) {
      const int r = i / MMAX, col = i % MMAX;
      s_w[i] = (r < m && col < m) ? wp[r * m + col] : 0.f;
    }
  }
  __syncthreads();
  for (int i = tid; i < MMAX * kMaxD; i += kThreads) {
    const int j = i / kMaxD, k = i % kMaxD;
    s_zs[i] = (j < m && k < d) ? z[((size_t)p * m + j) * d + k] * s_inv_l[k] : 0.f;
  }
  __syncthreads();

  const int b = blockIdx.x * kThreads + tid;
  if (b >= B) return;  // ragged edge of B; no barrier follows
  const size_t row = (size_t)p * B + b;

  float xs[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) xs[k] = k < d ? x[row * d + k] * s_inv_l[k] : 0.f;

  const float var = s_var;
  float* knm_row = knm + row * m;
  float kn[MMAX];
#pragma unroll
  for (int j = 0; j < MMAX; ++j) {
    float kj = 0.f;
    if (j < m) {
      float r2 = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxD; ++k) {
        const float df = xs[k] - s_zs[j * kMaxD + k];
        r2 = fmaf(df, df, r2);
      }
      kj = var * expf(-0.5f * r2);
      knm_row[j] = kj;
    }
    kn[j] = kj;
  }
  if (!kProject) return;

  float* lk_row = lk_t + row * m;
  float qd = 0.f;
  for (int i = 0; i < m; ++i) {
    float lk = 0.f;
#pragma unroll
    for (int j = 0; j < MMAX; ++j) lk = fmaf(s_w[i * MMAX + j], kn[j], lk);
    lk_row[i] = lk;
    qd = fmaf(lk, lk, qd);
  }
  q_diag[row] = qd;
}

template <bool kProject>
void launch(const float* x, const float* z, const float* log_l, const float* log_var,
            const float* w, float* knm, float* lk_t, float* q_diag,
            int P, int B, int m, int d, cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads, P);
  if (m <= 8) {
    projection_kernel<8, kProject><<<grid, kThreads, 0, stream>>>(
        x, z, log_l, log_var, w, knm, lk_t, q_diag, B, m, d);
  } else if (m <= 16) {
    projection_kernel<16, kProject><<<grid, kThreads, 0, stream>>>(
        x, z, log_l, log_var, w, knm, lk_t, q_diag, B, m, d);
  } else if (m <= 32) {
    projection_kernel<32, kProject><<<grid, kThreads, 0, stream>>>(
        x, z, log_l, log_var, w, knm, lk_t, q_diag, B, m, d);
  } else {
    projection_kernel<64, kProject><<<grid, kThreads, 0, stream>>>(
        x, z, log_l, log_var, w, knm, lk_t, q_diag, B, m, d);
  }
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
  launch<true>(static_cast<const float*>(x), static_cast<const float*>(z),
               static_cast<const float*>(log_l), static_cast<const float*>(log_var),
               static_cast<const float*>(w), static_cast<float*>(knm),
               static_cast<float*>(lk_t), static_cast<float*>(q_diag), P, B, m, d,
               static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

extern "C" int psvgp_rbf_cross_cov(
    const void* x, const void* z, const void* log_l, const void* log_var, void* knm,
    int P, int B, int m, int d, int device, void* stream) {
  const int err = check_args(P, B, m, d, device);
  if (err != 0) return err;
  launch<false>(static_cast<const float*>(x), static_cast<const float*>(z),
                static_cast<const float*>(log_l), static_cast<const float*>(log_var),
                nullptr, static_cast<float*>(knm), nullptr, nullptr, P, B, m, d,
                static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
