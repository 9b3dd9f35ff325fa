// Fused cached-posterior prediction for Hopper (sm_90a), fp32 throughout.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/predict.py:
//   posterior_predict_slots_pallas  (the "fused" serving lane: S halo slots
//                                    of one model in one launch), and
//   posterior_predict_pallas        (the "pallas" lane: one query block).
// Both are this one __global__ body: the slots entry runs it with a cell
// axis, grid (ceil(Q/128), S, P), so ONE launch evaluates every cell's
// model on its own 9 halo blocks; the single-block entry is P = S = 1.
//
// Per query row (one thread), with cell p's factors staged in shared
// memory once per block:
//   knm_j = var * exp(-0.5 * sum_k (x_k/l_k - z_jk/l_k)^2)   explicit difference
//   mean  = sum_j knm_j c_j
//   fvar  = var - ||W knm||^2 + ||U knm||^2                  un-clamped
// W = Lmm^{-1}, U the S-factor, c the projected mean (repro_torch.core.
// posterior). knm never leaves registers; rows are independent (the
// row-independence contract two-level routing relies on), so a block may
// mix owner, spill and padded rows and a row's result does not depend on Q.
//
// What bounds it: at the main path's shapes (P = 400, S = 9, q_max = 32,
// m = 5, d = 2) each row reads 8 B and writes 8 B and does ~180 flop, and
// a request is one launch of ~115k rows: memory- and launch-bound, far
// below the FP32 rate. The design keeps the factor traffic at one staging
// per (block, cell) and the per-row traffic at the query in, two floats
// out. Making it fast (several rows per thread, vector loads, a persistent
// grid) is later work.
//
// Numerics: FFMA loops (no tensor cores, no TF32), expf (not __expf), and
// the build uses no --use_fast_math. Any m in [1, 64] (template bound
// MMAX in {8, 16, 32, 64}; padded columns of W/U/c are staged as zeros so
// they are inert), any Q >= 1, d in [1, 4]; no padding contract for the
// caller.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 4;

template <int MMAX>
__global__ void __launch_bounds__(kThreads) predict_kernel(
    const float* __restrict__ hx,       // (P, S, Q, d)
    const float* __restrict__ z,        // (P, m, d)
    const float* __restrict__ log_l,    // (P, d)
    const float* __restrict__ log_var,  // (P,)
    const float* __restrict__ w,        // (P, m, m)
    const float* __restrict__ u,        // (P, m, m)
    const float* __restrict__ c,        // (P, m)
    float* __restrict__ mean,           // (P, S, Q)
    float* __restrict__ fvar,           // (P, S, Q)
    int S, int Q, int m, int d) {
  __shared__ float s_w[MMAX * MMAX];
  __shared__ float s_u[MMAX * MMAX];
  __shared__ float s_zs[MMAX * kMaxD];  // z / l, zero-padded
  __shared__ float s_c[MMAX];
  __shared__ float s_inv_l[kMaxD];
  __shared__ float s_var;

  const int p = blockIdx.z;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;

  // stage cell p's factors (zero outside the true m x m / d block)
  const float* wp = w + (size_t)p * m * m;
  const float* up = u + (size_t)p * m * m;
  if (tid < kMaxD) s_inv_l[tid] = tid < d ? expf(-log_l[(size_t)p * d + tid]) : 0.f;
  if (tid == 0) s_var = expf(log_var[p]);
  for (int i = tid; i < MMAX * MMAX; i += kThreads) {
    const int r = i / MMAX, col = i % MMAX;
    const bool in = r < m && col < m;
    s_w[i] = in ? wp[r * m + col] : 0.f;
    s_u[i] = in ? up[r * m + col] : 0.f;
  }
  for (int i = tid; i < MMAX; i += kThreads) s_c[i] = i < m ? c[(size_t)p * m + i] : 0.f;
  __syncthreads();
  for (int i = tid; i < MMAX * kMaxD; i += kThreads) {
    const int j = i / kMaxD, k = i % kMaxD;
    s_zs[i] = (j < m && k < d) ? z[((size_t)p * m + j) * d + k] * s_inv_l[k] : 0.f;
  }
  __syncthreads();

  const int q = blockIdx.x * kThreads + tid;
  if (q >= Q) return;  // ragged edge of Q; no barrier follows
  const size_t row = ((size_t)p * S + s) * Q + q;

  float xs[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) xs[k] = k < d ? hx[row * d + k] * s_inv_l[k] : 0.f;

  const float var = s_var;
  float knm[MMAX];
  float mu = 0.f;
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
    }
    knm[j] = kj;
    mu = fmaf(kj, s_c[j], mu);
  }

  float qd = 0.f, sd = 0.f;
  for (int i = 0; i < m; ++i) {
    float lk = 0.f, su = 0.f;
#pragma unroll
    for (int j = 0; j < MMAX; ++j) {
      lk = fmaf(s_w[i * MMAX + j], knm[j], lk);
      su = fmaf(s_u[i * MMAX + j], knm[j], su);
    }
    qd = fmaf(lk, lk, qd);
    sd = fmaf(su, su, sd);
  }
  mean[row] = mu;
  fvar[row] = (var - qd) + sd;
}

template <int MMAX>
void launch(const float* hx, const float* z, const float* log_l, const float* log_var,
            const float* w, const float* u, const float* c, float* mean, float* fvar,
            int P, int S, int Q, int m, int d, cudaStream_t stream) {
  const dim3 grid((Q + kThreads - 1) / kThreads, S, P);
  predict_kernel<MMAX><<<grid, kThreads, 0, stream>>>(
      hx, z, log_l, log_var, w, u, c, mean, fvar, S, Q, m, d);
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
  if (P < 1 || S < 1 || Q < 1 || m < 1 || m > 64 || d < 1 || d > kMaxD ||
      S > 65535 || P > 65535) {
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
  if (m <= 8) {
    launch<8>(args, zf, lf, vf, wf, uf, cf, mf, ff, P, S, Q, m, d, st);
  } else if (m <= 16) {
    launch<16>(args, zf, lf, vf, wf, uf, cf, mf, ff, P, S, Q, m, d, st);
  } else if (m <= 32) {
    launch<32>(args, zf, lf, vf, wf, uf, cf, mf, ff, P, S, Q, m, d, st);
  } else {
    launch<64>(args, zf, lf, vf, wf, uf, cf, mf, ff, P, S, Q, m, d, st);
  }
  return (int)cudaGetLastError();
}
