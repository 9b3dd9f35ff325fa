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
// The wide body: m from k*WideMinM (below) to kWideMaxM, or any m
// with d > kMaxD; m and d are runtime values, so each source adds one
// instance per kernel. A block takes
// R rows of one cell (128 threads at R = 32). It computes knm (R x m) into
// dynamic shared memory, then runs knm W^T (and knm U^T) as an FFMA tile
// loop: W (and U) stream through shared memory in TI x TJ tiles by cp.async,
// double-buffered, and each thread holds a 4-row x 4-column micro-tile of
// accumulators per matrix (rows rg + (R/4) rr, columns ig + 16 ii of the
// TI-column chunk). After each chunk the accumulators go to a shared slab
// and every row's squares fold in a fixed column order (4 threads a row,
// columns = q mod 4, partials combined in a fixed order): no atomics, and a
// row's bits depend on its own x and its cell's factors only.
// ---------------------------------------------------------------------------

// The least m each source's wide body takes; below it, the narrow bodies.
// Measured on the H100 (PERF.md): the projection's wide body beats the
// narrow one's padded MMAX = 32/64 instances (an earlier commit's) at m = 25,
// 33 and 64, so its narrow body ends at m = 16; the prediction's wide body
// loses to them at m = 25 and 64, so its narrow body keeps m <= 64 (timed
// with scripts/kernel_ab.py --against a copy with kPredictWideMinM = 17).
constexpr int kPredictWideMinM = 65;
constexpr int kProjectionWideMinM = 17;

constexpr int kWideMaxM = 2048;
constexpr int kWideTI = 64;    // columns i of one chunk of knm W^T
constexpr int kWideTJ = 32;    // depth j of one W / U tile
// tile row stride: 16 consecutive rows fall on distinct 4-bank groups
constexpr int kWideLDW = kWideTJ + 4;
// slab row stride (= 4 mod 32): 8 rows x 4 columns conflict-free
constexpr int kWideLDO = kWideTI + 4;
constexpr int kWideInv = 64;   // 1/l staged for the first 64 dims; past them, recomputed
constexpr int kWideMaxSmem = 232448;  // bytes of shared memory a block may opt in to (H100)

// rows of a block and the knm tile's row stride (= 4 mod 32, a multiple of 4)
__host__ __device__ constexpr int wide_rows(int m) { return m <= 1024 ? 32 : 16; }
__host__ __device__ constexpr int wide_ld(int m) { return (m + 31) / 32 * 32 + 4; }

// floats of dynamic shared memory of a block over NMAT matrices: the knm
// tile, two buffers of NMAT tiles, NMAT slabs, 1/l
__host__ __device__ constexpr int wide_smem_floats(int m, int nmat) {
  return wide_rows(m) * wide_ld(m) + 2 * nmat * kWideTI * kWideLDW +
         nmat * wide_rows(m) * kWideLDO + kWideInv;
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

// Start the copy of the tile rows [ic, ic + TI) x columns [jt, jt + TJ) of
// NMAT m x m matrices (a, then b) into s (NMAT consecutive TI x LDW tiles),
// zeros outside the matrix. 16-byte copies where `vec` (m a multiple of 4,
// the matrices 16-byte aligned), else 4-byte ones.
template <int NMAT>
__device__ __forceinline__ void wide_load_tile(float* s, const float* a, const float* b, int m,
                                               int ic, int jt, bool vec) {
  const int tid = threadIdx.x, T = blockDim.x;
  if (vec) {
    constexpr int C4 = kWideTJ / 4;
    for (int e = tid; e < NMAT * kWideTI * C4; e += T) {
      const int mat = e / (kWideTI * C4), row = e / C4 % kWideTI, c4 = e % C4;
      const int i = ic + row, j = jt + 4 * c4;
      const float* base = mat == 0 ? a : b;
      const bool ok = i < m && j < m;
      cp_async16_zfill(s + (mat * kWideTI + row) * kWideLDW + 4 * c4,
                       ok ? base + (size_t)i * m + j : base, ok);
    }
  } else {
    for (int e = tid; e < NMAT * kWideTI * kWideTJ; e += T) {
      const int mat = e / (kWideTI * kWideTJ), row = e / kWideTJ % kWideTI, col = e % kWideTJ;
      const int i = ic + row, j = jt + col;
      const float* base = mat == 0 ? a : b;
      const bool ok = i < m && j < m;
      cp_async4_zfill(s + (mat * kWideTI + row) * kWideLDW + col,
                      ok ? base + (size_t)i * m + j : base, ok);
    }
  }
}

// Stage 1/l of the first kWideInv dims (each thread then reads them after a
// barrier); the rest are recomputed where used, the same bits.
__device__ __forceinline__ void wide_stage_inv(float* s_inv, const float* log_l, int d) {
  for (int k = threadIdx.x; k < d && k < kWideInv; k += blockDim.x) s_inv[k] = expf(-log_l[k]);
}

// knm of the block's rows into s_knm (R x ld): thread (r = tid / 4, q = tid
// % 4) computes row r's columns j = q, q + 4, ... up to the next multiple of
// 32 past m, zeros past m and for a row with no x (xrow null). Per element
// the sequence of the narrow bodies: x/l and z/l by __fmul_rn, the explicit
// difference, r2 by fmaf in k order, sigma^2 exp(-r2/2). Returns the
// thread's partial sum_j knm_j c_j over its columns (0 without c).
__device__ __forceinline__ float wide_knm(float* s_knm, int ld, const float* xrow,
                                          const float* zc, const float* log_l,
                                          const float* s_inv, float var, const float* c, int m,
                                          int d) {
  const int q = threadIdx.x & 3, r = threadIdx.x >> 2;
  float* out = s_knm + r * ld;
  const int mp = (m + 31) / 32 * 32;
  float mu = 0.f;
  for (int j = q; j < mp; j += 4) {
    float kj = 0.f;
    if (xrow != nullptr && j < m) {
      float r2 = 0.f;
      for (int k = 0; k < d; ++k) {
        const float il = k < kWideInv ? s_inv[k] : expf(-log_l[k]);
        const float df = __fsub_rn(__fmul_rn(xrow[k], il), __fmul_rn(zc[(size_t)j * d + k], il));
        r2 = fmaf(df, df, r2);
      }
      kj = __fmul_rn(var, expf(__fmul_rn(-0.5f, r2)));
      if (c != nullptr) mu = fmaf(kj, c[j], mu);
    }
    out[j] = kj;
  }
  return mu;
}

// One tile's products: acc[mat][rr][ii] += sum_{j in tile} T_mat[i][j] knm[r][j]
// in j order, for the thread's rows r = rg + RG rr and columns i = ig + 16 ii.
// The tile's 8 steps of 4 j are unrolled 8 for W and U together (prediction)
// and 2 for W alone (projection): the faster of 2 and 8 for each on the H100
// (PERF.md).
template <int NMAT>
__device__ __forceinline__ void wide_fma_tile(float (&acc)[NMAT][4][4], const float* s_knm,
                                              int ld, int jt, const float* s_t, int rg, int RG,
                                              int ig) {
  constexpr int kUnroll = NMAT == 2 ? 8 : 2;
#pragma unroll kUnroll
  for (int jj = 0; jj < kWideTJ; jj += 4) {
    float4 kv[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      kv[rr] = *reinterpret_cast<const float4*>(s_knm + (rg + RG * rr) * ld + jt + jj);
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float4 wv = *reinterpret_cast<const float4*>(
            s_t + (mat * kWideTI + ig + 16 * ii) * kWideLDW + jj);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float a = acc[mat][rr][ii];
          a = fmaf(wv.x, kv[rr].x, a);
          a = fmaf(wv.y, kv[rr].y, a);
          a = fmaf(wv.z, kv[rr].z, a);
          a = fmaf(wv.w, kv[rr].w, a);
          acc[mat][rr][ii] = a;
        }
      }
    }
  }
}

// The sum over the 4 threads of a row (lanes 4r .. 4r+3), in a fixed order:
// (q0 + q1) + (q2 + q3), the same in every lane.
__device__ __forceinline__ float quad_sum(float v) {
  const int base = (threadIdx.x & 31) & ~3;
  const float v0 = __shfl_sync(0xffffffffu, v, base);
  const float v1 = __shfl_sync(0xffffffffu, v, base + 1);
  const float v2 = __shfl_sync(0xffffffffu, v, base + 2);
  const float v3 = __shfl_sync(0xffffffffu, v, base + 3);
  return __fadd_rn(__fadd_rn(v0, v1), __fadd_rn(v2, v3));
}

// Opt a wide kernel in to the most dynamic shared memory a block may have,
// once per device (`done` is the kernel's own flags; never while a stream is
// being captured, since the first launch on a device does it).
constexpr int kMaxDevices = 64;

template <class K>
cudaError_t wide_opt_in(K kernel, bool (&done)[kMaxDevices], int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideMaxSmem);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

}  // namespace psvgp
