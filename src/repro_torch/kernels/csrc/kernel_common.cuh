// Helpers shared by the port's kernels (predict.cu, svgp_proj.cu): the
// template bounds, cp.async copies into shared memory, and the staging of
// per-cell m x m factors.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace psvgp {

constexpr int kMaxD = 4;  // input dims d in [1, 4]

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

// Call f with the template bound MMAX for m: m itself up to 8 (no padded
// columns at the paper's m = 5), then 16, 32, 64.
template <class F>
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
  if (m <= 16) return f(std::integral_constant<int, 16>{});
  if (m <= 32) return f(std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, 64>{});
}

}  // namespace psvgp
