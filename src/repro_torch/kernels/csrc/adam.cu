// Adam update of a whole parameter tree for Hopper (sm_90a), fp32.
//
// Replaces no Pallas kernel: the JAX package's Adam (src/repro/optim/adam.py)
// is plain jnp that XLA fuses into the training step. The port's plain
// formula (optim/adam.py) is ~90 elementwise launches a PSVGP step (14 for
// each of its 6 leaves, 6 for the counter and the bias corrections), and
// the captured step then copied the 20 leaves of the new state into its
// buffers. This is ONE launch over every leaf (entry psvgp_adam_update): it
// writes the new params, both moments and Adam's step counter to the
// destination given, which may be the input itself.
//
// Per element, optim/adam.py's formula in its operation order, rounded
// once wherever torch's CUDA kernels round once (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn: nothing contracted), so the result is
// bitwise the plain formula's on the card:
//   mu = b1 m + (1 - b1) g
//   nu = b2 v + (1 - b2) (g g)
//   p' = p - (lr (mu / bc1)) / (sqrt(nu / bc2) + eps)
// with bc_i = 1 - powf(b_i, t), t = float(step + 1) (torch's pow and int64
// to float32 conversion), and each constant the float32 that torch rounds
// the Python double to.
//
// What bounds it: bytes. An element reads p, g, m, v and writes p, mu, nu
// (28 B): 7.9 MB at 6,400 cells x 44 parameters, 2.4 us at 3.35 TB/s; at
// 400 cells (0.5 MB) the launch and one round trip to memory.
//
// Design: the leaves' pointers and sizes go by value in the kernel's
// parameters (at most kMaxLeaves), so a CUDA graph captures them with the
// launch. The leaves laid end to end are cut into contiguous ranges of
// kChunk elements, one a block; thread i of a block takes elements i,
// i + kThreads, ... of its range (consecutive threads on consecutive
// addresses), each in the leaf a scan of the leaves' starts finds, and
// loads all four inputs of its kUnroll elements (16 loads in flight)
// while the block's first thread reads Adam's counter; then it computes
// and stores them. Every element is read before the thread that owns it
// writes it, so a destination may be the input itself.
//
// The counter: every block reads Adam's counter, then takes a ticket;
// the block whose ticket is last (so after every block has read the
// counter) writes step + 1, so a counter updated in place is never read
// after it moved. The ticket's atomic runs while the block computes. It
// resets itself (atomicInc wraps at the grid size): launches on one device
// must not overlap, as stream-ordered ones do not.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxLeaves = 32;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * kUnroll;  // elements a block

struct Leaf {
  const float *p, *g, *m, *v;
  float *p_out, *m_out, *v_out;
};

struct Args {
  Leaf leaf[kMaxLeaves];
  long long start[kMaxLeaves + 1];  // leaf l holds elements [start[l], start[l + 1]) of the whole
  int leaves;
  float b1, omb1, b2, omb2, lr, eps;  // omb_i = 1 - b_i, rounded as torch rounds it
  const long long* step_in;           // Adam's counter on the device, or null: step_host
  long long* step_out;                // where step + 1 goes, or null (a host counter)
  long long step_host;
};

__device__ unsigned int g_arrivals;  // blocks of the running launch that have read the counter

__global__ void __launch_bounds__(kThreads) adam_update_kernel(const __grid_constant__ Args a) {
  __shared__ long long s_step;
  if (threadIdx.x == 0) s_step = a.step_in != nullptr ? *a.step_in : a.step_host;
  // this thread's elements of the block's range, loaded while the counter is read
  const long long lo = static_cast<long long>(blockIdx.x) * kChunk, total = a.start[a.leaves];
  int leaf[kUnroll];
  long long off[kUnroll];
  float p[kUnroll], g[kUnroll], m[kUnroll], v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = lo + threadIdx.x + u * kThreads;
    int l = 0;
    while (l + 1 < a.leaves && e >= a.start[l + 1]) ++l;
    leaf[u] = e < total ? l : -1;
    off[u] = e - a.start[l];
    if (leaf[u] >= 0) {
      const Leaf& f = a.leaf[l];
      p[u] = f.p[off[u]];
      g[u] = f.g[off[u]];
      m[u] = f.m[off[u]];
      v[u] = f.v[off[u]];
    }
  }
  __syncthreads();  // s_step: the block has read the counter
  unsigned ticket = 0;
  if (threadIdx.x == 0) ticket = atomicInc(&g_arrivals, gridDim.x - 1);  // in flight meanwhile
  const float t = static_cast<float>(s_step + 1);
  const float bc1 = __fsub_rn(1.0f, powf(a.b1, t));
  const float bc2 = __fsub_rn(1.0f, powf(a.b2, t));
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (leaf[u] < 0) continue;
    const Leaf& f = a.leaf[leaf[u]];
    const float mu = __fadd_rn(__fmul_rn(a.b1, m[u]), __fmul_rn(a.omb1, g[u]));
    const float nu = __fadd_rn(__fmul_rn(a.b2, v[u]), __fmul_rn(a.omb2, __fmul_rn(g[u], g[u])));
    const float num = __fmul_rn(a.lr, __fdiv_rn(mu, bc1));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), a.eps);
    f.p_out[off[u]] = __fsub_rn(p[u], __fdiv_rn(num, den));
    f.m_out[off[u]] = mu;
    f.v_out[off[u]] = nu;
  }
  if (threadIdx.x == 0 && ticket == gridDim.x - 1 && a.step_out != nullptr) {
    *a.step_out = s_step + 1;  // every block has read the counter
  }
}

}  // namespace

// Plain C entry (loaded with ctypes). `ptrs` (host) holds 7 device
// pointers a leaf, in the order p, g, m, v, p_out, m_out, v_out, each to
// contiguous float32 data of `sizes[l]` elements on device `device`; an
// output may be its own input, and otherwise overlaps no input. The
// counter is an int64 device pointer or null (then `step_host` is read);
// `step_out` an int64 device pointer (`step_in` allowed) or null (nothing
// written).
// Launches asynchronously on `stream` and returns cudaGetLastError() (0 on
// success); never synchronizes, never allocates.
extern "C" int psvgp_adam_update(const void* const* ptrs, const long long* sizes, int leaves,
                                 float b1, float omb1, float b2, float omb2, float lr, float eps,
                                 const void* step_in, void* step_out, long long step_host,
                                 int device, void* stream) {
  if (leaves < 0 || leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Args a = {};
  for (int l = 0; l < leaves; ++l) {
    const void* const* q = ptrs + 7 * l;
    a.leaf[l] = Leaf{static_cast<const float*>(q[0]), static_cast<const float*>(q[1]),
                 static_cast<const float*>(q[2]), static_cast<const float*>(q[3]),
                 static_cast<float*>(const_cast<void*>(q[4])),
                 static_cast<float*>(const_cast<void*>(q[5])),
                 static_cast<float*>(const_cast<void*>(q[6]))};
    if (sizes[l] < 0) return (int)cudaErrorInvalidValue;
    a.start[l + 1] = a.start[l] + sizes[l];
  }
  a.leaves = leaves;
  a.b1 = b1;
  a.omb1 = omb1;
  a.b2 = b2;
  a.omb2 = omb2;
  a.lr = lr;
  a.eps = eps;
  a.step_in = static_cast<const long long*>(step_in);
  a.step_out = static_cast<long long*>(step_out);
  a.step_host = step_host;
  const long long blocks = a.start[leaves] > 0 ? (a.start[leaves] + kChunk - 1) / kChunk : 1;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  adam_update_kernel<<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}
