// The SGD step's draws for Hopper (sm_90a): every cell's source slot and its
// B mini-batch rows in one launch (entry psvgp_minibatch_draws).
//
// Replaces no Pallas kernel: the JAX package draws with jax.random in plain
// jnp that XLA fuses into the step (src/repro/core/sampler.py). The port's
// plain composition (core/sampler.py: StepDraws, sample_slots, mask[kprime],
// sample_minibatch_indices) is 67 device ops a step, most of them int64
// elementwise passes over the (P, n_max) counters, and a top-k. This kernel
// computes the same numbers, in the same float operations, for each cell p:
//
//   start = mix64(step * GOLDEN + stream)       (step read on the device)
//   draw 0, elements 5p + s (s = 0..4):   u_s = top 24 bits of
//            mix64((5p + s + 1) * GOLDEN + start) x 2^-24
//   slot   = the first s maximising logf(max(probs[p, s], 1e-30))
//            + -logf(-logf(max(u_s, FLT_MIN)))        (torch.argmax's rule)
//   kprime = neighbor_tbl[p, slot]; the source row kprime, -1 wrapping to
//            P - 1 as torch's indexing does
//   draw 1 (start + DRAW), elements p n_max + i:  score_i = u_i +
//            (mask[kprime, i] - 1) * 1e9
//   idx[p] = the B rows of highest score, highest first; equal scores lower
//            index first (torch.topk leaves ties in an order of its own).
//
// Every float operation rounds once, as torch's separate kernels do
// (__fmul_rn, __fadd_rn, __fsub_rn: nothing contracted; logf, not __logf),
// so kprime and idx are bitwise ref.minibatch_draws, the plain composition
// with a stable descending sort, on the card. Scores are finite and never
// -0 (u >= +0, and (m - 1) * 1e9 is +0 or negative for a 0/1 mask), so the
// order of a score's bits, sign-flipped, is the order of the floats. A row
// element's key is that 32-bit order above the complement of its index: one
// 64-bit compare settles the score and the tie, and keys are distinct.
//
// What bounds it: bytes on paper, latency and instruction rate in fact. At (P, n_max, B)
// = (6,400, 240, 32) it reads the source rows' masks (6.1 MB) and writes idx
// and kprime (1.7 MB): 2.4 us at 3.35 TB/s; its integer work is ~1.5 M
// SplitMix64 words. A cell's work is a chain of dependent loads (the step,
// the slot's probabilities, the table, the source row) and of warp
// reductions, so the design keeps every stage of a cell in one warp's
// registers and draws the row's uniforms while the source is looked up.
//
// Two bodies, chosen by n_max alone:
//   fast (n_max <= kFastMaxRow): one warp a cell. Lane l draws the uniforms
//        of elements j * 32 + l into register j, then reads the source's mask
//        (coalesced) and keeps each score's 32 order bits. The B-th highest
//        score's bits t come from a binary search from the top bit, each step
//        counting the scores that reach a candidate in one warp reduction;
//        the batch (every score above t, then the first ties at t in row
//        order, by ballots) goes to shared memory as keys, and each key's
//        rank among the batch's is its place. A bitonic sort of the whole row
//        in registers took twice as long at (6,400, 240) (PERF.md).
//   long (n_max > kFastMaxRow): one block a cell, the row streamed, its keys
//        recomputed at each pass. A radix select (4 passes of 8-bit digits,
//        block histograms) finds t and how many ties the batch takes; one
//        more pass writes the batch's keys to a scratch row in any order;
//        each key's rank among them is its place.
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ull;  // SplitMix64's increment
constexpr unsigned long long kMix1 = 0xBF58476D1CE4E5B9ull;
constexpr unsigned long long kMix2 = 0x94D049BB133111EBull;
constexpr unsigned long long kDraw = 0xD1B54A32D192ED03ull;  // spaces a step's draws apart
constexpr int kSlots = 5;                                    // core/neighbors.py NUM_SLOTS
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kFastWarps = 4;                 // cells a block of the fast body
constexpr int kFastMaxKpl = 16;               // scores a lane
constexpr int kFastMaxRow = 32 * kFastMaxKpl;  // kernels/draws.py MAX_FAST_ROW
constexpr int kLongThreads = 256;
constexpr int kLongWarps = kLongThreads / 32;
static_assert(kLongThreads == 256, "the long body's threads clear its 256 histogram bins");

struct Args {
  const float* probs;        // (P, 5)
  const long long* tbl;      // (P, 5), -1 where a slot has no cell
  const float* mask;         // (P, n_max)
  long long* kprime;         // (P,)
  long long* idx;            // (P, B)
  unsigned long long* keys;  // (P, B) scratch of the long body, else null
  const long long* step_in;  // the step counter on the device, or null: step_host
  long long step_host;
  unsigned long long stream;  // sampler.stream_seed(seed, "step")
  long long P;
  int n_max, B;
};

__device__ __forceinline__ unsigned long long mix64(unsigned long long z) {
  z = (z ^ (z >> 30)) * kMix1;
  z = (z ^ (z >> 27)) * kMix2;
  return z ^ (z >> 31);
}

// element e of the draw that starts at `start`, exact in float32
__device__ __forceinline__ float uniform(unsigned long long start, unsigned long long e) {
  const unsigned long long bits = mix64((e + 1) * kGolden + start) >> 40;
  return __fmul_rn(static_cast<float>(bits), 1.0f / 16777216.0f);
}

__device__ __forceinline__ unsigned long long step_start(const Args& a) {
  const unsigned long long step = a.step_in != nullptr ? *a.step_in : a.step_host;
  return mix64(step * kGolden + a.stream);
}

// cell p's source (all 32 lanes of the warp call it; lane s < 5 draws slot s)
__device__ __forceinline__ long long cell_source(const Args& a, long long p,
                                                 unsigned long long start, int lane) {
  float v = 0.0f;
  if (lane < kSlots) {
    const float u = uniform(start, static_cast<unsigned long long>(p) * kSlots + lane);
    const float logit = logf(fmaxf(a.probs[p * kSlots + lane], 1e-30f));
    v = __fadd_rn(logit, -logf(-logf(fmaxf(u, FLT_MIN))));
  }
  float best = __shfl_sync(kFull, v, 0);
  int slot = 0;
#pragma unroll
  for (int s = 1; s < kSlots; ++s) {
    const float w = __shfl_sync(kFull, v, s);
    if (w > best) {
      best = w;
      slot = s;
    }
  }
  return a.tbl[p * kSlots + slot];
}

// the order bits of a row element's score (its uniform u, its source's mask m)
__device__ __forceinline__ unsigned score_bits(float u, float m) {
  const float s = __fadd_rn(u, __fmul_rn(__fsub_rn(m, 1.0f), 1e9f));
  const unsigned b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long row_key(unsigned bits, int i) {
  return (static_cast<unsigned long long>(bits) << 32) | (kFull - static_cast<unsigned>(i));
}

__device__ __forceinline__ long long key_row(unsigned long long key) {
  return static_cast<long long>(kFull - static_cast<unsigned>(key));
}

// the lanes below `lane`, as a ballot's bits
__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

template <int KPL>
__global__ void __launch_bounds__(32 * kFastWarps) draws_fast_kernel(const Args a) {
  extern __shared__ unsigned long long s_batch[];  // B keys a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = static_cast<long long>(blockIdx.x) * kFastWarps + warp;
  if (p >= a.P) return;  // the whole warp
  const unsigned long long start = step_start(a);
  const unsigned long long start1 = start + kDraw;
  const unsigned long long e0 = static_cast<unsigned long long>(p) * a.n_max;
  float u[KPL];  // the row's uniforms, drawn while the source is looked up
#pragma unroll
  for (int j = 0; j < KPL; ++j) u[j] = uniform(start1, e0 + j * 32 + lane);
  const long long kp = cell_source(a, p, start, lane);
  if (lane == 0) a.kprime[p] = kp;
  const float* row = a.mask + (kp < 0 ? kp + a.P : kp) * a.n_max;
  const unsigned B = a.B;
  unsigned o[KPL];  // element j * 32 + lane's score bits; 0 past the row, below every score
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int i = j * 32 + lane;
    o[j] = i < a.n_max ? score_bits(u[j], row[i]) : 0u;
  }
  // the B-th highest score's bits: the largest t that B scores reach
  unsigned t = 0;
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned c = t | (1u << bit);
    unsigned n = 0;
#pragma unroll
    for (int j = 0; j < KPL; ++j) n += o[j] >= c;
    if (__reduce_add_sync(kFull, n) >= B) t = c;
  }
  // the batch in row order: every score above t, then the first ties at t
  unsigned above = 0;
#pragma unroll
  for (int j = 0; j < KPL; ++j) above += o[j] > t;
  const unsigned want = B - __reduce_add_sync(kFull, above);
  unsigned long long* batch = s_batch + warp * B;
  unsigned taken = 0, ties = 0;  // the same in every lane
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const bool at_t = o[j] == t;
    const unsigned tie = __ballot_sync(kFull, at_t);
    const bool take = o[j] > t || (at_t && ties + __popc(tie & lanes_below(lane)) < want);
    const unsigned took = __ballot_sync(kFull, take);
    if (take) batch[taken + __popc(took & lanes_below(lane))] = row_key(o[j], j * 32 + lane);
    taken += __popc(took);
    ties += __popc(tie);
  }
  __syncwarp();
  // a key's rank among the batch's distinct keys is its place
  for (unsigned s = lane; s < B; s += 32) {
    const unsigned long long key = batch[s];
    unsigned place = 0;
#pragma unroll 8
    for (unsigned f = 0; f < B; ++f) place += batch[f] > key;
    a.idx[p * B + place] = key_row(key);
  }
}

__global__ void __launch_bounds__(kLongThreads) draws_long_kernel(const Args a) {
  __shared__ unsigned hist[256];
  __shared__ unsigned warp_ties[kLongWarps];
  __shared__ long long s_kp;
  __shared__ unsigned s_prefix, s_want;
  __shared__ int s_taken;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long p = blockIdx.x;
  const int n_max = a.n_max, B = a.B;
  const unsigned long long start = step_start(a);
  if (warp == 0) {
    const long long kp = cell_source(a, p, start, lane);
    if (lane == 0) {
      a.kprime[p] = kp;
      s_kp = kp;
      s_taken = 0;
    }
  }
  __syncthreads();
  const float* row = a.mask + (s_kp < 0 ? s_kp + a.P : s_kp) * n_max;
  const unsigned long long start1 = start + kDraw;
  const unsigned long long e0 = static_cast<unsigned long long>(p) * n_max;

  // the B-th highest score's bits (prefix), and how many scores equal to it
  // the batch takes (want), a digit at a time from the top
  unsigned prefix = 0, want = B;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;  // kLongThreads == 256 bins
    __syncthreads();
    const unsigned high = shift == 24 ? 0u : kFull << (shift + 8);
    for (int i = tid; i < n_max; i += kLongThreads) {
      const unsigned o = score_bits(uniform(start1, e0 + i), row[i]);
      if (((o ^ prefix) & high) == 0) atomicAdd(&hist[(o >> shift) & 255], 1u);
    }
    __syncthreads();
    if (warp == 0) {  // lane l counts bins 255 - 8l down to 248 - 8l
      unsigned c[8], total = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        c[r] = hist[255 - 8 * lane - r];
        total += c[r];
      }
      unsigned incl = total;  // the count from the top bin to this lane's last
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned n = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += n;
      }
      // some lane reaches want: lane 31's count is every score left
      const int first = __ffs(__ballot_sync(kFull, incl >= want)) - 1;
      if (lane == first) {
        unsigned above = incl - total;
        int r = 0;
        while (above + c[r] < want) above += c[r++];
        s_prefix = prefix | (static_cast<unsigned>(255 - 8 * lane - r) << shift);
        s_want = want - above;
      }
    }
    __syncthreads();
    prefix = s_prefix;
    want = s_want;
  }

  // the batch's keys, in any order: every score above the prefix, and the
  // first `want` scores equal to it in row order
  unsigned long long* keys = a.keys + p * B;
  unsigned ties_before = 0;  // ties in earlier chunks (the same in every thread)
  for (int base = 0; base < n_max; base += kLongThreads) {
    const int i = base + tid;
    const unsigned o = i < n_max ? score_bits(uniform(start1, e0 + i), row[i]) : 0u;
    const bool tie = i < n_max && o == prefix;
    const unsigned ties = __ballot_sync(kFull, tie);
    if (lane == 0) warp_ties[warp] = __popc(ties);
    __syncthreads();
    unsigned before = ties_before + __popc(ties & lanes_below(lane)), total = 0;
#pragma unroll
    for (int w = 0; w < kLongWarps; ++w) {
      if (w < warp) before += warp_ties[w];
      total += warp_ties[w];
    }
    if (i < n_max && (o > prefix || (tie && before < want))) {
      keys[atomicAdd(&s_taken, 1)] = row_key(o, i);
    }
    ties_before += total;
    __syncthreads();  // warp_ties read before the next chunk writes it; keys visible
  }

  // a key's rank among the batch's distinct keys is its place
  for (int j = tid; j < B; j += kLongThreads) {
    const unsigned long long key = keys[j];
    int place = 0;
    for (int f = 0; f < B; ++f) place += keys[f] > key;
    a.idx[p * B + place] = key_row(key);
  }
}

template <int KPL>
cudaError_t launch_fast(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.P + kFastWarps - 1) / kFastWarps;
  const size_t batch_bytes = sizeof(unsigned long long) * kFastWarps * a.B;
  draws_fast_kernel<KPL>
      <<<static_cast<unsigned>(blocks), 32 * kFastWarps, batch_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (loaded with ctypes). probs (P, 5) float32, tbl (P, 5)
// int64, mask (P, n_max) float32, all contiguous on device `device`; writes
// kprime (P,) and idx (P, B) int64. `keys` is a (P, B) int64 scratch, needed
// (else null) when n_max > kFastMaxRow. The step counter is an int64 device
// pointer or null (then `step_host` is read); `stream_key` is
// sampler.stream_seed(seed, "step"). Needs 1 <= B <= n_max. Launches
// asynchronously on `stream` and returns cudaGetLastError() (0 on success);
// never synchronizes, never allocates.
extern "C" int psvgp_minibatch_draws(const void* probs, const void* tbl, const void* mask,
                                     void* kprime, void* idx, void* keys, const void* step_in,
                                     long long step_host, long long stream_key, int P, int n_max,
                                     int B, int device, void* stream) {
  if (P < 1 || n_max < 1 || B < 1 || B > n_max || (n_max > kFastMaxRow && keys == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.probs = static_cast<const float*>(probs);
  a.tbl = static_cast<const long long*>(tbl);
  a.mask = static_cast<const float*>(mask);
  a.kprime = static_cast<long long*>(kprime);
  a.idx = static_cast<long long*>(idx);
  a.keys = static_cast<unsigned long long*>(keys);
  a.step_in = static_cast<const long long*>(step_in);
  a.step_host = step_host;
  a.stream = static_cast<unsigned long long>(stream_key);
  a.P = P;
  a.n_max = n_max;
  a.B = B;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_max > kFastMaxRow) {
    draws_long_kernel<<<P, kLongThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  // two instances: 8 scores a lane covers every cell's rows (224 and 240);
  // a shorter row masks the registers past n_max
  if (n_max <= 32 * 8) return (int)launch_fast<8>(a, s);
  return (int)launch_fast<kFastMaxKpl>(a, s);
}
