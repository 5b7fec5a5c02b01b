// The binary PMP superstep's tree, in two kernels around the target call.
//
// Replaces no TPU kernel: pmpx jits its superstep (pmpx/samplers/pmp.py), and
// XLA fuses the tree's positions, per-level weights, stabiliser and
// resampling into a few fusions on the TPU.  The port's generic superstep ran
// the same steps as PyTorch operators (pmpx_torch/samplers/pmp.py
// tree_positions, log_accept_tree, samplers/stabilize.py stabilize_logits,
// resample.py categorical_many): ~190 kernels of ~1.5 us each a superstep at
// P = 1024, replayed from a CUDA graph.
//
// What bounds them on the H100: launch latency.  The work is a few KB a
// chain: at one chain of P = 1024 states of d = 3, kernel 1 writes 12 KB and
// kernel 2 reads 4 KB of log-densities and 4 KB of uniforms, with one
// logsumexp a sibling pair and one exp a node, a few us of one SM.  So each
// side of the target call is one launch, and every intermediate stays in
// registers or shared memory:
//
// - tree_positions_kernel, one thread an element of Y (C, P, d):
//       Y[x] = theta + sum_i [bit i of x] * (scale * eps[x mod 2^(i+1)])
//   added level by level, adding 0 where the bit is clear, as tree_positions
//   adds its tiles, so Y is bit-equal to it; __fmul_rn keeps the step size's
//   product out of an fma, as torch's separate multiply does.
// - tree_select_kernel, one block a chain, P <= 2^14 (the log-densities, the
//   weights and the draws in shared memory):
//     the weights: the P - 1 sibling pairs' logsumexps once, with
//       torch.logsumexp's arithmetic (a maximum of +-inf taken as 0) and the
//       precise expf and logf; then each thread sums its own nodes,
//       logA[x] = sum_i (logpi[x mod 2^(i+1)] - lse(logpi[h], logpi[h + 2^i])),
//       h = x mod 2^i, in level order, with no barrier between levels;
//     the stabiliser (z-score with the population std clamped at 1e-30, or
//       none) and the NaN/+inf guard, as stabilize_logits applies them;
//     the softmax and its CDF: a block scan of the probabilities, made
//       monotone by a running maximum over the nodes of positive weight (a
//       node of zero weight keeps its predecessor's value, so it can never be
//       drawn; a parallel sum's rounding could otherwise give it an ulp),
//       divided by its last entry;
//     the draws: each uniform takes #{j : u > cdf_j} by binary search, which
//       on a monotone CDF is categorical_many's count, clipped to P - 1; then
//       the root by the selection mode, its log-density, and the gathers of
//       the next state and the emitted rows.
//   Every sum runs in a fixed order and there are no atomics, so a replayed
//   graph is bit-equal to the eager loop.
// - tree_gather_kernel: the rows' gather over the whole grid, where they are
//   too many for one block (the wrapper decides from the shape).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxDepth = 14;  // (3 P + P / 32) floats of shared memory
constexpr int kGatherThreads = 256;
constexpr int kMaxGatherBlocks = 65535;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kCopyPerThread = 4;
constexpr int kCopyBatch = 8;
enum Mode { kAllUniform = 0, kAllFirst = 1, kSingle = 2 };

__global__ void __launch_bounds__(kGatherThreads)
tree_positions_kernel(const float* __restrict__ theta,
                      const float* __restrict__ eps, float* __restrict__ Y,
                      long long total, int depth, int d, float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += stride) {
    const long long row = e / d;
    const int k = static_cast<int>(e - row * d);
    const long long c = row >> depth;
    const int x = static_cast<int>(row & ((1 << depth) - 1));
    const float* ec = eps + (c << depth) * d + k;
    float y = theta[c * d + k];
    for (int i = 0; i < depth; ++i) {
      const int src = x & ((2 << i) - 1);
      y = y + (((x >> i) & 1)
                   ? __fmul_rn(scale, ec[static_cast<long long>(src) * d])
                   : 0.f);
    }
    Y[e] = y;
  }
}

// torch.amax's maximum: NaN wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

constexpr unsigned kFull = 0xffffffffu;

// The warps' values red[0..warps) reduced alike by every warp: lane w takes
// red[w] (0 past the last warp), a shuffle tree sums them, lane 0's total
// goes to every lane.  So every thread of the block holds the same value.
__device__ __forceinline__ float warps_sum(const float* red) {
  const int lane = threadIdx.x & 31;
  float v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}

// The block's sum of v, in a fixed order (a shuffle tree within each warp,
// then warps_sum), to every thread.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warps_sum(red);
}

// The block's maximum of v (NaN wins), to every thread.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max_nan(v, __shfl_down_sync(kFull, v, o));
  __syncthreads();
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : -INFINITY;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max_nan(v, __shfl_down_sync(kFull, v, o));
  return __shfl_sync(kFull, v, 0);
}

// Inclusive scan of v over the lanes of a warp (+, or max where kMax).
template <bool kMax>
__device__ __forceinline__ float warp_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = kMax ? fmaxf(v, n) : v + n;
  }
  return v;
}

// The sum (kMax: the maximum, of v >= 0) of v over the threads before this
// one; 0 for thread 0.  Every warp scans the warps' totals alike, so the
// offsets agree across the block; *total, where given, gets the whole
// block's.
template <bool kMax>
__device__ float block_exclusive_scan(float v, float* red,
                                      float* total = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float incl = warp_scan<kMax>(v);
  const float excl = __shfl_up_sync(kFull, incl, 1);
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  const float totals = warp_scan<kMax>(
      lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f);
  const float prev = __shfl_sync(kFull, totals, (warp + 31) & 31);
  if (total != nullptr) {
    *total = __shfl_sync(kFull, totals, (static_cast<int>(blockDim.x) >> 5) - 1);
  }
  const float off = warp ? prev : 0.f;
  if (lane == 0) return off;
  return kMax ? fmaxf(off, excl) : off + excl;
}

// w's index of node i: one word of padding every 32, so that the binary
// searches' first probes (multiples of a power of two) fall in distinct
// banks
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// One block of T threads a chain c: thread t owns the nodes
// [t * per, t * per + per) of the P, per = max(1, P / T).  Shared memory
// holds lp (P log-densities), w (P weights, then logits, then the CDF, at
// pad(node)) and lse (P: each sibling pair's logsumexp, then the num draws
// as int).  draws_out,
// where not null, takes the draws, and the copies are left to
// tree_gather_kernel.
__global__ void __launch_bounds__(kMaxThreads)
tree_select_kernel(const float* __restrict__ logpi,
                   const float* __restrict__ Y, const float* __restrict__ u,
                   const long long* __restrict__ pick,
                   float* __restrict__ log_accept, int* __restrict__ root_out,
                   float* __restrict__ root_logp, float* __restrict__ theta2,
                   float* __restrict__ samples, int* __restrict__ draws_out,
                   int depth, int d, int mode, int zscore, int nan_guard) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxThreads / 32];
  __shared__ int s_root;
  const int P = 1 << depth;
  const int num = mode == kSingle ? 1 : P;
  float* lp = smem;
  float* w = smem + P;
  float* lse = w + pad(P);
  int* draw = reinterpret_cast<int*>(lse);
  const int t = threadIdx.x, T = blockDim.x;
  const long long c = blockIdx.x;
  const long long cP = c * P;
  const int per = P > T ? P / T : 1;
  const int lo = t * per, hi = min(P, lo + per);

  for (int x = t; x < P; x += T) lp[x] = logpi[cP + x];
  const float u0 = t < num ? u[c * num + t] : 0.f;  // in flight meanwhile
  __syncthreads();
  // the logsumexp of each sibling pair (h, h + half), at lse[half + h]:
  // torch.logsumexp's arithmetic, its maximum taken as 0 where infinite
  for (int q = t + 1; q < P; q += T) {
    const int half = 1 << (31 - __clz(q));
    const float a = lp[q - half], b = lp[q];
    float m = max_nan(a, b);
    if (fabsf(m) == INFINITY) m = 0.f;
    lse[q] = logf(expf(a - m) + expf(b - m)) + m;
  }
  __syncthreads();

  // the weights, summed in log_accept_tree's level order
  for (int x = lo; x < hi; ++x) {
    float acc = 0.f;
    for (int i = 0; i < depth; ++i) {
      const int half = 1 << i;
      acc = acc + (lp[x & (2 * half - 1)] - lse[half + (x & (half - 1))]);
    }
    w[pad(x)] = acc;
    log_accept[cP + x] = acc;
  }

  // the stabiliser and the guard (stabilize_logits)
  if (zscore) {
    float s = 0.f;
    for (int x = lo; x < hi; ++x) s += w[pad(x)];
    const float mean = block_sum(s, red) / P;
    float q = 0.f;
    for (int x = lo; x < hi; ++x) {
      const float dev = w[pad(x)] - mean;
      q += dev * dev;
    }
    float sd = sqrtf(block_sum(q, red) / P);
    if (sd < 1e-30f) sd = 1e-30f;  // NaN stays NaN, as in torch.clamp
    for (int x = lo; x < hi; ++x) w[pad(x)] = (w[pad(x)] - mean) / sd;
  }
  if (nan_guard) {
    for (int x = lo; x < hi; ++x) {
      if (w[pad(x)] != w[pad(x)] || w[pad(x)] == INFINITY) w[pad(x)] = 0.f;
    }
  }

  // the softmax's probabilities
  float mx = -INFINITY;
  for (int x = lo; x < hi; ++x) mx = max_nan(mx, w[pad(x)]);
  mx = block_max(mx, red);
  float s = 0.f;
  for (int x = lo; x < hi; ++x) {
    w[pad(x)] = expf(w[pad(x)] - mx);
    s += w[pad(x)];
  }
  const float sum = block_sum(s, red);
  float ps = 0.f;
  for (int x = lo; x < hi; ++x) {
    w[pad(x)] = w[pad(x)] / sum;
    ps += w[pad(x)];
  }
  // the CDF: the thread's running sum from the sum of the threads before
  // it, held monotone by the running maximum over the nodes of positive
  // weight (a NaN probability counts as 0; the second pass repeats the
  // first's adds exactly), over its last entry, the maximum of them all
  const float start = block_exclusive_scan<false>(ps, red);
  float run = start, top = 0.f;
  for (int x = lo; x < hi; ++x) {
    run += w[pad(x)];
    if (w[pad(x)] > 0.f) top = fmaxf(top, run);
  }
  float last;
  float cur = block_exclusive_scan<true>(top, red, &last);
  run = start;
  for (int x = lo; x < hi; ++x) {
    run += w[pad(x)];
    if (w[pad(x)] > 0.f) cur = fmaxf(cur, run);
    w[pad(x)] = cur / last;
  }
  __syncthreads();

  // the draws: #{j : u > cdf_j}, clipped to P - 1
  for (int j = t; j < num; j += T) {
    const float uj = j == t ? u0 : u[c * num + j];
    int a = 0, b = P;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (uj > w[pad(mid)]) {
        a = mid + 1;
      } else {
        b = mid;
      }
    }
    draw[j] = min(a, P - 1);
  }
  __syncthreads();
  if (t == 0) {
    int r = draw[0];
    if (mode == kAllUniform) {
      const long long k = pick[c];
      r = draw[k < 0 ? 0 : (k >= P ? P - 1 : k)];
    }
    s_root = r;
    root_out[c] = r;
    root_logp[c] = lp[r];
  }
  __syncthreads();
  const int r = s_root;

  if (draws_out != nullptr) {
    for (int j = t; j < num; j += T) draws_out[c * num + j] = draw[j];
    return;
  }
  // the next state, then the emitted rows; each thread keeps kCopyBatch
  // loads in flight before it stores them
  const float* Yc = Y + cP * d;
  for (int k0 = t; k0 < d; k0 += kCopyBatch * T) {
    float v[kCopyBatch];
#pragma unroll
    for (int i = 0; i < kCopyBatch; ++i) {
      const int k = k0 + i * T;
      if (k < d) v[i] = Yc[static_cast<long long>(r) * d + k];
    }
#pragma unroll
    for (int i = 0; i < kCopyBatch; ++i) {
      const int k = k0 + i * T;
      if (k < d) theta2[c * d + k] = v[i];
    }
  }
  if (samples == nullptr) return;
  float* out = samples + cP * d;
  const int n = num * d;
  for (int e0 = t; e0 < n; e0 += kCopyBatch * T) {
    float v[kCopyBatch];
#pragma unroll
    for (int i = 0; i < kCopyBatch; ++i) {
      const int e = e0 + i * T;
      if (e < n) {
        const int j = e / d;
        v[i] = Yc[static_cast<long long>(draw[j]) * d + (e - j * d)];
      }
    }
#pragma unroll
    for (int i = 0; i < kCopyBatch; ++i) {
      const int e = e0 + i * T;
      if (e < n) out[e] = v[i];
    }
  }
}

// rows = 1 (the next state) or P + 1 (it, then the P samples) a chain.
__global__ void __launch_bounds__(kGatherThreads)
tree_gather_kernel(const float* __restrict__ Y, const int* __restrict__ draws,
                   const int* __restrict__ root, float* __restrict__ theta2,
                   float* __restrict__ samples, long long total, int depth,
                   int d, int rows) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += stride) {
    const long long row = e / d;
    const int k = static_cast<int>(e - row * d);
    const long long c = row / rows;
    const int r = static_cast<int>(row - c * rows);
    const long long cP = c << depth;
    if (r == 0) {
      theta2[c * d + k] = Y[(cP + root[c]) * d + k];
    } else {
      samples[(cP + r - 1) * d + k] = Y[(cP + draws[cP + r - 1]) * d + k];
    }
  }
}

unsigned grid_for(long long total) {
  const long long blocks = (total + kGatherThreads - 1) / kGatherThreads;
  return static_cast<unsigned>(blocks < kMaxGatherBlocks ? blocks
                                                          : kMaxGatherBlocks);
}

}  // namespace

extern "C" {

// Y (C, 2^depth, d) = the tree's positions from theta (C, d) and the
// innovations eps (C, 2^depth, d), each innovation times `scale`.  Launches
// on `stream`, does not synchronize, and returns the launch's cudaError_t.
int pmpx_tree_positions(const float* theta, const float* eps, float* Y, int C,
                        int depth, int d, float scale, void* stream) {
  if (C < 1 || d < 1 || depth < 1 || depth > kMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = (static_cast<long long>(C) << depth) * d;
  tree_positions_kernel<<<grid_for(total), kGatherThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      theta, eps, Y, total, depth, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// For C chains of a binary tree of P = 2^depth states of d: from logpi
// (C, P), Y (C, P, d), the uniforms u (C, num) (num = 1 for mode 2 `single`,
// else P) and, for mode 0 `all_uniform`, the root slots pick (C,) int64,
// writes log_accept (C, P), root (C,) int32, root_logp (C,), theta2 (C, d)
// and, unless mode is `single` (samples null), samples (C, P, d).  mode 1 is
// `all_first`; zscore 1 standardises the weights; nan_guard 1 gives NaN and
// +inf logits weight 1.  With draws (C, num) int32 scratch the gathers run
// as a second, grid-wide launch.  Launches on `stream`, does not
// synchronize, and returns the first failing call's cudaError_t.
int pmpx_tree_select(const float* logpi, const float* Y, const float* u,
                     const long long* pick, float* log_accept, int* root,
                     float* root_logp, float* theta2, float* samples,
                     int* draws, int C, int depth, int d, int mode,
                     int zscore, int nan_guard, void* stream) {
  if (C < 1 || d < 1 || depth < 1 || depth > kMaxDepth || mode < kAllUniform ||
      mode > kSingle || (mode == kAllUniform && pick == nullptr) ||
      ((mode == kSingle) != (samples == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = 1 << depth;
  const int num = mode == kSingle ? 1 : P;
  const int rows = mode == kSingle ? 1 : P + 1;
  // a thread a node, at least a warp; all 1024 where the block's own copy
  // of the rows would be more than a few elements a thread
  int threads = P < 32 ? 32 : (P < kMaxThreads ? P : kMaxThreads);
  if (draws == nullptr && static_cast<long long>(rows) * d >
                              static_cast<long long>(kCopyPerThread) * threads) {
    threads = kMaxThreads;
  }
  const size_t smem = (3 * static_cast<size_t>(P) + (P >> 5)) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tree_select_kernel<<<C, threads, smem, s>>>(
      logpi, Y, u, pick, log_accept, root, root_logp, theta2, samples, draws,
      depth, d, mode, zscore, nan_guard);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || draws == nullptr) return static_cast<int>(err);
  const long long total = static_cast<long long>(C) * rows * d;
  tree_gather_kernel<<<grid_for(total), kGatherThreads, 0, s>>>(
      Y, draws, root, theta2, samples, total, depth, d, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
