// Batched residual sum of squares for Bayesian linear regression.
//
// Replaces the Pallas TPU kernel pmpx/kernels/linreg.py:_rss_kernel
// (host wrapper batched_rss).  Computes, in f32, the direct sum over the
// first n points of the lane-major data,
//
//     rss[p] = sum_{i < n} (y_i - b0_p - b1_p * x_i)^2        p < P
//
// The wrapper (pmpx_torch/kernels/linreg.py) passes n = every slot of the
// zero-padded grid (pmpx's contract: each padded point adds b0^2, which the
// caller subtracts) or n = the real points only, and then the zero tail is
// never read.
//
// What bounds it on the H100: issue.  A (p, i) pair costs three FP32
// instructions (FADD y - b0, FFMA r, FFMA acc), and nothing cheaper keeps
// the direct sum; an SM issues 4 warp-instructions a clock (128 lanes).  At
// P = 1024 over n = 100,000 points that is 3.1e8 lane-instructions, ~9.2 us
// on 132 SMs at 1.98 GHz (the 67 TFLOP/s peak at 5 flops a pair gives 7.6
// us), against 0.8 MB of data that stays in the 50 MB L2.  So the design
// keeps every SM busy for one wave, spends little but those three
// instructions a pair, and keeps the reduction on chip:
//
// - One launch, no scratch, no atomics.  The grid is ceil(P / kPPT)
//   thread-block clusters of `cs` <= 8 blocks (the portable size; 1 is a
//   plain block), one block of kThreads per SM.  The C entry point picks cs
//   from P, n, the SM count and cudaOccupancyMaxActiveClusters: every
//   cluster is resident at once where P allows one wave (no tail), at the
//   least priced time (geometry()).
// - Cluster c owns proposals [c * kPPT, (c + 1) * kPPT), and block `rank`
//   of it a contiguous slice of the data, whose float4s its threads take in
//   turn: a warp loads 32 neighbouring float4s of x and of y, whole 128-byte
//   lines.  One load feeds 4 points x kPPT proposals, and the next float4
//   is in flight while this one is used (the loop unrolled 4 times, so that
//   the rotation of the buffers costs no moves).  Each thread keeps the
//   cluster's b0, -b1 and its own sums in registers.
// - The reduction runs in a fixed order: shuffles across a warp, shared
//   memory across the block's warps, then each rank stores its block sums
//   into rank 0's shared memory (distributed shared memory, one cluster
//   barrier), and rank 0 adds them in rank order and writes out[p].  For a
//   given (P, n) and card the result repeats bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPPT = 8;         // proposals per thread, and per cluster
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxDevices = 64;
// The geometry's prices, fitted on an H100 SXM by scripts/rss_cluster_fit.py
// (PERF.md): one SM's ns per pair, and the ns a cluster of more than one
// block adds (its launch, barrier and remote stores).
constexpr double kPairNs = 0.0145;
constexpr double kClusterNs = 1010.0;

__device__ __forceinline__ void add_point(float xv, float yv,
                                          const float (&a0)[kPPT],
                                          const float (&na1)[kPPT],
                                          float (&acc)[kPPT]) {
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const float r = fmaf(na1[k], xv, yv - a0[k]);
    acc[k] = fmaf(r, r, acc[k]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
rss_kernel(const float* __restrict__ b0, const float* __restrict__ b1,
           const float* __restrict__ x, const float* __restrict__ y,
           float* __restrict__ out, int P, int n) {
  __shared__ float warp_sum[kWarps][kPPT];
  __shared__ float rank_sum[kMaxCluster][kPPT];  // rank 0's: each rank's sums

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int cs = gridDim.x;     // the cluster spans the grid's x
  const int rank = blockIdx.x;  // so this is the block's rank in it
  const int pc = blockIdx.y * kPPT;
  // the cluster's first barrier phase (every block has started) opens now
  // and is waited on only before rank 0's shared memory is written
  if (cs > 1) asm volatile("barrier.cluster.arrive.relaxed;\n" ::);

  float a0[kPPT], na1[kPPT], acc[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int p = pc + k;
    a0[k] = p < P ? b0[p] : 0.f;
    na1[k] = p < P ? -b1[p] : 0.f;
    acc[k] = 0.f;
  }

  // the block's contiguous slice of whole float4s, which its threads take
  // in turn: a warp loads neighbouring float4s, whole 128-byte lines
  const int nv = n >> 2;
  const int lo = static_cast<int>(static_cast<long long>(nv) * rank / cs);
  const int hi =
      static_cast<int>(static_cast<long long>(nv) * (rank + 1) / cs);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  int v = lo + t;
  if (v < hi) {
    float4 xa = x4[v], ya = y4[v];
#pragma unroll 4
    for (; v < hi; v += kThreads) {
      const int vn = min(v + kThreads, hi - 1);  // the last turn reloads
      const float4 xb = x4[vn], yb = y4[vn];
      add_point(xa.x, ya.x, a0, na1, acc);
      add_point(xa.y, ya.y, a0, na1, acc);
      add_point(xa.z, ya.z, a0, na1, acc);
      add_point(xa.w, ya.w, a0, na1, acc);
      xa = xb;
      ya = yb;
    }
  }
  if (rank == cs - 1 && t == kThreads - 1) {  // the last n % 4 points
    for (int i = nv * 4; i < n; ++i) add_point(x[i], y[i], a0, na1, acc);
  }

#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < kPPT; ++k)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kPPT; ++k) warp_sum[warp][k] = acc[k];
  }
  __syncthreads();
  float s = 0.f;
  if (t < kPPT) {
    s = warp_sum[0][t];
    for (int w = 1; w < kWarps; ++w) s += warp_sum[w][t];
  }
  if (cs == 1) {
    if (t < kPPT && pc + t < P) out[pc + t] = s;
    return;
  }
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  if (t < kPPT) *cg::this_cluster().map_shared_rank(&rank_sum[rank][t], 0) = s;
  // each rank's sums are in rank 0's shared memory when this phase ends
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
  if (rank == 0 && t < kPPT) {
    for (int r = 1; r < cs; ++r) s += rank_sum[r][t];
    if (pc + t < P) out[pc + t] = s;
  }
}

// per device: SM count, and the occupancy query's clusters of each size
// (0: not asked yet)
int g_sms[kMaxDevices];
int g_max_clusters[kMaxDevices][kMaxCluster + 1];

cudaLaunchConfig_t launch_config(int cs, int clusters, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, clusters, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the current device, its SM count cached
cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[*dev] == 0)
    return cudaDeviceGetAttribute(&g_sms[*dev],
                                  cudaDevAttrMultiProcessorCount, *dev);
  return cudaSuccess;
}

struct Geometry {
  int clusters;      // along the grid's y
  int cs;            // blocks per cluster, along x
  int max_clusters;  // the occupancy query's answer at cs
};

int resident_clusters(int dev, int cs) {
  int& m = g_max_clusters[dev][cs];
  if (m == 0) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(cs, 1, nullptr, &attr);
    int num = 0;
    if (cudaOccupancyMaxActiveClusters(
            &num, reinterpret_cast<const void*>(rss_kernel), &cfg) !=
        cudaSuccess) {
      cudaGetLastError();  // a size the card refuses is one not to pick
      num = 0;
    }
    m = num > 0 ? num : -1;
  }
  return m;
}

// The geometry for P proposals over n points: ceil(P / kPPT) clusters, of
// the size cs at which every cluster is resident at once, one block per
// SM, priced in ns as its pairs' time on one SM (kPPT proposals times
// ceil(n / cs) points) plus kClusterNs where cs > 1; the cheapest wins,
// ties going to the smaller cluster.  Where P is too large for one wave
// (more clusters than SMs), plain blocks in several waves.
cudaError_t geometry(int P, int n, Geometry* geo) {
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  const int clusters = (P + kPPT - 1) / kPPT;
  *geo = {clusters, 1, resident_clusters(dev, 1)};
  double best = -1.0;
  for (int cs = 1; cs <= kMaxCluster && clusters * cs <= g_sms[dev]; ++cs) {
    const int m = resident_clusters(dev, cs);
    if (clusters > m) continue;
    const double cost =
        kPairNs * kPPT * static_cast<double>((n + cs - 1) / cs) +
        (cs > 1 ? kClusterNs : 0.0);
    if (best < 0.0 || cost < best) {
      best = cost;
      *geo = {clusters, cs, m};
    }
  }
  return clusters <= 65535 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

cudaError_t launch(const Geometry& geo, const float* b0, const float* b1,
                   const float* x, const float* y, float* out, int P, int n,
                   cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(geo.cs, geo.clusters, stream, &attr);
  return cudaLaunchKernelEx(&cfg, rss_kernel, b0, b1, x, y, out, P, n);
}

}  // namespace

extern "C" {

// rss over the first n points of x, y (16-byte aligned) for P proposals,
// into out (P,), at the geometry geometry() picks.  One launch on `stream`;
// does not synchronize; returns the launch's cudaError_t.
int pmpx_linreg_rss(const float* b0, const float* b1, const float* x,
                    const float* y, float* out, int P, int n, void* stream) {
  Geometry geo;
  cudaError_t err = geometry(P, n, &geo);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch(geo, b0, b1, x, y, out, P, n, static_cast<cudaStream_t>(stream)));
}

// The launch pmpx_linreg_rss makes for (P, n), into info[9]: clusters,
// blocks a cluster, threads a block, the clusters of that size the card
// holds at once, registers a thread, static and dynamic shared bytes a
// block, blocks an SM holds, and the card's SMs.
int pmpx_linreg_rss_info(int P, int n, int* info) {
  Geometry geo;
  cudaError_t err = geometry(P, n, &geo);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, rss_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rss_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  cudaGetDevice(&dev);
  const int vals[9] = {geo.clusters, geo.cs, kThreads, geo.max_clusters,
                       fa.numRegs, static_cast<int>(fa.sharedSizeBytes), 0,
                       per_sm, g_sms[dev]};
  for (int i = 0; i < 9; ++i) info[i] = vals[i];
  return 0;
}

const char* pmpx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
