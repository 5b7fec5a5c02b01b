// Whole chunks of MP/PMP chains over Bayesian linear regression, one
// launch per chunk, one thread block per chain.
//
// Replaces the Pallas TPU kernel pmpx/kernels/fused_chain.py:_chain_kernel
// (host wrapper make_fused_chain), with emit="root" and emit="all", in its
// three modes:
//   binary  (N = 1, P = 2^depth <= 1024)        chain_binary_kernel
//   mp      (flat MTM, depth 1, P = N+1 <= 1024) chain_mp_kernel
//   general (base N+1 a power of two >= 4, depth 2-5, P = base^depth
//            <= 1024)                           chain_general_kernel
// Each kernel is a template on kAll (emit="all"), the general one also on
// its depth; kAll = false is the emit="root" chain.  A grid of C blocks runs C independent chains (the
// chain farm, pmpx/parallel/chains.py:make_chain_farm_fused, which runs
// the TPU kernel once per chain): block c reads seed[c], theta_in[c] and
// its own uniforms, and writes its own trace and theta_out; the data grids
// are shared.  Chain c of a farm does exactly what a one-chain launch with
// its seed and theta does.
//
// Per launch: the five sufficient statistics (sum x, sum y, sum x^2,
// sum y^2, sum xy) in f32 over the zero-padded grids, in a fixed order.
// Per superstep t, shared by the three modes:
//   z     = sqrt(-2 log u1) cos(2 pi u2),  u in (0, 1]; eps = step * z
//   Y[x]  = theta + S[x],  S[x] = sum_i [digit_i(x) != 0] eps[x mod base^(i+1)]
//           (flat MP: S[x] = eps[x] for x != 0)
//   logpi = the tempered Gaussian log-likelihood from the statistics
//   logA  = the mode's walk (below)
//   w     = exp(logA - max logA), cdf its inclusive prefix sum
// emit="root":
//   k     = min(#{x < P : cdf[x] < usel * sum(w)}, P - 1)
//   theta = Y[k]; trace[:, t] = (theta, k)                    (4 rows)
// emit="all" (the reference's ESS protocol, selection "all_first"):
//   k_j   = min(#{x < P : cdf[x] < ue[j] * sum(w)}, P - 1) for each slot j < P
//   theta = Y[k_0]; emit_b0[t, j] = Y[k_j].b0;
//   J     = sum_{j=1}^{P-1} |Y[k_j] - Y[k_{j-1}]|^2 (three coordinates)
//   trace[:, t] = (theta, J, Y[k_{P-1}], k_0)                 (8 rows)
//   usel is drawn but not used, as in the TPU kernel.
// The walks:
//   binary:  logA = sum_i log_sigmoid(logpi[a_i] - logpi[a_i ^ 2^i]),
//            a_i = x mod 2^(i+1)
//   mp:      lw = logpi - (P |S_x|^2 - 2 S_x.G + Q) / (2 sigma_t^2 norm),
//            G = sum_{x<P} S, Q = sum_{x<P} |S|^2;
//            logA = lw - (max lw + log sum exp(lw - max lw)), so that
//            w = exp(lw - max lw), which the walk hands over
//   general: per level i, temp = base^i, m = base temp; node x < m is
//            member x div temp of the sibling group h = x mod temp;
//            lw[x] = logpi - (base |S_x|^2 - 2 S_x.G_h + Q_h) / (2 s_t^2 norm)
//            with G_h, Q_h the group's sums; zm = max_{x<m} lw;
//            T_h = max(sum_{j<base} exp(lw[h + j temp] - zm), 1e-30);
//            logA += lw[x mod m] - zm - log T[x mod temp]  (pmpx's
//            level-global shift, fused_chain.py:324-327)
// The pairwise distances are taken about theta (S = Y - theta), which is
// exact in algebra and keeps P |S|^2 - 2 S.G + Q from cancelling in f32 at
// P = 1024, where the TPU kernel's |Y|^2 form loses digits.
//
// What bounds it on the H100: one chain is one dependent sequence of
// supersteps in one block, so it runs on one SM, and its floor is that
// SM's issue rate for the work the random stream and the math fix:
// Philox's 40 integer multiplies a call (2 calls a node for emit="root",
// 3 for "all") at 64 a clock, which binds before the multi-function
// unit's ~13 results a node at 16 a clock (chip_smoke.py's
// chain_sm_bound).  At small P a superstep's time is latency instead: its
// dependent transcendentals, shared-memory round trips and block
// barriers.  A farm puts one chain on each block, so that up to 132 SMs
// (and more blocks per SM at small P) run at once.
//
// Design: one thread block per chain, one tree node per thread (blockDim
// = L = P rounded up to 128, at most 1024).  The innovations and the
// log-densities go through shared memory, so each tree level is one
// shared read, with no periodization.  The (L, L) triangular matmul the
// TPU kernel used for the cdf becomes a warp shuffle scan plus a scan of
// the warp totals; the root selection count is __syncthreads_count.  Block
// sums and maxima are warp shuffles, then one pass over the <= 32 warp
// partials in shared memory, in a fixed order (no atomics: deterministic).
// The general walk's (L, L) group-membership matmuls become one thread per
// sibling group, looping over its base <= 32 members in shared memory once
// for all the group's members and all levels.  The next root is
// double-buffered in shared memory so that it needs no barrier of its
// own.  emit="all" replaces the TPU kernel's (L, L) compare and one-hot
// matmuls: every thread puts its node's position and its inclusive cdf in
// shared memory; thread j < P finds k_j by a binary search of the cdf
// (the lower bound; w >= 0, so the cdf is monotone up to the rounding of
// the scan), gathers Y[k_j], writes its b0 (one coalesced row per
// superstep) and publishes its draw; thread j then forms its jump from
// slot j - 1, and J is one block sum.  Its buffers are sized for
// L <= 512, emit="all"'s cap (pmpx's supports()).  Barriers per
// superstep, counted from the code: 3 shared (the draw, the weights' scan,
// then the count of emit="root" or the positions of emit="all"), the
// weights' max in binary and general (the MP walk hands the weights
// over), plus binary 2 (the log-densities, the pairs' terms), mp 2 (the
// sums, the max), general 5 whatever the depth (S, the group sums, the
// level maxima, the rows, the group totals); emit="all" adds 2 (the draws,
// the jump sum).  emit="root": binary 6, mp 5, general 9; emit="all":
// binary 8, mp 7, general 11.
// Static shared memory (bytes; ptxas's counts, chip_smoke.py phase 1):
// chain_loop holds s_eps (3 x kMaxL floats), the reduction partials, the
// double-buffered root and, for emit="all", EmitBuf (cdf, positions and
// draws of <= 512 slots); binary adds lp and the pair rows (3 kMaxL - 2
// floats), mp four sums' and the max's partials, general S (3 kMaxL
// floats, reused for the lw and e rows), the group sums (4 x 341 floats,
// reused for log T) and the level maxima's partials (depth x 32).  All
// under the 48 KB static cap; no dynamic shared memory.
// Uniforms come either from an in-kernel Philox4x32-10 keyed by a
// per-chunk seed, or (the testable path) from 17 injected rows of L lanes
// per superstep, laid out as pmpx's rng="input": rows 0-7 u1, rows 8-15
// u2, row 16 lane 0 usel; emit="all"'s slot uniforms are one more
// (steps, L) array, slot j on lane j of row t.  Philox counters (x, t, s):
// s = 0, 1 the innovations of node x, s = 2 usel, s = 3 slot x's uniform.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxL = 1024;
constexpr int kMaxWarps = kMaxL / 32;
constexpr int kURows = 17;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kTwoPi = 6.2831853071795865f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -__builtin_huge_valf();

// Phase clocks of a superstep.  Built with PMPX_CHAIN_STAMPS (the stamped
// library, pmpx_torch/_build.py's load(stamps=True)), every thread laps the
// SM's 32-bit clock at each phase boundary and adds the clocks since its
// last lap to that phase's sum (32-bit registers, so that the 1024-thread
// kernels do not spill; a phase's sum wraps after 2^32 clocks, ~2 s);
// thread 0 of block 0 writes its sums to g_chain_stamps at the end of the
// launch, read by pmpx_chain_stamps.  Without the define a lap is empty
// and the kernels compile as before.
// The kWalk* phases are the mode's walk, in order (binary: lp to shared,
// pair softplus, level sum; mp: the four sums, max lw and the weights;
// general: S to shared, group sums, lw and level max, rows, totals, logA
// sum).
enum ChainPhase {
  kPhilox, kBoxMuller, kDrawBarrier, kLogDensity,
  kWalk0, kWalk1, kWalk2, kWalk3, kWalk4, kWalk5,
  kWeightsMax, kWeightsScan, kSelect, kJump, kTrace, kPhases
};

#ifdef PMPX_CHAIN_STAMPS
__device__ unsigned long long g_chain_stamps[kPhases];

__device__ __forceinline__ unsigned sm_clock() {
  unsigned c;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(c));
  return c;
}

struct Clock {
  unsigned last;
  unsigned acc[kPhases];

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int p = 0; p < kPhases; ++p) acc[p] = 0u;
    last = sm_clock();
  }
  __device__ __forceinline__ void lap(int p) {
    const unsigned now = sm_clock();
    acc[p] += now - last;
    last = now;
  }
  __device__ __forceinline__ void write() const {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < kPhases; ++p) g_chain_stamps[p] = acc[p];
    }
  }
};
#else
struct Clock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void write() const {}
};
#endif

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// (0, 1] from the top 24 bits.
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return static_cast<float>((bits >> 8) + 1u) * 5.9604644775390625e-8f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// jax.nn.log_sigmoid(d) = -softplus(-d) = -(max(-d, 0) + sp), given
// sp = log1pf(expf(-|d|)), which d and -d share.
__device__ __forceinline__ float log_sigmoid(float d, float sp) {
  return -(fmaxf(-d, 0.f) + sp);
}

// Sums of K values over the block in a fixed order, one barrier; every
// warp reads all warp partials and reduces them the same way, so all
// threads get the same values.  `buf` must not be written again until a
// later barrier.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K],
                                           float (*buf)[kMaxWarps], int nw) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = warp_sum(v[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) buf[j][threadIdx.x >> 5] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = warp_sum(lane < nw ? buf[j][lane] : 0.f);
}

__device__ __forceinline__ float block_sum(float v, float* buf, int nw) {
  float a[1] = {v};
  block_sums<1>(a, reinterpret_cast<float(*)[kMaxWarps]>(buf), nw);
  return a[0];
}

__device__ __forceinline__ float block_max(float v, float* buf, int nw) {
  const int lane = threadIdx.x & 31;
  v = warp_max(v);
  if (lane == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_max(lane < nw ? buf[lane] : kNegInf);
}

// Maxima of K values over the block in a fixed order, one barrier, as
// block_max does each (K independent shuffle chains).
template <int K>
__device__ __forceinline__ void block_maxes(float (&v)[K],
                                            float (*buf)[kMaxWarps], int nw) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = warp_max(v[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) buf[j][threadIdx.x >> 5] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    v[j] = warp_max(lane < nw ? buf[j][lane] : kNegInf);
  }
}

constexpr int kMaxEmitL = 512;  // emit="all"'s cap on L (pmpx's supports)

struct ChainArgs {
  const int* seed;        // (chains,) Philox keys, or null with uin
  const float* theta_in;  // (chains, 3)
  const float* xg;
  const float* yg;
  int n_slots;
  const float* uin;       // (chains, steps*17, L) or null
  const float* uemit;     // (steps, L) slot uniforms of emit="all", or null
  float* trace;           // (chains, rows, steps); rows 4, or 8 for emit="all"
  float* theta_out;       // (chains, 3)
  float* emit_b0;         // (steps, P) for emit="all"
  int steps;
  int P;
  float n_data;
  float temper;
  float step_size;
};

// The arguments of this block's chain: block c of a farm reads its own
// seed, state and uniforms and writes its own trace and state.
__device__ __forceinline__ ChainArgs chain_of_block(ChainArgs a, int rows,
                                                    int L) {
  const int c = blockIdx.x;
  if (a.seed != nullptr) a.seed += c;
  a.theta_in += 3 * c;
  a.theta_out += 3 * c;
  a.trace += (size_t)c * rows * a.steps;
  if (a.uin != nullptr) a.uin += (size_t)c * a.steps * kURows * L;
  return a;
}

// Innovations of node x for superstep t into eps[r][x] (0 at lanes >= P);
// thread 0 also fetches the selection uniform into *usel.
__device__ __forceinline__ void draw_innovations(const ChainArgs& a, uint2 key,
                                                 int t, int x, int L,
                                                 bool valid,
                                                 float (*eps)[kMaxL],
                                                 float* usel, Clock& clk) {
  float u1[3], u2[3];
  if (a.uin != nullptr) {
    const float* ut = a.uin + (size_t)t * kURows * L;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      u1[r] = ut[(size_t)r * L + x];
      u2[r] = ut[(size_t)(8 + r) * L + x];
    }
    if (x == 0) *usel = ut[(size_t)16 * L];
  } else {
    const uint4 r1 = philox4x32_10(make_uint4(x, t, 0u, 0u), key);
    const uint4 r2 = philox4x32_10(make_uint4(x, t, 1u, 0u), key);
    u1[0] = to_unit(r1.x); u1[1] = to_unit(r1.y); u1[2] = to_unit(r1.z);
    u2[0] = to_unit(r2.x); u2[1] = to_unit(r2.y); u2[2] = to_unit(r2.z);
    if (x == 0) {
      *usel =
          to_unit(philox4x32_10(make_uint4(0xffffffffu, t, 2u, 0u), key).x);
    }
  }
  clk.lap(kPhilox);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float z = sqrtf(-2.f * logf(u1[r])) * cosf(kTwoPi * u2[r]);
    eps[r][x] = valid ? a.step_size * z : 0.f;
  }
  clk.lap(kBoxMuller);
}

// Slot x's uniform of emit="all" for superstep t.
__device__ __forceinline__ float slot_uniform(const ChainArgs& a, uint2 key,
                                              int t, int x, int L) {
  if (a.uin != nullptr) return a.uemit[(size_t)t * L + x];
  return to_unit(philox4x32_10(make_uint4(x, t, 3u, 0u), key).x);
}

struct LinRegStats {
  float sx, sy, sxx, syy, sxy, n_data, temper;

  __device__ __forceinline__ float log_density(float b0, float b1,
                                               float sg) const {
    const float rss = syy + n_data * b0 * b0 + b1 * b1 * sxx +
                      2.f * b0 * b1 * sx - 2.f * b0 * sy - 2.f * b1 * sxy;
    const float s2 = fmaxf(sg * sg, 1e-30f);
    return temper * (-0.5f * n_data * (kLog2Pi + logf(s2)) - rss / (2.f * s2));
  }
};

// The inclusive scan of the weights w (0 at the lanes >= P; within the
// warp, then over warp totals).  One barrier; returns this thread's cdf
// and sum(w) (a reduction, not cdf[-1]), the same in every thread.
struct Cdf {
  float cdf;
  float wsum;
};

__device__ __forceinline__ Cdf weight_cdf(float w, float* s_scan, int nw,
                                          Clock& clk) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float c = w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, c, o);
    if (lane >= o) c += v;
  }
  if (lane == 31) s_scan[warp] = c;
  __syncthreads();
  const float tot = lane < nw ? s_scan[lane] : 0.f;
  float off = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, off, o);
    if (lane >= o) off += v;
  }
  float ex = __shfl_up_sync(kFull, off, 1);
  if (lane == 0) ex = 0.f;
  off = __shfl_sync(kFull, ex, warp);  // sum of the earlier warps' totals
  const Cdf out{c + off, warp_sum(tot)};
  clk.lap(kWeightsScan);
  return out;
}

// One categorical draw: k = #{x < P : cdf[x] < usel * sum(w)} clamped to
// P - 1.  Two barriers; all threads return the same k.
__device__ __forceinline__ int select_node(float w, bool valid, int P,
                                           const float* usel, float* s_scan,
                                           int nw, Clock& clk) {
  const Cdf c = weight_cdf(w, s_scan, nw, clk);
  const float u = *usel * c.wsum;
  const int cnt = __syncthreads_count(valid && c.cdf < u);
  clk.lap(kSelect);
  return min(cnt, P - 1);
}

// Shared memory of emit="all": the positions and cdf of every node, and
// every slot's draw.  Empty for emit="root".
template <bool kAll>
struct EmitBuf {
  float cdf[kMaxEmitL];
  float pos[3][kMaxEmitL];
  float sel[3][kMaxEmitL];
  float jsum[kMaxWarps];
};

template <>
struct EmitBuf<false> {};

// The chain loop the three modes share.  Walk provides
//   offset(x, eps, S):     S[x] from the innovations in shared memory
//   log_accept(x, valid, S, lp, clk):
//                          logA of node x (all threads call it: it may hold
//                          barriers), whose weight the loop forms as
//                          exp(logA - max logA); or, if Walk::kHandsWeights,
//                          node x's weight itself (0 at lanes >= P)
template <bool kAll, class Walk>
__device__ __forceinline__ void chain_loop(ChainArgs a, const Walk& walk) {
  __shared__ float s_eps[3][kMaxL];
  __shared__ float s_stat[5][kMaxWarps];
  __shared__ float s_max[kMaxWarps];
  __shared__ float s_scan[kMaxWarps];
  __shared__ float s_theta[2][3];
  __shared__ float s_usel;
  __shared__ EmitBuf<kAll> s_em;

  const int x = threadIdx.x;
  const int L = blockDim.x;
  const int nw = L >> 5;
  const bool valid = x < a.P;
  const int rows = kAll ? 8 : 4;
  a = chain_of_block(a, rows, L);

  // Sufficient statistics over the padded grids (zeros add nothing).
  float st[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = x; i < a.n_slots; i += L) {
    const float xv = a.xg[i];
    const float yv = a.yg[i];
    st[0] += xv;
    st[1] += yv;
    st[2] += xv * xv;
    st[3] += yv * yv;
    st[4] += xv * yv;
  }
  block_sums<5>(st, s_stat, nw);
  const LinRegStats lik{st[0], st[1], st[2], st[3], st[4], a.n_data, a.temper};

  if (x < 3) s_theta[0][x] = a.theta_in[x];
  const uint2 key = make_uint2(a.seed ? static_cast<uint32_t>(*a.seed) : 0u,
                               0x5bd1e995u);
  __syncthreads();

  Clock clk;
  clk.start();
  for (int t = 0; t < a.steps; ++t) {
    draw_innovations(a, key, t, x, L, valid, s_eps, &s_usel, clk);
    float ue = 0.f;
    if constexpr (kAll) {
      if (valid) ue = slot_uniform(a, key, t, x, L);
      clk.lap(kPhilox);
    }
    __syncthreads();
    clk.lap(kDrawBarrier);

    const float* th = s_theta[t & 1];
    float S[3];
    walk.offset(x, s_eps, S);
    const float b0 = th[0] + S[0];
    const float b1 = th[1] + S[1];
    const float sg = th[2] + S[2];
    const float logpi = lik.log_density(b0, b1, sg);
    clk.lap(kLogDensity);
    const float la = walk.log_accept(x, valid, S, logpi, clk);
    float w = la;
    if constexpr (!Walk::kHandsWeights) {
      const float m = block_max(valid ? la : kNegInf, s_max, nw);
      w = valid ? expf(la - m) : 0.f;
    }
    clk.lap(kWeightsMax);
    float* nx = s_theta[(t + 1) & 1];

    if constexpr (!kAll) {
      const int k = select_node(w, valid, a.P, &s_usel, s_scan, nw, clk);
      if (x == k) {
        nx[0] = b0;
        nx[1] = b1;
        nx[2] = sg;
        a.trace[t] = b0;
        a.trace[a.steps + t] = b1;
        a.trace[2 * a.steps + t] = sg;
        a.trace[3 * a.steps + t] = static_cast<float>(k);
      }
    } else {
      const Cdf c = weight_cdf(w, s_scan, nw, clk);
      if (valid) {
        s_em.cdf[x] = c.cdf;
        s_em.pos[0][x] = b0;
        s_em.pos[1][x] = b1;
        s_em.pos[2][x] = sg;
      }
      __syncthreads();
      // slot x's draw: the lower bound of ue * sum(w) in the cdf, i.e.
      // the count of cdf entries below it
      float sel[3] = {0.f, 0.f, 0.f};
      int kx = 0;
      if (valid) {
        const float thr = ue * c.wsum;
        int lo = 0, hi = a.P;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_em.cdf[mid] < thr) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        kx = min(lo, a.P - 1);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          sel[r] = s_em.pos[r][kx];
          s_em.sel[r][x] = sel[r];
        }
        a.emit_b0[(size_t)t * a.P + x] = sel[0];
      }
      __syncthreads();
      clk.lap(kSelect);
      float jump = 0.f;
      if (valid && x > 0) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float d = sel[r] - s_em.sel[r][x - 1];
          jump += d * d;
        }
      }
      const float J = block_sum(jump, s_em.jsum, nw);
      clk.lap(kJump);
      if (x == 0) {
        nx[0] = sel[0];
        nx[1] = sel[1];
        nx[2] = sel[2];
        a.trace[t] = sel[0];
        a.trace[a.steps + t] = sel[1];
        a.trace[2 * a.steps + t] = sel[2];
        a.trace[3 * a.steps + t] = J;
        a.trace[7 * a.steps + t] = static_cast<float>(kx);
      }
      if (x == a.P - 1) {
        a.trace[4 * a.steps + t] = sel[0];
        a.trace[5 * a.steps + t] = sel[1];
        a.trace[6 * a.steps + t] = sel[2];
      }
    }
    clk.lap(kTrace);
  }
  clk.write();
  __syncthreads();
  if (x < 3) a.theta_out[x] = s_theta[a.steps & 1][x];
}

// Binary tree: the Barker walk up the ancestors.  Level i's sibling
// pairs are (a, a + 2^i) for a < 2^i, P - 1 pairs over all levels.  Thread
// x in [1, P) takes the pair whose upper sibling is x (level i = log2 x):
// it evaluates the pair's softplus once and stores both siblings'
// log-sigmoid in ls; then every node sums its depth terms from ls, level 0
// first.  One transcendental pair per sibling pair instead of one per
// (node, level): P - 1 instead of P depth.
//
// logA stays bit for bit what the per-node walk gave, which evaluated
// -(fmaxf(-d', 0) + log1pf(expf(-|d'|))) for d' = lp[a_i] - lp[a_i ^ 2^i]
// at every level and summed the terms in level order from 0: for a pair
// (a, b), d = lp[a] - lp[b] and lp[b] - lp[a] is exactly -d (IEEE
// subtraction rounds the same either way round), so both siblings'
// log1pf(expf(-|d'|)) is the one value sp, and log_sigmoid(d, sp) and
// log_sigmoid(-d, sp) are each sibling's own operations on the same
// operands.  The sums then add the same terms in the same order.
struct BinaryWalk {
  static constexpr bool kHandsWeights = false;
  int depth;
  float* lp;  // [kMaxL] log-densities
  float* ls;  // [2 kMaxL - 2] log-sigmoid terms: level i's node v < 2^(i+1)
              // at (2 << i) - 2 + v

  __device__ __forceinline__ void offset(int x, float (*eps)[kMaxL],
                                         float (&S)[3]) const {
    S[0] = S[1] = S[2] = 0.f;
    for (int i = 0; i < depth; ++i) {
      if ((x >> i) & 1) {
        const int anc = x & ((2 << i) - 1);
#pragma unroll
        for (int r = 0; r < 3; ++r) S[r] += eps[r][anc];
      }
    }
  }

  __device__ __forceinline__ float log_accept(int x, bool valid,
                                              const float (&)[3], float logpi,
                                              Clock& clk) const {
    lp[x] = logpi;
    __syncthreads();
    clk.lap(kWalk0);
    if (x > 0 && x < (1 << depth)) {
      const int i = 31 - __clz(x);
      const int lo = x - (1 << i);
      const float d = lp[lo] - lp[x];
      const float sp = log1pf(expf(-fabsf(d)));
      float* row = ls + (2 << i) - 2;
      row[lo] = log_sigmoid(d, sp);
      row[x] = log_sigmoid(-d, sp);
    }
    __syncthreads();
    clk.lap(kWalk1);
    float logA = 0.f;
    if (valid) {
      for (int i = 0; i < depth; ++i) {
        logA += ls[(2 << i) - 2 + (x & ((2 << i) - 1))];
      }
    }
    clk.lap(kWalk2);
    return logA;
  }
};

// Flat MTM: one sibling group of all P nodes.  The walk hands the loop the
// weights themselves, w = exp(lw - m) with m = max lw over the valid lanes:
// logA = lw - (m + log sum exp(lw - m)) only shifts lw by a constant, which
// exp(logA - max logA) takes out again, so the exp-sum, its block
// reduction and barrier, its log and the weights' own max and exp are not
// needed (the scan's total is sum(w)).  The weights differ from the plain
// version's by the roundings of that shift (a few ulps of the exp's
// argument), so a draw can flip where u sum(w) falls within them of a cdf
// edge.
struct MPWalk {
  static constexpr bool kHandsWeights = true;
  int P;
  float denom;                // 2 sigma_t^2 norm
  float (*sums)[kMaxWarps];   // [4][kMaxWarps]
  float* red_max;             // [kMaxWarps]
  int nw;

  __device__ __forceinline__ void offset(int x, float (*eps)[kMaxL],
                                         float (&S)[3]) const {
#pragma unroll
    for (int r = 0; r < 3; ++r) S[r] = x != 0 ? eps[r][x] : 0.f;
  }

  __device__ __forceinline__ float log_accept(int, bool valid,
                                              const float (&S)[3], float logpi,
                                              Clock& clk) const {
    const float sq = S[0] * S[0] + S[1] * S[1] + S[2] * S[2];
    float g[4] = {valid ? S[0] : 0.f, valid ? S[1] : 0.f,
                  valid ? S[2] : 0.f, valid ? sq : 0.f};
    block_sums<4>(g, sums, nw);
    clk.lap(kWalk0);
    const float cross = S[0] * g[0] + S[1] * g[1] + S[2] * g[2];
    const float d2 = static_cast<float>(P) * sq - 2.f * cross + g[3];
    const float lw = logpi - d2 / denom;
    const float m = block_max(valid ? lw : kNegInf, red_max, nw);
    const float w = valid ? expf(lw - m) : 0.f;
    clk.lap(kWalk1);
    return w;
  }
};

// General (N, depth) tree with a power-of-two base N + 1 = 2^lb (lb >= 2,
// so 2 <= depth <= kMaxDepth: a template parameter, and every level loop
// below is straight-line code).  Each sibling group's work is done once,
// by one thread, for all levels in one pass: thread g < sum_i base^i takes
// group slot g, the groups of level i holding slots [goff_i, goff_i +
// base^i), goff_i = sum_{k<i} base^k (its level gl and residue gh are
// fixed per launch).  Per superstep, five barriers whatever the depth:
//   1. every node stores S;
//   2. each group thread forms G_h and Q_h over its base members;
//   3. every node forms lw_i for each level it is in (x < base^(i+1)), and
//      one block reduction gives every level's max zm_i at once;
//   4. every node stores lw_i and e = exp(lw_i - zm_i) into the rows;
//   5. each group thread forms T_h and log T_h;
// then every node sums its depth terms in level order.  The rows of level
// i start at roff_i = base goff_i; they overwrite S, which no one reads
// after barrier 2, and log T overwrites G_h, which no one reads after
// barrier 3.
//
// logA stays bit for bit what the per-member walk gave, where every member
// formed its group's sums, total and log itself at each level (one block
// max and two barriers a level): the group sums run over the same members
// in the same j order with the same expressions; lw_i and its cross term
// are the same expressions of the same operands, with base |S|^2 rounded
// on its own (never fused into the subtraction), as the per-member walk's
// level loop rounded it; a max is exact whatever
// the order; T_h, its clamp, its log and logA + lw - zm - log T are the
// same operations in the same order.
constexpr int kMaxDepth = 5;
constexpr int kMaxGroups = 341;  // sum_{i<depth} base^i at base 4, depth 5
constexpr int kMaxRows = 1364;   // sum_{i<depth} base^(i+1), the same tree

template <int kDepth>
struct GeneralWalk {
  static_assert(kDepth >= 2 && kDepth <= kMaxDepth, "general depth");
  static constexpr bool kHandsWeights = false;
  int base;
  int lb;  // log2(base)
  float denom;               // 2 sigma_t^2 norm
  int gl;                    // this thread's group: level (kDepth if none)
  int gh;                    // and residue h < base^gl
  float (*Ssh)[kMaxL];       // [3][kMaxL] offsets S; then, flat, the lw
                             // rows at [0, kMaxRows), the e rows after them
  float (*grp)[kMaxGroups];  // [4][kMaxGroups] G_h (3) and Q_h by group
                             // slot; then log T_h in grp[0]
  float (*red)[kMaxWarps];   // [kDepth][kMaxWarps] the level maxima
  int nw;

  __device__ __forceinline__ void offset(int x, float (*eps)[kMaxL],
                                         float (&S)[3]) const {
    S[0] = S[1] = S[2] = 0.f;
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      if ((x >> (lb * i)) & (base - 1)) {
        const int anc = x & ((1 << (lb * (i + 1))) - 1);
#pragma unroll
        for (int r = 0; r < 3; ++r) S[r] += eps[r][anc];
      }
    }
  }

  __device__ __forceinline__ float log_accept(int x, bool valid,
                                              const float (&S)[3], float logpi,
                                              Clock& clk) const {
#pragma unroll
    for (int r = 0; r < 3; ++r) Ssh[r][x] = S[r];
    __syncthreads();
    clk.lap(kWalk0);
    const int gtemp = 1 << (lb * gl);
    if (gl < kDepth) {
      // the sibling group of residue gh: members gh + j gtemp, j < base
      float g0 = 0.f, g1 = 0.f, g2 = 0.f, q = 0.f;
      for (int j = 0; j < base; ++j) {
        const int b = gh + j * gtemp;
        const float s0 = Ssh[0][b], s1 = Ssh[1][b], s2 = Ssh[2][b];
        g0 += s0;
        g1 += s1;
        g2 += s2;
        q += s0 * s0 + s1 * s1 + s2 * s2;
      }
      grp[0][x] = g0;
      grp[1][x] = g1;
      grp[2][x] = g2;
      grp[3][x] = q;
    }
    __syncthreads();
    clk.lap(kWalk1);
    const float sq = S[0] * S[0] + S[1] * S[1] + S[2] * S[2];
    const float bsq = static_cast<float>(base) * sq;
    float lw[kDepth], zm[kDepth];
#pragma unroll
    for (int i = 0, temp = 1, goff = 0; i < kDepth; ++i) {
      lw[i] = kNegInf;
      if (x < temp << lb) {
        const int g = goff + (x & (temp - 1));
        const float cross = S[0] * grp[0][g] + S[1] * grp[1][g] +
                            S[2] * grp[2][g];
        const float gd2 = bsq - 2.f * cross + grp[3][g];
        lw[i] = logpi - gd2 / denom;
      }
      zm[i] = lw[i];
      goff += temp;
      temp <<= lb;
    }
    block_maxes<kDepth>(zm, red, nw);
    clk.lap(kWalk2);
    float* lw_row = &Ssh[0][0];
    float* e_row = lw_row + kMaxRows;
#pragma unroll
    for (int i = 0, temp = 1, goff = 0; i < kDepth; ++i) {
      if (x < temp << lb) {
        const int at = (goff << lb) + x;
        lw_row[at] = lw[i];
        e_row[at] = expf(lw[i] - zm[i]);
      }
      goff += temp;
      temp <<= lb;
    }
    __syncthreads();
    clk.lap(kWalk3);
    if (gl < kDepth) {
      const float* e = e_row + ((x - gh) << lb);
      float T = 0.f;
      for (int j = 0; j < base; ++j) T += e[gh + j * gtemp];
      T = fmaxf(T, 1e-30f);
      grp[0][x] = logf(T);
    }
    __syncthreads();
    clk.lap(kWalk4);
    float logA = 0.f;
    if (valid) {
#pragma unroll
      for (int i = 0, temp = 1, goff = 0; i < kDepth; ++i) {
        logA = logA + lw_row[(goff << lb) + (x & ((temp << lb) - 1))] -
               zm[i] - grp[0][goff + (x & (temp - 1))];
        goff += temp;
        temp <<= lb;
      }
    }
    clk.lap(kWalk5);
    return logA;
  }
};

// The group slot of thread x: level *gl and residue *gh, or *gl = depth
// for a thread past the last group.
__device__ __forceinline__ void group_slot(int x, int lb, int depth, int* gl,
                                           int* gh) {
  int g = x, temp = 1, i = 0;
  while (i < depth && g >= temp) {
    g -= temp;
    temp <<= lb;
    ++i;
  }
  *gl = i;
  *gh = g;
}

template <bool kAll>
__global__ void __launch_bounds__(kAll ? kMaxEmitL : kMaxL)
chain_binary_kernel(ChainArgs a, int depth) {
  __shared__ float s_lp[kMaxL];
  __shared__ float s_ls[2 * kMaxL - 2];
  chain_loop<kAll>(a, BinaryWalk{depth, s_lp, s_ls});
}

template <bool kAll>
__global__ void __launch_bounds__(kAll ? kMaxEmitL : kMaxL)
chain_mp_kernel(ChainArgs a, float denom) {
  __shared__ float s_sums[4][kMaxWarps];
  __shared__ float s_rmax[kMaxWarps];
  chain_loop<kAll>(a, MPWalk{a.P, denom, s_sums, s_rmax,
                             static_cast<int>(blockDim.x >> 5)});
}

template <bool kAll, int kDepth>
__global__ void __launch_bounds__(kAll ? kMaxEmitL : kMaxL)
chain_general_kernel(ChainArgs a, int base, int lb, float denom) {
  __shared__ float s_S[3][kMaxL];
  __shared__ float s_grp[4][kMaxGroups];
  __shared__ float s_rmax[kDepth][kMaxWarps];
  int gl, gh;
  group_slot(threadIdx.x, lb, kDepth, &gl, &gh);
  chain_loop<kAll>(a, GeneralWalk<kDepth>{base, lb, denom, gl, gh, s_S, s_grp,
                                          s_rmax,
                                          static_cast<int>(blockDim.x >> 5)});
}

enum Mode { kBinary = 0, kMP = 1, kGeneral = 2 };

// Whether (mode, base, depth) describes P nodes; sets *lb = log2(base).
bool valid_tree(int mode, int P, int base, int depth, int* lb) {
  *lb = 0;
  while ((1 << *lb) < base) ++*lb;
  switch (mode) {
    case kBinary:
      return base == 2 && depth >= 1 && depth <= 10 && (1 << depth) == P;
    case kMP:
      return depth == 1 && base == P;
    case kGeneral:
      return base >= 4 && (1 << *lb) == base && depth >= 2 &&
             *lb * depth <= 10 && (1 << (*lb * depth)) == P;
    default:
      return false;
  }
}

template <bool kAll>
void launch(int mode, int chains, int L, const ChainArgs& a, int base,
            int lb, int depth, float denom, cudaStream_t stream) {
  switch (mode) {
    case kBinary:
      chain_binary_kernel<kAll><<<chains, L, 0, stream>>>(a, depth);
      break;
    case kMP:
      chain_mp_kernel<kAll><<<chains, L, 0, stream>>>(a, denom);
      break;
    default:
      switch (depth) {  // valid_tree: 2 <= depth <= 5
        case 2:
          chain_general_kernel<kAll, 2><<<chains, L, 0, stream>>>(a, base, lb,
                                                                 denom);
          break;
        case 3:
          chain_general_kernel<kAll, 3><<<chains, L, 0, stream>>>(a, base, lb,
                                                                 denom);
          break;
        case 4:
          chain_general_kernel<kAll, 4><<<chains, L, 0, stream>>>(a, base, lb,
                                                                 denom);
          break;
        default:
          chain_general_kernel<kAll, 5><<<chains, L, 0, stream>>>(a, base, lb,
                                                                 denom);
      }
  }
}

}  // namespace

extern "C" {

// Runs one chunk of `steps` supersteps of `chains` independent chains, one
// block of `L` threads each (P rounded up to 128, at most 1024).
//   mode: 0 binary (base 2), 1 flat MP (depth 1, base = P), 2 general
//         (base a power of two >= 4, depth 2-5); P = base^depth.
//   emit_all: 0 for emit="root" (trace (chains, 4, steps)), 1 for
//         emit="all" (one chain, L <= 512; trace (8, steps), emit_b0
//         (steps, P)).
//   seed: (chains,) int32 Philox keys, with uin and uemit null; or
//   uin: (chains, steps*17, L) injected uniforms, and for emit="all"
//         uemit: (steps, L) the slot uniforms.
//   theta_in, theta_out: (chains, 3), (beta0, beta1, sigma).
//   denom: 2 trans_sigma^2 trans_norm (mp and general; binary ignores it).
// Launches on `stream`, does not synchronize, and returns the launch's
// cudaError_t.
int pmpx_fused_chain(int mode, int emit_all, int chains, const int* seed,
                     const float* theta_in, const float* xg, const float* yg,
                     int n_slots, const float* uin, const float* uemit,
                     float* trace, float* theta_out, float* emit_b0,
                     int steps, int P, int L, int base, int depth,
                     float n_data, float temper, float step_size, float denom,
                     void* stream) {
  int lb = 0;
  const bool shape_ok = L >= 32 && L <= kMaxL && !(L & 31) && P <= L &&
                        P >= 2 && steps >= 1 && chains >= 1 &&
                        chains <= 65535;
  const bool rng_ok = (uin != nullptr) != (seed != nullptr) &&
                      (!emit_all || (uin != nullptr) == (uemit != nullptr));
  const bool emit_ok = !emit_all || (chains == 1 && L <= kMaxEmitL &&
                                     emit_b0 != nullptr);
  if (!shape_ok || !rng_ok || !emit_ok ||
      !valid_tree(mode, P, base, depth, &lb) ||
      (mode != kBinary && !(denom > 0.f))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ChainArgs a{seed,    theta_in, xg,    yg,     n_slots,
                    uin,     uemit,    trace, theta_out, emit_b0,
                    steps,   P,        n_data, temper, step_size};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emit_all) {
    launch<true>(mode, chains, L, a, base, lb, depth, denom, s);
  } else {
    launch<false>(mode, chains, L, a, base, lb, depth, denom, s);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef PMPX_CHAIN_STAMPS
// The stamped library only: copies the last launch's phase clocks (block 0,
// thread 0; kPhases unsigned 64-bit sums over its supersteps, in
// ChainPhase's order) to the device buffer `dst` on `stream`, after that
// launch.  Returns the copy's cudaError_t.
int pmpx_chain_stamps(void* dst, void* stream) {
  return static_cast<int>(cudaMemcpyFromSymbolAsync(
      dst, g_chain_stamps, sizeof(g_chain_stamps), 0,
      cudaMemcpyDeviceToDevice, static_cast<cudaStream_t>(stream)));
}
#endif

}  // extern "C"
