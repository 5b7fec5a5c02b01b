// Mamba-2's SSD scan for many sequences in one launch.
//
// Replaces no TPU kernel: pmpx has no Mamba-2.  The state-space mixer of a
// Mamba-2 layer (pmpx_torch/models/granite_hybrid.py) runs, per sequence s
// and head h, the recurrence
//
//     S_t = exp(dt_t * A) * S_{t-1} + dt_t * x_t (outer) B_t,
//     y_t = S_t C_t + D * x_t,
//
// with S (head_dim, d_state) from S_0 = 0, dt_t > 0 and A < 0.  A PMP
// superstep runs it for P proposals of B sequences each, every proposal with
// its own A and D: 32 sequences x 64 heads x 4,096 positions a layer at
// granite-4.0-h-micro's widths (head_dim 64, d_state 128).
//
// What bounds it on the H100: per head and position ~5 * 64 * 128 flops
// against 2 bytes a channel of x and y, about 80 flops a byte; one pass over
// x, B, C and dt, nothing written but y.  The dependence runs along t only,
// so the kernel walks each (sequence, head) in one block of 8 warps with the
// (64, 128) state in float32 registers.  A warp holds 8 rows of it, lane l
// the entries n = 4l .. 4l + 3 of each: each position's B_t and C_t are one
// float4 a lane (all lanes distinct, so the shared memory serves a whole row
// in one pass), and what the warp shares is a row's coefficient, one float a
// row.  y_t[p] sums over the lanes: lane l keeps row 8 w + (k ^ (l / 4)) in
// register k, so three halving shuffle levels (offsets 16, 8, 4: the
// partner's register k + half holds the same row) and two more (offsets 2,
// 1) leave row l / 4's sum in its four lanes, with no select.  The block
// stages its global loads a batch at a time and walks four positions a pass
// of its loop, and two blocks share an SM (128 registers a thread, none
// spilled): of the layouts tried on an H100 (16 rows a warp, one to four
// blocks an SM, passes of one to sixteen positions) the fastest at the
// granite cell's shape, still latency-bound (see PERF.md).
//
// One multiply a state entry and position is saved by carrying R = S / e^c,
// c the log-decay since R's base (c <= 0): then
//
//     R_t = R_{t-1} + (e^{-c_t} dt_t x_t) (outer) B_t,  y_t = e^{c_t} R_t C_t,
//
// an fma for R and one for y a state entry.  Where the decay since the base
// would pass e^-kRebase, that step folds it into R (R *= e^{c_{t-1} + a_t},
// the decayed state, exactly as the recurrence's product) and starts a new
// base, so no factor ever exceeds e^kRebase and every one is float32.  The
// base's walk along t is one lane's, for a chunk of kChunk positions staged
// in shared memory with x, e^{-c_t} dt_t x_t, B, C and the factors; y
// overwrites the scaled x there and goes out at the chunk's end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kState = 128;           // 4 entries a lane
constexpr int kChunk = 16;            // positions staged a pass
constexpr int kRows = 8;              // rows of the state a warp holds
constexpr int kShare = 32 / kRows;   // lanes that end with a row's sum
constexpr int kWarps = kHeadDim / kRows;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 2;       // <= 128 registers a thread
constexpr float kRebase = 30.f;       // e^30 ~ 1.1e13
constexpr unsigned kFull = 0xffffffffu;

// strides, in elements, of x (s, t, h, p), dt (s, t, h), B and C (s, t, n)
// and y (s, t, h, p)
struct Strides {
  long long x[4], dt[3], b[3], c[3], y[4];
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Copies kCount elements a thread of a chunk (kChunk, kWidth) from global
// memory (row t at t * st_t, element i at i * st_i; zeros from row len) to
// dst as float32, all of its loads issued before the first store: a chunk's
// staging waits on a few round trips to memory, not on one an element.
template <int kCount, int kWidth, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long st_t, long long st_i,
                                      int len) {
  float v[kCount];
#pragma unroll
  for (int j = 0; j < kCount; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int t = e / kWidth, i = e % kWidth;
    v[j] = t < len ? load_f(src + t * st_t + i * st_i) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kCount; ++j) dst[threadIdx.x + j * kThreads] = v[j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
mamba2_ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ B,
                  const T* __restrict__ C, const float* __restrict__ D,
                  T* __restrict__ y, int T_len, int H, Strides st) {
  __shared__ float4 s_b[kChunk][kState / 4];
  __shared__ float4 s_c[kChunk][kState / 4];
  __shared__ float s_x[kChunk][kHeadDim];
  __shared__ float s_u[kChunk][kHeadDim];  // e^{-c} dt x in, y out
  __shared__ float s_g[kChunk], s_e[kChunk], s_f[kChunk];  // e^{-c} dt,
                                                         // e^c, the fold
  __shared__ float s_a[kChunk], s_cum[kChunk], s_fold[kChunk];

  const int s = blockIdx.x / H;
  const int h = blockIdx.x - s * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int m = lane / kShare;
  const int row0 = (tid >> 5) * kRows;
  const float a_coef = A[blockIdx.x];
  const float d_coef = D[blockIdx.x];
  const T* xs = x + s * st.x[0] + h * st.x[2];
  const float* dts = dt + s * st.dt[0] + h * st.dt[2];
  const T* bs = B + s * st.b[0];
  const T* cs = C + s * st.c[0];
  T* ys = y + s * st.y[0] + h * st.y[2];
  float* sb = reinterpret_cast<float*>(s_b);
  float* sc = reinterpret_cast<float*>(s_c);
  float* sx = &s_x[0][0];
  float* su = &s_u[0][0];

  float4 r[kRows];  // r[k]: row row0 + (k ^ m), entries 4 lane .. + 3
#pragma unroll
  for (int k = 0; k < kRows; ++k) r[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  float carry = 0.f;  // thread 0's: c before the chunk

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int len = min(kChunk, T_len - t0);
    // stage the chunk (zeros past T) and its factors
    const float dtv =
        tid < kChunk && tid < len ? dts[(t0 + tid) * st.dt[1]] : 0.f;
    stage<kChunk * kHeadDim / kThreads, kHeadDim>(
        sx, xs + t0 * st.x[1], st.x[1], st.x[3], len);
    // B and C a half chunk at a time: the loads in flight fit the
    // registers beside the state
#pragma unroll
    for (int h0 = 0; h0 < kChunk; h0 += kChunk / 2) {
      stage<kChunk * kState / 2 / kThreads, kState>(
          sb + h0 * kState, bs + (t0 + h0) * st.b[1], st.b[1], st.b[2],
          len - h0);
      stage<kChunk * kState / 2 / kThreads, kState>(
          sc + h0 * kState, cs + (t0 + h0) * st.c[1], st.c[1], st.c[2],
          len - h0);
    }
    if (tid < 32) {
      if (lane < kChunk) s_a[lane] = dtv * a_coef;
      __syncwarp();
      if (lane == 0) {  // past len a is 0: no fold, c unchanged
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const float next = carry + s_a[i];
          if (next < -kRebase) {
            s_fold[i] = next;  // fold e^{next} into R; a new base
            carry = 0.f;
          } else {
            s_fold[i] = 1.f;  // no fold (a fold's log is < -kRebase)
            carry = next;
          }
          s_cum[i] = carry;
        }
      }
      __syncwarp();
      if (lane < kChunk) {
        const float c = s_cum[lane], f = s_fold[lane];
        s_g[lane] = expf(-c) * dtv;
        s_e[lane] = expf(c);
        s_f[lane] = f > 0.f ? 1.f : expf(f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = tid; e < kChunk * kHeadDim; e += kThreads) {
      su[e] = s_g[e / kHeadDim] * sx[e];
    }
    __syncthreads();

    // all kChunk positions (past len x is 0 and a is 0, so R keeps its
    // value), four a pass so one's shuffles overlap the next one's fmas
#pragma unroll 4
    for (int t = 0; t < kChunk; ++t) {
      const float f = s_f[t];
      if (f != 1.f) {  // the same for the whole block
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          r[k].x *= f;
          r[k].y *= f;
          r[k].z *= f;
          r[k].w *= f;
        }
      }
      const float4 b = s_b[t][lane];
      const float4 c = s_c[t][lane];
      float acc[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float u = s_u[t][row0 + (k ^ m)];
        r[k].x = fmaf(u, b.x, r[k].x);
        r[k].y = fmaf(u, b.y, r[k].y);
        r[k].z = fmaf(u, b.z, r[k].z);
        r[k].w = fmaf(u, b.w, r[k].w);
        acc[k] = fmaf(r[k].w, c.w,
                      fmaf(r[k].z, c.z, fmaf(r[k].y, c.y, r[k].x * c.x)));
      }
      // halve the rows a lane sums over lane bits 4, 3, ...: the partner's
      // register k + half holds the same row as this lane's register k
#pragma unroll
      for (int half = kRows / 2, o = 16; half >= 1; half /= 2, o /= 2) {
#pragma unroll
        for (int k = 0; k < half; ++k) {
          acc[k] += __shfl_xor_sync(kFull, acc[k + half], o);
        }
      }
      // then row m's sum over the lanes that share it
#pragma unroll
      for (int o = kShare / 2; o >= 1; o /= 2) {
        acc[0] += __shfl_xor_sync(kFull, acc[0], o);
      }
      // every lane has read row row0 + m's coefficient: each one's sum for
      // that row is in acc[0]'s
      if (lane % kShare == 0) {
        su[t * kHeadDim + row0 + m] =
            fmaf(s_e[t], acc[0], d_coef * sx[t * kHeadDim + row0 + m]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int e = tid; e < kChunk * kHeadDim; e += kThreads) {
      const int t = e / kHeadDim, i = e % kHeadDim;
      if (t < len) store_f(ys + (t0 + t) * st.y[1] + i * st.y[3], su[e]);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// y (S, T, H, 64) = the SSD scan of x (S, T, H, 64) with dt (S, T, H), A and
// D (S, H), B and C (S, T, 128), in float32 (bf16 0) or bfloat16 (bf16 1)
// for x, B, C and y; dt, A, D float32, A and D contiguous.  strides (host
// memory) holds the 17 element strides of x, dt, B, C and y in that order.
// Launches on `stream`, does not synchronize, and returns the launch's
// cudaError_t.
int pmpx_mamba2_ssd(const void* x, const float* dt, const float* A,
                    const void* B, const void* C, const float* D, void* y,
                    int S, int T, int H, int head_dim, int d_state, int bf16,
                    const long long* strides, void* stream) {
  if (S < 1 || T < 1 || H < 1 || head_dim != kHeadDim || d_state != kState ||
      static_cast<long long>(S) * H > 0x7fffffffLL || strides == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  long long* dst[] = {st.x, st.dt, st.b, st.c, st.y};
  const int len[] = {4, 3, 3, 3, 4};
  for (int a = 0, i = 0; a < 5; ++a) {
    for (int j = 0; j < len[a]; ++j) dst[a][j] = strides[i++];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(S * H);
  if (bf16) {
    mamba2_ssd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), dt, A,
        static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(C), D,
        static_cast<__nv_bfloat16*>(y), T, H, st);
  } else {
    mamba2_ssd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
        static_cast<const float*>(C), D, static_cast<float*>(y), T, H, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
