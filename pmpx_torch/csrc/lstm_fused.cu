// Final hidden state of a zero-carry LSTM for P parameter sets over one
// shared time-major input: the MNIST-LSTM posterior's forward pass.
//
// Replaces the Pallas TPU kernel pmpx/kernels/lstm_fused.py:_kernel (host
// wrapper lstm_final_hidden).  For every parameter set p and example b,
//
//     z_t  = x_t Wx[p] + h_{t-1} Wh[p] + bias[p]      gate columns [i|f|g|o]
//     c_t  = sig(z_f) c_{t-1} + sig(z_i) tanh(z_g)
//     h_t  = sig(z_o) tanh(c_t)                       h_0 = c_0 = 0
//
// and out[p, b] = h_T.  T = 28 steps of F = 28 pixels, H = 64 units.  In
// bf16 mode x, Wx and Wh are bf16, every sum is f32, and h is rounded to
// bf16 before each hidden product (pmpx's h.astype(dt)); the bias, c and
// the output h_T stay f32.  The products of two bf16 values are exact in
// f32, so the plain version (kernels/lstm_fused.py) rounds at the same
// places.
//
// What bounds it on the H100: arithmetic.  8 H (F + H) T flops per
// parameter set and example, 0.63 TFLOP at P = 8 over the full batch of
// 60,000: 9.4 ms at 67 TFLOP/s f32 on the CUDA cores, against 0.19 GB of
// device memory (x read once, weights, h_T).  The recurrence runs in the
// block: h, c and the gate pre-activations never leave the SM, and only
// h_T is written.
//
// Design: one block per (batch tile of kTB rows, p), p fastest in the grid
// so that the P blocks of one x tile run together and read it from L2 (the
// TPU kernel's "P innermost").  Thread j of the 4H = 256 threads owns gate
// column j: its columns of Wx and Wh (92 floats) sit in registers for the
// whole recurrence, and each step it forms z[r][j] for the tile's rows from
// shared-memory rows of x_t and h (broadcast float4 reads), kR rows at a
// time.  After a barrier the same threads apply the cell update to the
// tile's (row, unit) pairs, 16 each, with c in registers, write h back to
// shared memory and stage x_{t+1}.  Shared memory per block: x_t, h and z
// of the tile, 89,088 bytes, above the 48 KiB static limit, so the launch
// raises the kernel's dynamic shared-memory limit first.  Rows past B
// (the ragged last tile) compute on zeros and are not stored.  Precise
// expf and tanhf (no --use_fast_math).  Tensor cores (mma/wgmma) and TMA
// of the x tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF = 28;                 // features per step
constexpr int kH = 64;                 // hidden units
constexpr int kG = 4 * kH;             // gate columns = threads per block
constexpr int kTB = 64;                // batch rows per block
constexpr int kR = 8;                  // rows per register tile of z
constexpr int kPairs = kTB * kH / kG;  // (row, unit) pairs per thread
constexpr size_t kSmemBytes = sizeof(float) * kTB * (kF + kH + kG);

static_assert(kF % 4 == 0 && kH % 4 == 0, "float4 rows");
static_assert(kTB % kR == 0 && kG % kH == 0, "tile shapes");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// h as the next hidden product reads it: in the input type.
__device__ __forceinline__ float round_h(float v, const float*) { return v; }
__device__ __forceinline__ float round_h(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

template <typename T>
__global__ void __launch_bounds__(kG, 1)
lstm_fused_kernel(const T* __restrict__ x, const T* __restrict__ wx,
                  const T* __restrict__ wh, const float* __restrict__ bias,
                  float* __restrict__ out, int steps, int B, int P) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // (kTB, kF)   x_t
  float* hs = xs + kTB * kF;                    // (kTB, kH)   h, rounded
  float* zs = hs + kTB * kH;                    // (kTB, kG)   gates

  const int p = blockIdx.x % P;
  const int row0 = (blockIdx.x / P) * kTB;
  const int rows = min(kTB, B - row0);
  const int j = threadIdx.x;

  float wxr[kF], whr[kH];
  const T* wxp = wx + (size_t)p * kF * kG + j;
  const T* whp = wh + (size_t)p * kH * kG + j;
#pragma unroll
  for (int f = 0; f < kF; ++f) wxr[f] = to_f32(wxp[(size_t)f * kG]);
#pragma unroll
  for (int k = 0; k < kH; ++k) whr[k] = to_f32(whp[(size_t)k * kG]);
  const float bj = bias[(size_t)p * kG + j];

  auto load_x = [&](int t) {
    const T* src = x + ((size_t)t * B + row0) * kF;
    const int n = rows * kF;
    for (int q = j; q < kTB * kF; q += kG) xs[q] = q < n ? to_f32(src[q]) : 0.f;
  };
  for (int q = j; q < kTB * kH; q += kG) hs[q] = 0.f;
  load_x(0);
  float c[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) c[i] = 0.f;
  const int u = j % kH;           // this thread's unit in the update
  const int rsub = j / kH;        // and its first row
  __syncthreads();

  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const float4* hs4 = reinterpret_cast<const float4*>(hs);
  for (int t = 0; t < steps; ++t) {
    for (int r0 = 0; r0 < kTB; r0 += kR) {
      float acc[kR];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) acc[rr] = bj;
#pragma unroll
      for (int f4 = 0; f4 < kF / 4; ++f4) {
#pragma unroll
        for (int rr = 0; rr < kR; ++rr) {
          const float4 v = xs4[(r0 + rr) * (kF / 4) + f4];
          acc[rr] = fmaf(v.x, wxr[4 * f4 + 0], acc[rr]);
          acc[rr] = fmaf(v.y, wxr[4 * f4 + 1], acc[rr]);
          acc[rr] = fmaf(v.z, wxr[4 * f4 + 2], acc[rr]);
          acc[rr] = fmaf(v.w, wxr[4 * f4 + 3], acc[rr]);
        }
      }
#pragma unroll
      for (int k4 = 0; k4 < kH / 4; ++k4) {
#pragma unroll
        for (int rr = 0; rr < kR; ++rr) {
          const float4 v = hs4[(r0 + rr) * (kH / 4) + k4];
          acc[rr] = fmaf(v.x, whr[4 * k4 + 0], acc[rr]);
          acc[rr] = fmaf(v.y, whr[4 * k4 + 1], acc[rr]);
          acc[rr] = fmaf(v.z, whr[4 * k4 + 2], acc[rr]);
          acc[rr] = fmaf(v.w, whr[4 * k4 + 3], acc[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) zs[(r0 + rr) * kG + j] = acc[rr];
    }
    __syncthreads();  // z complete; every read of x_t and h done

    const bool last = t + 1 == steps;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = i * (kG / kH) + rsub;
      const float* z = zs + r * kG;
      const float ig = sigmoid(z[u]);
      const float fg = sigmoid(z[kH + u]);
      const float gg = tanhf(z[2 * kH + u]);
      const float og = sigmoid(z[3 * kH + u]);
      c[i] = fg * c[i] + ig * gg;
      const float h = og * tanhf(c[i]);
      hs[r * kH + u] = round_h(h, x);
      if (last && r < rows) out[((size_t)p * B + row0 + r) * kH + u] = h;
    }
    if (!last) load_x(t + 1);
    __syncthreads();  // h and x_{t+1} in place for the next step
  }
}

template <typename T>
int launch(const void* x, const void* wx, const void* wh, const float* b,
           float* out, int steps, int B, int P, cudaStream_t s) {
  auto kernel = lstm_fused_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = (unsigned)((B + kTB - 1) / kTB);
  kernel<<<tiles * (unsigned)P, kG, kSmemBytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wx),
      static_cast<const T*>(wh), b, out, steps, B, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (P, B, H) f32 = h_T of the LSTM over x (T, B, F) for the P parameter
// sets wx (P, F, 4H), wh (P, H, 4H), b (P, 4H) f32; x, wx, wh f32
// (bf16 = 0) or bf16 (bf16 = 1).  Takes F = 28 and H = 64 only.  Launches
// on `stream`, does not synchronize, and returns the cudaError_t of the
// attribute call or the launch.
int pmpx_lstm_fused(int bf16, const void* x, const void* wx, const void* wh,
                    const float* b, float* out, int steps, int B, int F,
                    int H, int P, void* stream) {
  if (F != kF || H != kH || steps < 1 || B < 1 || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, wx, wh, b, out, steps, B, P, s)
              : launch<float>(x, wx, wh, b, out, steps, B, P, s);
}

}  // extern "C"
