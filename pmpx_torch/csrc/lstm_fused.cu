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
// bf16 (RNE) before each hidden product (pmpx's h.astype(dt)); the bias, c
// and the output h_T stay f32.
//
// What bounds it on the H100: the tensor cores in f32, the transcendentals
// in bf16.  The two gate products are one product a step, A = [x_t | h]
// (64 rows x K) against B = [Wx ; Wh] (K x 256), K = 28 + 64 padded to 96:
// 8 H (F + H) T flops per parameter set and example, 0.63 TFLOP at P = 8
// over the full batch of 60,000.  f32 runs them as 3xTF32 (below), three
// TF32 products, 3.84 ms at 495 TFLOP/s; bf16 as one bf16 product, 0.64 ms
// at 989 TFLOP/s.  The cell update costs 8 multi-function-unit results
// (5 exp2, 3 reciprocals) per (row, unit, step), 0.86 G triples at P = 8:
// 1.65 ms at 16 a clock on each SM.  Device memory is 0.31 GB (x read
// once, weights, h_T), 0.09 ms at 3.35 TB/s: not the bound.
//
// Design shared by both modes.  One block of 8 warps per (batch tile of
// kTB = 64 rows, p), p fastest in the grid so that the P blocks of one x
// tile run together and read it from L2 (the TPU kernel's "P innermost").
// The 28-step recurrence runs in the block and only h_T is written.
//
// - Gate columns are interleaved: in the block's copy of W the n8 column
//   chunk 4j + gate holds gate i, f, g or o of the units 8j..8j+7 (the
//   permutation is applied as the block loads W, not by the caller).  So
//   one thread's accumulator fragments hold z_i, z_f, z_g and z_o of the
//   same 16 (row, unit) pairs, the cell update runs on the accumulators in
//   registers, and c stays in registers.  No gate tile goes through shared
//   memory.
// - W stays resident for all 28 steps; A = [x_t | h_{t-1}] lives in shared
//   memory in fragment order (one 16-byte load gives a lane its A fragment
//   of an m16 x k tile).  Rows past B (the ragged last tile: 60,000 and
//   10,000 are not multiples of 64) compute on zeros and are not stored.
// - Transcendentals in fast forms with a few ulp of error: exp by ex2.approx
//   (__expf), one approximate reciprocal for sig(f), one for sig(i) tanh(g)
//   and one for sig(o) tanh(c), with tanh(v) = (1 - e^-2v) / (1 + e^-2v).
//   Arguments are clamped where e^-v would overflow (the clamped values
//   differ from the limits by less than 1e-17).
//
// f32: 3xTF32 on wgmma.  Each operand is split, hi = tf32(a), lo =
// tf32(a - hi) (cvt.rna), and lo*hi + hi*lo + hi*hi are summed in f32:
// about 2^-21 relative per product, where one TF32 product keeps 10 bits.
// Warpgroup w computes the 128 columns of units 32w..32w+31 for all 64
// rows as two wgmma.m64n64k8 chains of 36 (12 k8 blocks x 3 products), one
// per 16 units, so that the cell update of the first half runs while the
// tensor cores work on the second.  B (W's hi and lo, 192 KiB) sits in
// shared memory in wgmma's K-major layout without swizzle; A comes from
// registers: each warp loads its own 16 rows of A (f32) and splits them.
// wgmma, not mma.sync: only wgmma reaches the card's full TF32 rate.  W's
// two halves leave room for one copy of A (24 KiB), so a step has two
// barriers: after every warp has read A, and after h_t and x_{t+1} are
// written to it.  x_{t+2} is read from device memory into registers a step
// ahead.  Shared memory: 222,208 bytes, one block per SM.
//
// bf16: mma.sync.m16n8k16, exact products of bf16 values summed in f32.
// Warp j computes the chunks 4j..4j+3 (units 8j..8j+7) for all rows, one
// m16 row block at a time so that a block's cell update overlaps the next
// block's products; its B fragments (48 registers) stay in registers for
// the whole recurrence.  A is double buffered in shared memory: step t
// reads buffer t & 1 while the cell update writes h_t, rounded to bf16,
// and x_{t+1} into the other, so a step has one barrier.  x_{t+2} is
// staged with cp.async a step ahead; each thread converts only the chunks
// it copied, so the copy needs no barrier of its own.  Shared memory:
// 39,936 bytes and at most 128 registers, two blocks per SM.
//
// The f32 launch raises the kernel's dynamic shared-memory limit above 48
// KiB first.  The result repeats bit for bit from launch to launch (fixed
// summation order, no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF = 28;                 // features per step
constexpr int kH = 64;                 // hidden units
constexpr int kG = 4 * kH;             // gate columns
constexpr int kKx = 32;                // x's part of K, F zero-padded
constexpr int kK = kKx + kH;           // 96
constexpr int kTB = 64;                // batch rows per block
constexpr int kMB = kTB / 16;          // m16 row blocks
constexpr int kThreads = 256;          // 8 warps, 2 warpgroups
constexpr int kChunks = kTB * kF / 4;  // x tile in chunks of 4 values
constexpr int kChunksPerThread = (kChunks + kThreads - 1) / kThreads;

static_assert(kF % 4 == 0 && kF <= kKx, "x chunks");
static_assert(kTB == 64 && kH == 64, "the tiling below assumes 64 x 64");

// --- f32 (3xTF32 on wgmma) -------------------------------------------------

constexpr int kKB32 = kK / 8;             // k8 blocks
constexpr int kChains = 2;                // wgmma chains per warpgroup
constexpr int kN = 128 / kChains;         // columns of a chain
constexpr int kAcc = kN / 2;              // its accumulators per thread
constexpr int kBTile = kN * 8 * 4;        // bytes of a chain's k8 tile
constexpr int kLBO = 128;                 // K-adjacent core matrices
constexpr int kSBO = 256;                 // N-adjacent core matrices
static_assert(kChains == 2, "the waits below assume two chains");
// (warpgroup, chain, k8 block, hi | lo) tiles
constexpr int kBBytes = 2 * kChains * kKB32 * 2 * kBTile;   // 196,608
constexpr size_t kSmem32 = kBBytes + sizeof(float) * (kTB * kK + kG);

// --- bf16 (mma.sync) --------------------------------------------------------

constexpr int kKB16 = kK / 16;               // k16 blocks
constexpr int kABuf16 = kMB * kKB16 * 128;   // 32-bit words per A buffer
constexpr int kXRaw16 = kTB * kF / 2;        // words per raw x buffer
constexpr size_t kSmem16 =
    sizeof(uint32_t) * (2 * kABuf16 + 2 * kXRaw16 + 8 * kThreads);

template <typename T>
constexpr int kMinBlocks = 1;  // f32: 222,208 bytes of shared memory
template <>
constexpr int kMinBlocks<__nv_bfloat16> = 2;

// Float of the f32 A buffer that holds element (r, k): the A fragment of
// mma.m16n8k8.tf32 and wgmma.k8.tf32 (per warp's 16 rows), lane
// 4 (r % 8) + k % 4, register (r / 8) % 2 + 2 ((k / 4) % 2).
__device__ __forceinline__ int a_index_f32(int r, int k) {
  return (((r >> 4) * kKB32 + (k >> 3)) * 32 + (r & 7) * 4 + (k & 3)) * 4 +
         ((r >> 3) & 1) + 2 * ((k >> 2) & 1);
}

// Word of the bf16 A buffer that holds the pair (r, k), (r, k + 1), k even.
// mma.m16n8k16.bf16's A fragment: lane 4 (r % 8) + (k % 8) / 2, register
// (r / 8) % 2 + 2 ((k / 8) % 2), low half the even column.
__device__ __forceinline__ int a_index_bf16(int r, int k) {
  return ((r >> 4) * kKB16 + (k >> 4)) * 128 +
         (((r & 7) * 4 + ((k & 7) >> 1)) * 4) + ((r >> 3) & 1) +
         2 * ((k >> 3) & 1);
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-22 relative, both TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// Shared-memory matrix descriptor of a K-major B tile without swizzle.
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)(kLBO >> 4) << 16) | ((uint64_t)(kSBO >> 4) << 32);
}

// d (64 x kN over the warpgroup) += a (registers) * B (descriptor).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Orders the compiler's accesses of d against the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint4 a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Copies 8 bytes global -> shared, or 8 zero bytes when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float rcp(float v) { return __fdividef(1.f, v); }

// 1 + e^-v for a sigmoid argument, clamped so that products of two stay
// finite (sig(-40) < 5e-18).
__device__ __forceinline__ float one_plus_exp_neg(float v) {
  return 1.f + __expf(-fmaxf(v, -40.f));
}

// e^-2v for a tanh argument, clamped likewise (1 - tanh(20) < 1e-17).
__device__ __forceinline__ float exp_neg2(float v) {
  return __expf(-2.f * fmaxf(v, -20.f));
}

// The cell update of one (row, unit): c <- sig(f) c + sig(i) tanh(g),
// returns h = sig(o) tanh(c).
__device__ __forceinline__ float cell(float zi, float zf, float zg, float zo,
                                      float& c) {
  const float di = one_plus_exp_neg(zi);
  const float df = one_plus_exp_neg(zf);
  const float eg = exp_neg2(zg);
  const float d_o = one_plus_exp_neg(zo);
  c = fmaf(rcp(df), c, (1.f - eg) * rcp(di * (1.f + eg)));
  const float ec = exp_neg2(c);
  return (1.f - ec) * rcp(d_o * (1.f + ec));
}

__device__ __forceinline__ void lstm_f32(
    const float* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ bias,
    float* __restrict__ out, int steps, int B, int P) {
  extern __shared__ uint4 smem4[];
  char* bsm = reinterpret_cast<char*>(smem4);          // B tiles
  float* abuf = reinterpret_cast<float*>(bsm + kBBytes);  // A, f32
  float* bias_s = abuf + kTB * kK;                     // [unit][gate]
  const uint32_t b_base = static_cast<uint32_t>(__cvta_generic_to_shared(bsm));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;       // warpgroup: units 32 wg..32 wg + 31
  const int wi = (tid >> 5) & 3;  // warp in the warpgroup: rows 16 wi..
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int p = blockIdx.x % P;
  const int row0 = (blockIdx.x / P) * kTB;
  const int rows = min(kTB, B - row0);

  // W's hi and lo into the B tiles, thread j loading gate column j (all 96
  // loads in flight at once): column gate * H + unit, unit = 32 w +
  // 16 chain + 8 i + m, is row n = 8 (4 i + gate) + m of the tiles (w,
  // chain, k / 8), at (n / 8) SBO + ((k % 8) / 4) LBO + 16 (n % 8) +
  // 4 (k % 4) bytes; each lo tile follows its hi tile.
  {
    static_assert(kThreads == kG, "one gate column per thread");
    const float* wxp = wx + (size_t)p * kF * kG + tid;
    const float* whp = wh + (size_t)p * kH * kG + tid;
    const int gate = tid / kH, unit = tid % kH;
    const int n = 8 * (4 * ((unit % (kN / 4)) >> 3) + gate) + (unit & 7);
    char* col = bsm + ((unit >> 5) * kChains + (unit & 31) / (kN / 4)) *
                          kKB32 * 2 * kBTile +
                (n >> 3) * kSBO + (n & 7) * 16;
    float v[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      v[k] = k < kF ? __ldg(wxp + k * kG)
                    : (k < kKx ? 0.f : __ldg(whp + (k - kKx) * kG));
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          col + (k >> 3) * 2 * kBTile + ((k & 7) >> 2) * kLBO + (k & 3) * 4);
      split_tf32(v[k], dst[0], dst[kBTile / 4]);
    }
  }
  for (int i = tid; i < kG; i += kThreads) {
    bias_s[(i % kH) * 4 + i / kH] = bias[(size_t)p * kG + i];
  }
  for (int i = tid; i < kTB * kK; i += kThreads) abuf[i] = 0.f;  // h_0, pad
  __syncthreads();

  // x_t's tile is one run of rows * F floats; chunk c holds floats
  // 4c..4c+3, row c / 7, columns 4 (c % 7)..
  float4 xr[kChunksPerThread];
  auto load_x = [&](int t) {
    const float4* src =
        reinterpret_cast<const float4*>(x + ((size_t)t * B + row0) * kF);
#pragma unroll
    for (int i = 0; i < kChunksPerThread; ++i) {
      const int c = tid + i * kThreads;
      xr[i] = c < kChunks && c / (kF / 4) < rows ? __ldg(src + c)
                                                 : make_float4(0, 0, 0, 0);
    }
  };
  auto store_x = [&]() {
#pragma unroll
    for (int i = 0; i < kChunksPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c < kChunks) {
        const int r = c / (kF / 4), f = 4 * (c % (kF / 4));
        abuf[a_index_f32(r, f)] = xr[i].x;
        abuf[a_index_f32(r, f + 1)] = xr[i].y;
        abuf[a_index_f32(r, f + 2)] = xr[i].z;
        abuf[a_index_f32(r, f + 3)] = xr[i].w;
      }
    }
  };
  load_x(0);
  store_x();
  if (steps > 1) load_x(1);
  constexpr int kJ = kN / 32;  // 8-unit groups of a chain
  float c[kChains][kJ][4];
#pragma unroll
  for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[ch][j][e] = 0.f;
  // the B tiles, written through the generic proxy, are read by wgmma
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const bool last = t + 1 == steps;
    uint32_t ahi[kKB32][4], alo[kKB32][4];
    {
      const float4* at =
          reinterpret_cast<const float4*>(abuf) + wi * kKB32 * 32 + lane;
#pragma unroll
      for (int kb = 0; kb < kKB32; ++kb) {
        const float4 v = at[kb * 32];
        split_tf32(v.x, ahi[kb][0], alo[kb][0]);
        split_tf32(v.y, ahi[kb][1], alo[kb][1]);
        split_tf32(v.z, ahi[kb][2], alo[kb][2]);
        split_tf32(v.w, ahi[kb][3], alo[kb][3]);
      }
    }
    __syncthreads();  // every read of A done: it may take h_t and x_{t+1}

    // chunk 4j + gate of chain ch: element e is row 16 wi + g + 8 (e / 2),
    // unit 32 wg + kN / 4 ch + 8 j + 2 tig + e % 2; start from the bias
    float acc[kChains][kAcc];
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int u = 32 * wg + kN / 4 * ch + 8 * j + 2 * tig;
        const float4 b0 = *reinterpret_cast<const float4*>(bias_s + 4 * u);
        const float4 b1 = *reinterpret_cast<const float4*>(bias_s + 4 * u + 4);
        const float bv[2][4] = {{b0.x, b0.y, b0.z, b0.w},
                                {b1.x, b1.y, b1.z, b1.w}};
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[ch][4 * (4 * j + gate) + e] = bv[e & 1][gate];
      }
      fence_regs(acc[ch]);
    }
    wgmma_fence();
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch) {
#pragma unroll
      for (int kb = 0; kb < kKB32; ++kb) {
        const uint64_t hi = b_desc(
            b_base + (((wg * kChains + ch) * kKB32 + kb) * 2) * kBTile);
        const uint64_t lo = hi + (kBTile >> 4);
        // small terms first: lo * hi, hi * lo, then hi * hi
        wgmma_tf32(acc[ch], alo[kb], hi);
        wgmma_tf32(acc[ch], ahi[kb], lo);
        wgmma_tf32(acc[ch], ahi[kb], hi);
      }
      wgmma_commit();
    }

    // the cell update of chain ch while the later chains run
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch) {
      if (ch == 0) {
        wgmma_wait<1>();  // the second chain still runs
      } else {
        wgmma_wait<0>();
      }
      fence_regs(acc[ch]);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        float h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* z = acc[ch] + 16 * j + e;
          h[e] = cell(z[0], z[4], z[8], z[12], c[ch][j][e]);
        }
        const int u = 32 * wg + kN / 4 * ch + 8 * j + 2 * tig;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * wi + g + 8 * half;
          const float h0 = h[2 * half], h1 = h[2 * half + 1];
          abuf[a_index_f32(r, kKx + u)] = h0;  // unused after the last step
          abuf[a_index_f32(r, kKx + u + 1)] = h1;
          if (last && r < rows) {
            *reinterpret_cast<float2*>(
                out + ((size_t)p * B + row0 + r) * kH + u) =
                make_float2(h0, h1);
          }
        }
      }
    }
    if (!last) {
      store_x();
      if (t + 2 < steps) load_x(t + 2);
      __syncthreads();  // h_t and x_{t+1} in A for the next step
    }
  }
}

__device__ __forceinline__ void lstm_bf16(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wx,
    const __nv_bfloat16* __restrict__ wh, const float* __restrict__ bias,
    float* __restrict__ out, int steps, int B, int P) {
  extern __shared__ uint4 smem4[];
  uint32_t* abuf = reinterpret_cast<uint32_t*>(smem4);  // 2 x kABuf16
  uint32_t* xraw = abuf + 2 * kABuf16;                  // 2 x kXRaw16
  float4* bias_s = reinterpret_cast<float4*>(xraw + 2 * kXRaw16);

  const int tid = threadIdx.x;
  const int q = tid >> 5;  // warp: units 8q..8q+7
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int p = blockIdx.x % P;
  const int row0 = (blockIdx.x / P) * kTB;
  const int rows = min(kTB, B - row0);
  const __nv_bfloat16* wxp = wx + (size_t)p * kF * kG;
  const __nv_bfloat16* whp = wh + (size_t)p * kH * kG;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // this thread's B fragments: column n = g of chunk (q, gate), i.e. gate
  // column gate * H + 8q + g; rows 16 kb + 2 tig (+1, +8, +9)
  uint32_t wreg[kKB16][4][2];
#pragma unroll
  for (int kb = 0; kb < kKB16; ++kb) {
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      const int col = gate * kH + 8 * q + g;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = 16 * kb + 2 * tig + 8 * i;  // even, so k + 1 < kF too
        const __nv_bfloat162 v =
            k < kF ? __halves2bfloat162(wxp[k * kG + col],
                                        wxp[(k + 1) * kG + col])
                   : (k < kKx ? __halves2bfloat162(zero, zero)
                              : __halves2bfloat162(
                                    whp[(k - kKx) * kG + col],
                                    whp[(k + 1 - kKx) * kG + col]));
        wreg[kb][gate][i] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
  }
  // bias of this thread's (gate, unit 8q + 2 tig + j), two float4
  {
    const float* bp = bias + (size_t)p * kG + 8 * q + 2 * tig;
    bias_s[tid] = make_float4(bp[0], bp[1], bp[kH], bp[kH + 1]);
    bias_s[kThreads + tid] =
        make_float4(bp[2 * kH], bp[2 * kH + 1], bp[3 * kH], bp[3 * kH + 1]);
  }
  for (int i = tid; i < 2 * kABuf16; i += kThreads) abuf[i] = 0u;  // h_0, pad

  // x_t's tile is one run of rows * F values; chunk c holds values
  // 4c..4c+3 (8 bytes), row c / 7, columns 4 (c % 7)..
  auto stage_x = [&](int t) {
    const __nv_bfloat16* src = x + ((size_t)t * B + row0) * kF;
    uint32_t* dst = xraw + (t & 1) * kXRaw16;
#pragma unroll
    for (int i = 0; i < kChunksPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c < kChunks) {
        const bool valid = c / (kF / 4) < rows;
        cp_async8(dst + 2 * c, valid ? src + 4 * c : x, valid);
      }
    }
    cp_async_commit();
  };
  // x_t, copied by this thread, into A buffer t & 1
  auto convert_x = [&](int t) {
    const uint32_t* raw = xraw + (t & 1) * kXRaw16;
    uint32_t* a = abuf + (t & 1) * kABuf16;
    cp_async_wait_all();
#pragma unroll
    for (int i = 0; i < kChunksPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c < kChunks) {
        const int r = c / (kF / 4), f = 4 * (c % (kF / 4));
        const uint2 v = *reinterpret_cast<const uint2*>(raw + 2 * c);
        a[a_index_bf16(r, f)] = v.x;
        a[a_index_bf16(r, f + 2)] = v.y;
      }
    }
  };

  __syncthreads();  // A buffers zeroed
  stage_x(0);
  convert_x(0);
  if (steps > 1) stage_x(1);
  float c[kMB][4];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[mb][e] = 0.f;
  __syncthreads();  // x_0 in A buffer 0

  for (int t = 0; t < steps; ++t) {
    const uint32_t* a_cur = abuf + (t & 1) * kABuf16;
    uint32_t* a_nxt = abuf + ((t + 1) & 1) * kABuf16;
    const bool last = t + 1 == steps;
    float bv[4][2];
    {
      const float4 b01 = bias_s[tid];
      const float4 b23 = bias_s[kThreads + tid];
      bv[0][0] = b01.x; bv[0][1] = b01.y; bv[1][0] = b01.z; bv[1][1] = b01.w;
      bv[2][0] = b23.x; bv[2][1] = b23.y; bv[3][0] = b23.z; bv[3][1] = b23.w;
    }
    // one m16 row block at a time, products then cell update, so that the
    // cell update of one block overlaps the products of the next
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      // fragment gate, element e: row 16 mb + g + 8 (e / 2), unit
      // 8q + 2 tig + e % 2
      float acc[4][4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gate][e] = bv[gate][e & 1];
#pragma unroll
      for (int kb = 0; kb < kKB16; ++kb) {
        const uint4 a = reinterpret_cast<const uint4*>(
            a_cur + (mb * kKB16 + kb) * 128)[lane];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          mma_bf16(acc[gate], a, wreg[kb][gate][0], wreg[kb][gate][1]);
      }
      float h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = cell(acc[0][e], acc[1][e], acc[2][e], acc[3][e], c[mb][e]);
      }
      const int u = 8 * q + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mb + g + 8 * half;
        const float h0 = h[2 * half], h1 = h[2 * half + 1];
        // h_t, rounded, into the next A buffer (unused after the last step)
        const __nv_bfloat162 v = __floats2bfloat162_rn(h0, h1);
        a_nxt[a_index_bf16(r, kKx + u)] =
            *reinterpret_cast<const uint32_t*>(&v);
        if (last && r < rows) {
          *reinterpret_cast<float2*>(
              out + ((size_t)p * B + row0 + r) * kH + u) = make_float2(h0, h1);
        }
      }
    }
    if (!last) {
      convert_x(t + 1);
      if (t + 2 < steps) stage_x(t + 2);
      __syncthreads();  // h_t and x_{t+1} in A buffer (t + 1) & 1
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
lstm_fused_kernel(const T* __restrict__ x, const T* __restrict__ wx,
                  const T* __restrict__ wh, const float* __restrict__ bias,
                  float* __restrict__ out, int steps, int B, int P) {
  if constexpr (sizeof(T) == 4) {
    lstm_f32(x, wx, wh, bias, out, steps, B, P);
  } else {
    lstm_bf16(x, wx, wh, bias, out, steps, B, P);
  }
}

template <typename T>
int launch(const void* x, const void* wx, const void* wh, const float* b,
           float* out, int steps, int B, int P, cudaStream_t s) {
  auto kernel = lstm_fused_kernel<T>;
  constexpr size_t smem = sizeof(T) == 4 ? kSmem32 : kSmem16;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = (unsigned)((B + kTB - 1) / kTB);
  kernel<<<tiles * (unsigned)P, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wx),
      static_cast<const T*>(wh), b, out, steps, B, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (P, B, H) f32 = h_T of the LSTM over x (T, B, F) for the P parameter
// sets wx (P, F, 4H), wh (P, H, 4H), b (P, 4H) f32; x, wx, wh f32
// (bf16 = 0) or bf16 (bf16 = 1).  Takes F = 28 and H = 64 only, x aligned
// to 16 bytes (f32) or 8 (bf16) and out to 8 (vector loads and stores).
// Launches on `stream`, does not synchronize, and returns the cudaError_t
// of the attribute call or the launch.
int pmpx_lstm_fused(int bf16, const void* x, const void* wx, const void* wh,
                    const float* b, float* out, int steps, int B, int F,
                    int H, int P, void* stream) {
  if (F != kF || H != kH || steps < 1 || B < 1 || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(x) % (bf16 ? 8 : 16) != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, wx, wh, b, out, steps, B, P, s)
              : launch<float>(x, wx, wh, b, out, steps, B, P, s);
}

}  // extern "C"
