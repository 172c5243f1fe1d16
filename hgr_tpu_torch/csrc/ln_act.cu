// K3: the pre-LN transformer block's residual add + LayerNorm, its QuickGELU,
// and EVA-02's SwiGLU gate with its LayerNorm, each as one pass over device
// memory, for Hopper (sm_90a), with a plain C interface.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the residual add, the
// LayerNorm with its casts, the QuickGELU and the gate into the matrix
// products around them. In eager PyTorch the same arithmetic is a pass of its
// own for each op: a LayerNorm in fp32 between bf16 activations is three
// (cast up, norm, cast down), the residual add before it one more, QuickGELU
// three (1.702 * x, sigmoid, the product), and EVA-02's gate five (SiLU, the
// product, a two-pass LayerNorm at its 2,730 columns, which are not whole
// 16-byte vectors, and the pad). K3 does each chain in one pass.
//
// What it computes, each step rounded to the activation dtype T (bf16 or
// fp32) where the plain twin (models/layers.py layer_norm after a plain add,
// quick_gelu, and glu_layer_norm) rounds it:
//   add_layer_norm:  s = x + delta          (rounded to T; absent without delta)
//                    y = w * (rstd * (s - mean)) + b, in fp32, rounded to T
//     with mean and the biased variance of the row in fp32 and
//     rstd = rsqrtf(var + eps). s is the twin's bit for bit (bf16x2 PTX, one
//     rounding, which is what PyTorch's fp32 add rounded to bf16 gives, see
//     bn_act.cu's Word<bf16>). y differs from the twin's only by the order of
//     the fp32 sums: here a two-pass mean and variance over the row held in
//     registers, butterfly-summed across the warp; PyTorch's layer_norm uses
//     Welford's update in another order. Rounded to bf16 that is at most one
//     ulp apart.
//   quick_gelu:      a = x * 1.702f, rounded to T
//                    g = 1 / (1 + expf(-a)), IEEE division, rounded to T
//                    out = x * g, rounded to T
//     the three PyTorch ops' roundings (its sigmoid kernel computes
//     1 / (1 + exp(-a)) in fp32 with expf and a correctly rounded division),
//     so the result is the twin's bit for bit where the CUDA math library's
//     expf is the one PyTorch was built with.
//   glu_layer_norm:  over a row of the w1/w2 GEMM's output padded to np (n
//     rounded up to a multiple of 8), x1 its columns [0, n), x2 [np, np + n):
//                    s = x1 / (1 + expf(-x1)), IEEE division, rounded to T
//                        (in bf16 from approximations that round alike)
//                    g = s * x2, rounded to T
//                    y = w * (rstd * (g - mean)) + b over the n columns, in
//                        fp32 with w and b rounded to T, rounded to T
//                    then np - n zeros
//     PyTorch's SiLU and product bit for bit (as quick_gelu), and its
//     LayerNorm within the order of the fp32 sums, as add_layer_norm.
//
// What bounds it on the H100: bytes. A LayerNorm row of width D costs about
// ten operations an element against 8 bytes (bf16: x, delta in; s, y out),
// QuickGELU about twenty against 4, the gate about thirty against 6, all far
// under the ~295 FLOP per byte at which the SMs would be the limit. The
// design moves each byte once, in 16-byte accesses, with enough of them in
// flight:
// - add_layer_norm gives each row to one warp (eight rows a block, a grid
//   over rows). A lane loads its 16-byte vectors of x and delta (V of them,
//   V = D / 256 for bf16 rounded up: 1 to 5 up to D = 1280; 1 to 10 in fp32)
//   before it computes, stores s, and keeps the row in registers between
//   the mean, the variance and the output, so that each byte is read once
//   and both reductions are warp shuffles, with no shared memory and no
//   block barrier. V is a template argument, so the row lives in registers;
//   lanes past the row's last vector only add zeros to the sums. A width
//   that is not a multiple of 256 leaves the last vectors ragged: SigLIP
//   So400m's 1,152 is 144 vectors, five on lanes 0-15 and four on the
//   rest. x and delta may come with a row stride (ln_post's class-token
//   rows). The
//   fp32 weight and bias are read through the L1 as each lane's 16-byte
//   slices; no fold, cache or per-call preparation.
// - quick_gelu is a grid-stride pass over 16-byte vectors, four loads a
//   thread in flight before any compute (64 bytes, four 256-thread blocks an
//   SM), the first product in fp32 and the last on bf16x2 PTX.
// - glu_layer_norm keeps add_layer_norm's shape at rows too wide for one
//   warp's registers (2,736 padded columns in EVA02-CLIP-L/14): two warps a
//   bf16 row (four in fp32), four rows a 256-thread block. Each half of a
//   padded row is whole 16-byte vectors; a thread loads its V vectors of
//   both halves before it computes (6 of each in bf16) and keeps g as packed
//   T (24 registers in bf16) between the mean, the variance and the output;
//   the row's two warps add their sums in shared memory at a block barrier.
//   At 80 registers three blocks fit an SM. A persistent grid walks over the
//   rows, so the weight and bias are rounded to T once a block, into shared
//   memory as floats, zero past n. The pad columns are masked out of both
//   sums and stored as zeros. The SiLU is most of the arithmetic; in bf16 it
//   comes from ex2.approx and rcp.approx, and only values near a bf16
//   rounding midpoint take the IEEE formula (silu_bf16). On an H100 one warp
//   a row (157 registers, one block an SM), or rows staged in shared memory
//   by cp.async (two blocks an SM), were slower; the IEEE SiLU throughout
//   held the kernel at 76% of its byte bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kLnWarps = 8;        // rows a block of add_layer_norm, a warp a row
constexpr int kMaxWidth = 1280;    // the widest row a warp keeps in registers (bf16: V = 5)
constexpr int kGeluThreads = 256;
constexpr int kGeluBlocksPerSm = 4;
constexpr int kGeluUnroll = 4;     // 16-byte vectors a thread loads before it computes
constexpr float kGeluScale = 1.702f;  // PyTorch's fp32 scalar of 1.702
constexpr int kGluThreads = 256;
constexpr int kGluWarps = 2;       // warps a bf16 row of glu_layer_norm (fp32: twice as many)
constexpr int kGluMaxWidth = 3072; // the widest padded row of glu_layer_norm
constexpr uint32_t kSiluWindow = 16;  // fp32 ulps around a bf16 midpoint that silu_bf16 leaves to silu

__device__ __forceinline__ uint32_t& word(uint4& v, int k) { return (&v.x)[k]; }
__device__ __forceinline__ uint32_t word(const uint4& v, int k) { return (&v.x)[k]; }

// two bf16 ops on bf16x2 PTX, each value rounded once to bf16: what PyTorch's
// fp32 op rounded to bf16 gives (bn_act.cu's Word<bf16>)
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// the twin's sigmoid of a value already rounded to T: PyTorch's fp32 formula
__device__ __forceinline__ float sigmoid(float a) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
}

// the twin's SiLU in fp32: PyTorch's formula
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

// SiLU from ex2.approx and rcp.approx, about a third of silu's instructions:
// q lies within a few fp32 ulps of silu(x), so that the two round to the
// same bf16 unless silu(x) lies within kSiluWindow ulps of a bf16 rounding
// midpoint (the low 16 bits near 0x8000); returns false there, and for x
// at or below -80, where 1 + e^-x nears the top of fp32 and the reciprocal
// flushes to zero, so that the caller takes silu. Checked bit for bit
// against PyTorch's SiLU on all 65,536 bf16 inputs (chip_smoke.py).
__device__ __forceinline__ bool silu_bf16(float x, float& q) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(__fmul_rn(x, -1.44269504f)));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fadd_rn(1.0f, e)));
  q = __fmul_rn(x, r);
  const uint32_t low = (__float_as_uint(q) + kSiluWindow - 0x8000u) & 0xffffu;
  return low > 2 * kSiluWindow && x > -80.f;
}

// 16 bytes of T as floats, and back (each value rounded to T once)
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;  // elements a vector
  __device__ static void unpack(const uint4& v, float* f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = __uint_as_float(word(v, k));
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ static uint4 add(const uint4& a, const uint4& b) {
    uint4 d;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word(d, k) = __float_as_uint(__fadd_rn(__uint_as_float(word(a, k)),
                                             __uint_as_float(word(b, k))));
    return d;
  }
  __device__ static uint4 quick_gelu(const uint4& v) {
    uint4 d;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float x = __uint_as_float(word(v, k));
      word(d, k) = __float_as_uint(__fmul_rn(x, sigmoid(__fmul_rn(x, kGeluScale))));
    }
    return d;
  }
  __device__ static float round(float x) { return x; }  // to T
  __device__ static uint4 glu(const uint4& a, const uint4& b) {  // SiLU(a) * b
    uint4 d;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word(d, k) = __float_as_uint(__fmul_rn(silu(__uint_as_float(word(a, k))),
                                             __uint_as_float(word(b, k))));
    return d;
  }
  __device__ static uint4 keep(const uint4& v, int n) {  // the first n elements, then zeros
    uint4 d;
#pragma unroll
    for (int k = 0; k < 4; ++k) word(d, k) = k < n ? word(v, k) : 0u;
    return d;
  }
};
template <>
struct Pack<bf16> {
  static constexpr int N = 8;  // element 2k in the low half of word k
  __device__ static float lo(uint32_t w) { return __uint_as_float(w << 16); }
  __device__ static float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
  __device__ static uint32_t pack2(float a, float b) {  // a low, b high, each rounded
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return (uint32_t)__bfloat16_as_ushort(v.x) | ((uint32_t)__bfloat16_as_ushort(v.y) << 16);
  }
  __device__ static void unpack(const uint4& v, float* f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) f[2 * k] = lo(word(v, k)), f[2 * k + 1] = hi(word(v, k));
  }
  __device__ static uint4 pack(const float* f) {
    uint4 d;
#pragma unroll
    for (int k = 0; k < 4; ++k) word(d, k) = pack2(f[2 * k], f[2 * k + 1]);
    return d;
  }
  __device__ static uint4 add(const uint4& a, const uint4& b) {
    uint4 d;
#pragma unroll
    for (int k = 0; k < 4; ++k) word(d, k) = bf16x2_add(word(a, k), word(b, k));
    return d;
  }
  __device__ static uint4 quick_gelu(const uint4& v) {
    uint4 d;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t x = word(v, k);
      // 1.702 * x in fp32, rounded to bf16 as the twin's first op rounds it
      const uint32_t a = pack2(__fmul_rn(lo(x), kGeluScale), __fmul_rn(hi(x), kGeluScale));
      const uint32_t g = pack2(sigmoid(lo(a)), sigmoid(hi(a)));
      word(d, k) = bf16x2_mul(x, g);
    }
    return d;
  }
  __device__ static float round(float x) { return lo(pack2(x, 0.f)); }  // to T
  __device__ static uint4 glu(const uint4& a, const uint4& b) {  // SiLU(a) * b
    uint4 d;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t x = word(a, k);
      float sl, sh;
      const bool fast = silu_bf16(lo(x), sl) & silu_bf16(hi(x), sh);
      uint32_t s = pack2(sl, sh);
      if (!fast) s = pack2(silu(lo(x)), silu(hi(x)));
      word(d, k) = bf16x2_mul(s, word(b, k));
    }
    return d;
  }
  __device__ static uint4 keep(const uint4& v, int n) {  // the first n elements, then zeros
    uint4 d;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word(d, k) = word(v, k) & ((2 * k < n ? 0xffffu : 0u) | (2 * k + 1 < n ? 0xffff0000u : 0u));
    return d;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct LnArgs {
  const T* x;
  const T* delta;  // null: no residual add
  T* s;            // x + delta, [rows, width] contiguous (with delta)
  T* y;            // the normed rows, [rows, width] contiguous
  const float* w;
  const float* b;
  float eps;
  long long rows;
  int nvec;              // 16-byte vectors a row
  long long x_ld, d_ld;  // row strides of x and delta, in vectors
};

// one warp a row; V: vectors a lane holds (the row's nvec <= 32 V)
template <typename T, int V, bool DELTA>
__global__ void __launch_bounds__(kLnWarps * 32) add_layer_norm_kernel(const LnArgs<T> a) {
  typedef Pack<T> P;
  constexpr int N = P::N;
  const long long row = (long long)blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= a.rows) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const uint4* xr = reinterpret_cast<const uint4*>(a.x) + row * a.x_ld;
  uint4 v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < a.nvec ? __ldg(xr + c) : make_uint4(0, 0, 0, 0);
  }
  if constexpr (DELTA) {
    const uint4* dr = reinterpret_cast<const uint4*>(a.delta) + row * a.d_ld;
    uint4 dv[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      dv[i] = c < a.nvec ? __ldg(dr + c) : make_uint4(0, 0, 0, 0);
    }
    uint4* sr = reinterpret_cast<uint4*>(a.s) + row * a.nvec;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      v[i] = P::add(v[i], dv[i]);  // zeros past the row stay zeros
      if (c < a.nvec) sr[c] = v[i];
    }
  }
  float f[V][N];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    P::unpack(v[i], f[i]);
#pragma unroll
    for (int k = 0; k < N; ++k) sum = __fadd_rn(sum, f[i][k]);
  }
  const float width = (float)(a.nvec * N);
  const float mean = __fdiv_rn(warp_sum(sum), width);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (lane + 32 * i < a.nvec) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float d = __fsub_rn(f[i][k], mean);
        sq = __fmaf_rn(d, d, sq);
      }
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), width), a.eps));
  uint4* yr = reinterpret_cast<uint4*>(a.y) + row * a.nvec;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    if (c >= a.nvec) continue;
    const float4* wv = reinterpret_cast<const float4*>(a.w) + c * (N / 4);
    const float4* bv = reinterpret_cast<const float4*>(a.b) + c * (N / 4);
    float o[N];
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 wq = __ldg(wv + q), bq = __ldg(bv + q);
      const float* f4 = f[i] + 4 * q;
      o[4 * q + 0] = __fmaf_rn(wq.x, __fmul_rn(rstd, __fsub_rn(f4[0], mean)), bq.x);
      o[4 * q + 1] = __fmaf_rn(wq.y, __fmul_rn(rstd, __fsub_rn(f4[1], mean)), bq.y);
      o[4 * q + 2] = __fmaf_rn(wq.z, __fmul_rn(rstd, __fsub_rn(f4[2], mean)), bq.z);
      o[4 * q + 3] = __fmaf_rn(wq.w, __fmul_rn(rstd, __fsub_rn(f4[3], mean)), bq.w);
    }
    yr[c] = P::pack(o);
  }
}

template <typename T>
__global__ void __launch_bounds__(kGeluThreads, kGeluBlocksPerSm)
    quick_gelu_kernel(const T* __restrict__ x, T* __restrict__ out, long long nvec) {
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nvec;
       i += step * kGeluUnroll) {
    uint4 v[kGeluUnroll];
#pragma unroll
    for (int u = 0; u < kGeluUnroll; ++u) {
      const long long j = i + u * step;
      if (j < nvec) v[u] = __ldg(xv + j);
    }
#pragma unroll
    for (int u = 0; u < kGeluUnroll; ++u) {
      const long long j = i + u * step;
      if (j < nvec) ov[j] = Pack<T>::quick_gelu(v[u]);
    }
  }
}

// warps a row: kGluWarps in bf16, twice as many in fp32, so that V is the same
template <typename T>
constexpr int glu_warps() { return kGluWarps * 8 / Pack<T>::N; }

// the sum of v over the W warps of a row (W * 32 threads), for every thread
// of it; part holds a float a warp of the block
template <int W>
__device__ __forceinline__ float row_sum(float v, float* part) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, first = warp / W * W;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  float s = part[first];
#pragma unroll
  for (int j = 1; j < W; ++j) s = __fadd_rn(s, part[first + j]);
  return s;
}

template <typename T>
struct GluArgs {
  const T* x12;     // [rows, 2 nvec vectors]: x1 in vectors [0, nvec), x2 in [nvec, 2 nvec)
  T* out;           // [rows, nvec vectors]
  const float* w;   // ffn_ln's weight and bias, fp32 [n]
  const float* b;
  float eps;
  long long rows;
  int n;            // the row's real columns; the rest of its nvec vectors are pad
  int nvec;         // 16-byte vectors in np columns
};

// W warps a row, kGluThreads / 32 / W rows a block at a time over a persistent grid; V:
// vectors of each half a thread holds (nvec <= 32 W V)
template <typename T, int W, int V>
__global__ void __launch_bounds__(kGluThreads) glu_layer_norm_kernel(const GluArgs<T> a) {
  typedef Pack<T> P;
  constexpr int N = P::N, R = kGluThreads / 32 / W;
  static_assert(W >= 2 && R >= 1, "a row's warps meet at the block's barrier");
  extern __shared__ float4 wb[];  // weight then bias as floats rounded to T, zero past n
  __shared__ float part[2][kGluThreads / 32];
  const int np = a.nvec * N;
  float* wbf = reinterpret_cast<float*>(wb);
  for (int j = threadIdx.x; j < np; j += kGluThreads) {
    wbf[j] = j < a.n ? P::round(a.w[j]) : 0.f;
    wbf[np + j] = j < a.n ? P::round(a.b[j]) : 0.f;
  }
  __syncthreads();
  const int t = (threadIdx.x >> 5) % W * 32 + (threadIdx.x & 31);  // the thread's place in its row
  const float width = (float)a.n;
  for (long long r0 = (long long)blockIdx.x * R; r0 < a.rows; r0 += (long long)gridDim.x * R) {
    const long long row = r0 + (threadIdx.x >> 5) / W;
    const bool live = row < a.rows;  // a dead row's threads still meet the barriers
    const uint4* xr = reinterpret_cast<const uint4*>(a.x12) + row * 2 * a.nvec;
    uint4 g[V], x2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t + 32 * W * i;
      const bool in = live && c < a.nvec;
      g[i] = in ? __ldg(xr + c) : make_uint4(0, 0, 0, 0);
      x2[i] = in ? __ldg(xr + a.nvec + c) : make_uint4(0, 0, 0, 0);
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t + 32 * W * i;
      g[i] = P::glu(g[i], x2[i]);
      if ((c + 1) * N > a.n) g[i] = P::keep(g[i], a.n - c * N);  // the pad and past the row: 0
      float f[N];
      P::unpack(g[i], f);
#pragma unroll
      for (int k = 0; k < N; ++k) sum = __fadd_rn(sum, f[k]);
    }
    const float mean = __fdiv_rn(row_sum<W>(sum, part[0]), width);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t + 32 * W * i, valid = a.n - c * N;
      float f[N];
      P::unpack(g[i], f);
      if (valid >= N) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float d = __fsub_rn(f[k], mean);
          sq = __fmaf_rn(d, d, sq);
        }
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float d = k < valid ? __fsub_rn(f[k], mean) : 0.f;
          sq = __fmaf_rn(d, d, sq);
        }
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(row_sum<W>(sq, part[1]), width), a.eps));
    uint4* yr = reinterpret_cast<uint4*>(a.out) + row * a.nvec;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t + 32 * W * i;
      if (!live || c >= a.nvec) continue;
      float f[N], o[N];
      P::unpack(g[i], f);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 wq = wb[c * (N / 4) + q], bq = wb[np / 4 + c * (N / 4) + q];
        const float* f4 = f + 4 * q;
        o[4 * q + 0] = __fmaf_rn(wq.x, __fmul_rn(rstd, __fsub_rn(f4[0], mean)), bq.x);
        o[4 * q + 1] = __fmaf_rn(wq.y, __fmul_rn(rstd, __fsub_rn(f4[1], mean)), bq.y);
        o[4 * q + 2] = __fmaf_rn(wq.z, __fmul_rn(rstd, __fsub_rn(f4[2], mean)), bq.z);
        o[4 * q + 3] = __fmaf_rn(wq.w, __fmul_rn(rstd, __fsub_rn(f4[3], mean)), bq.w);
      }
      const uint4 y = P::pack(o);
      yr[c] = (c + 1) * N > a.n ? P::keep(y, a.n - c * N) : y;
    }
  }
}

// glu_layer_norm's first step alone, SiLU(a) * b elementwise: the card's
// check of its SiLU on every bf16 value (chip_smoke.py); a grid-stride pass
template <typename T>
__global__ void __launch_bounds__(kGeluThreads)
    silu_mul_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                    long long nvec) {
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * blockDim.x)
    ov[i] = Pack<T>::glu(__ldg(av + i), __ldg(bv + i));
}

template <typename T, bool DELTA, int V>
int launch_ln(int vecs, const LnArgs<T>& a, cudaStream_t st) {
  if constexpr (V * 32 * Pack<T>::N > kMaxWidth) {
    return -1;
  } else {
    if (vecs > V) return launch_ln<T, DELTA, V + 1>(vecs, a, st);
    const long long blocks = (a.rows + kLnWarps - 1) / kLnWarps;
    add_layer_norm_kernel<T, V, DELTA><<<(unsigned)blocks, kLnWarps * 32, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int add_layer_norm(const void* x, const void* delta, void* s, void* y, const float* w,
                   const float* b, float eps, long long rows, long long width, long long x_ld,
                   long long d_ld, cudaStream_t st) {
  constexpr int N = Pack<T>::N;
  if (rows == 0) return 0;
  const LnArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(delta), static_cast<T*>(s),
                    static_cast<T*>(y), w, b, eps, rows, (int)(width / N), x_ld / N, d_ld / N};
  const int vecs = (int)((width / N + 31) / 32);  // vectors a lane
  return delta ? launch_ln<T, true, 1>(vecs, a, st) : launch_ln<T, false, 1>(vecs, a, st);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

template <typename T, int V>
int launch_glu(int vecs, const GluArgs<T>& a, cudaStream_t st) {
  constexpr int W = glu_warps<T>();
  if constexpr (V * 32 * W * Pack<T>::N > kGluMaxWidth) {
    return -1;
  } else {
    if (vecs > V) return launch_glu<T, V + 1>(vecs, a, st);
    const auto kernel = glu_layer_norm_kernel<T, W, V>;
    const size_t smem = 2 * (size_t)a.nvec * Pack<T>::N * sizeof(float);
    int per_sm = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGluThreads, smem);
    if (e != cudaSuccess) return (int)e;
    const int sms = sm_count();
    if (sms == 0) return (int)cudaGetLastError();
    constexpr int R = kGluThreads / 32 / W;
    long long blocks = (a.rows + R - 1) / R;
    const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
    blocks = blocks < full ? blocks : full;
    kernel<<<(unsigned)blocks, kGluThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int glu_layer_norm(const void* x12, void* out, const float* w, const float* b, float eps,
                   long long rows, int n, int np, cudaStream_t st) {
  constexpr int N = Pack<T>::N;
  if (rows == 0) return 0;
  const GluArgs<T> a{static_cast<const T*>(x12), static_cast<T*>(out), w, b, eps, rows, n, np / N};
  constexpr int lanes = 32 * glu_warps<T>();
  return launch_glu<T, 1>((a.nvec + lanes - 1) / lanes, a, st);
}

template <typename T>
int quick_gelu(const void* x, void* out, long long n, cudaStream_t st) {
  const long long nvec = n / Pack<T>::N;
  if (nvec == 0) return 0;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaGetLastError();
  const long long per_block = (long long)kGeluThreads * kGeluUnroll;
  long long blocks = (nvec + per_block - 1) / per_block;
  const long long full = (long long)sms * kGeluBlocksPerSm;
  blocks = blocks < full ? blocks : full;
  quick_gelu_kernel<T><<<(unsigned)blocks, kGeluThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), nvec);
  return (int)cudaGetLastError();
}

template <typename T>
int silu_mul(const void* a, const void* b, void* out, long long n, cudaStream_t st) {
  const long long nvec = n / Pack<T>::N;
  if (nvec == 0) return 0;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaGetLastError();
  long long blocks = (nvec + kGeluThreads - 1) / kGeluThreads;
  blocks = blocks < (long long)sms * kGeluBlocksPerSm ? blocks : (long long)sms * kGeluBlocksPerSm;
  silu_mul_kernel<T><<<(unsigned)blocks, kGeluThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), nvec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (and delta, when not null) are `rows`
// rows of `width` elements, row i at element i * x_ld (d_ld); s (with delta)
// and y are written as contiguous [rows, width]. w and b are fp32 [width].
// width is a multiple of 8 from 8 to 1280; every pointer is 16-byte aligned
// and every row stride a multiple of 16 bytes and at least the width. With
// delta, s = x + delta and y = LayerNorm(s); without, y = LayerNorm(x) and s
// is not written. Returns 0, a cudaError_t from the launch, or -1 for
// arguments the kernel does not take.
int hgr_add_layer_norm(int dtype, const void* x, const void* delta, void* s, void* y,
                       const float* w, const float* b, float eps, long long rows,
                       long long width, long long x_ld, long long d_ld, void* stream) {
  const int per_vec = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || rows < 0 || width < 8 || width > kMaxWidth ||
      width % 8 != 0 || x_ld < width || x_ld % per_vec != 0 ||
      (rows + kLnWarps - 1) / kLnWarps >= (1LL << 31) || !x || !y || !w || !b ||
      (delta && (!s || d_ld < width || d_ld % per_vec != 0)))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? add_layer_norm<float>(x, delta, s, y, w, b, eps, rows, width, x_ld, d_ld, st)
                    : add_layer_norm<bf16>(x, delta, s, y, w, b, eps, rows, width, x_ld, d_ld, st);
}

// dtype as above; x and out hold n contiguous elements, 16-byte aligned, n a
// multiple of 8 (bf16) or 4 (fp32). Returns as hgr_add_layer_norm.
int hgr_quick_gelu(int dtype, const void* x, void* out, long long n, void* stream) {
  const int per_vec = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || n < 0 || n % per_vec != 0 || !x || !out) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? quick_gelu<float>(x, out, n, st) : quick_gelu<bf16>(x, out, n, st);
}

// dtype as above. x12 is `rows` contiguous rows of 2 np elements, np = n
// rounded up to a multiple of 8, with x1 in columns [0, n) and x2 in
// [np, np + n); out is [rows, np] contiguous: LayerNorm(SiLU(x1) * x2) over
// the n columns with w and b (fp32 [n], rounded to the activation dtype) and
// eps, then np - n zeros. x12 and out are 16-byte aligned; np is at most
// 3072. Returns as hgr_add_layer_norm.
int hgr_glu_layer_norm(int dtype, const void* x12, void* out, const float* w, const float* b,
                       float eps, long long rows, long long n, void* stream) {
  const long long np = (n + 7) / 8 * 8;
  if ((dtype != 0 && dtype != 1) || rows < 0 || n < 1 || np > kGluMaxWidth || !x12 || !out ||
      !w || !b)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? glu_layer_norm<float>(x12, out, w, b, eps, rows, (int)n, (int)np, st)
                    : glu_layer_norm<bf16>(x12, out, w, b, eps, rows, (int)n, (int)np, st);
}

// dtype as above; a, b and out hold n contiguous elements, 16-byte aligned,
// n a multiple of 8 (bf16) or 4 (fp32): out = SiLU(a) * b as glu_layer_norm
// computes it. Returns as hgr_add_layer_norm.
int hgr_silu_mul(int dtype, const void* a, const void* b, void* out, long long n, void* stream) {
  const int per_vec = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || n < 0 || n % per_vec != 0 || !a || !b || !out) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? silu_mul<float>(a, b, out, n, st) : silu_mul<bf16>(a, b, out, n, st);
}

const char* hgr_ln_act_error_string(int code) {
  if (code == -1) return "bad arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
