// K2: frozen-statistics BatchNorm and its epilogue in one pass over a
// channels-last activation, for Hopper (sm_90a), with a plain C interface.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the folded BatchNorm, the
// residual add, the ReLU and the 2x2 mean into the convolutions around them.
// In eager PyTorch the same arithmetic is nine launches a BatchNorm (the
// fold's add, rsqrt, two multiplies, subtract and two casts, then a multiply
// and an add over the activation), a ReLU, an add and an avg_pool2d, each a
// pass over device memory. K2 is one pass that reads the convolution's output
// (and a residual, where there is one) once and writes the result once, or a
// quarter of it where a 2x2 mean follows.
//
// What it computes, per element of channel c, in this order, each step
// rounded to the activation dtype T (bf16 or fp32) as the plain twin
// (models/layers.py batch_norm_act) rounds it, so that the two agree bit for
// bit:
//   inv = rsqrt(var + eps) * weight, shift = bias - mean * inv   (fp32)
//   inv, shift rounded to T
//   y = (x * inv) + shift                     [kFold; else y = x]
//   r = (res * rinv) + rshift                 [kResidualFold; else r = res]
//   y = y + r                                 [kResidual]
//   y = max(y, 0), NaN kept                   [kRelu]
//   out = (((0 + y00) + y01) + y10) + y11) / 4 in fp32, rounded  [kPool]
// where the pool reads rows 2h, 2h + 1 and columns 2w, 2w + 1 in the order
// avg_pool2d's NHWC kernel sums them, and drops an odd last row or column as
// it does. The fold uses __fadd_rn / __fmul_rn so that nvcc contracts nothing
// into an FMA: PyTorch runs each of those steps as a kernel of its own.
//
// What bounds it on the H100: bytes. A few operations an element against 4
// or 8 bytes (fp32 or bf16 in, out, residual) is far under the ~295 FLOP per
// byte at which the SMs would be the limit, as long as each operation is one
// instruction for two bf16 values: done in fp32, with a conversion and a
// rounding around every step, the bf16 variants reached only 58-77% of the
// bytes' bound where fp32 reached 85-92%. So bf16 runs on bf16x2 PTX (each
// op rounded once to bf16, the same result as PyTorch's fp32 op rounded, see
// Word<bf16>), the ReLU is integer masking, and only the pool's sum is fp32.
// The rest of the design is about moving each byte once, in wide accesses,
// with enough of them in flight:
// - Layout: NHWC, so an element's channel is its offset modulo C. A thread
//   owns one 16-byte vector of channels (8 bf16 or 4 fp32) and walks rows
//   (pixels) with a stride of the grid's rows a pass; its channels never
//   change, so it folds its channels' weight, bias, running_mean and
//   running_var once, in registers. There is no per-call fold launch, no
//   cache and nothing to invalidate when the weights change.
// - Neighbouring threads hold neighbouring vectors of one row, then the next
//   row, so a warp's loads and stores cover contiguous 512 bytes.
// - Each thread issues the loads of U rows before it computes any: 64 bytes
//   of x and residual a thread without the pool (U = 4 rows, or 2 with a
//   residual), 128 with it (U = 2 output pixels of four input rows each; the
//   pool takes no residual, as the ResNet pools only after a ReLU). With
//   four 256-thread blocks an SM that is 64-128 KB in flight per SM, above
//   the ~25 KB that 3.35 TB/s at ~1 us of latency needs. The residual and
//   the pool are template arguments, so that each kernel holds registers
//   only for what it reads; the other flags are uniform branches.
// - The grid is at most four blocks an SM (a pass of 132 x 1024 threads) and
//   fewer for small tensors; the few threads past the last whole row of
//   vectors a pass idle.

// The backward (bn_act_backward_kernel, then bn_act_grads_kernel), for the
// train step, where the forward runs inside an autograd Function that saves
// only x and the residual. Replaces no TPU kernel either: XLA fuses this
// backward there too. Eager autograd of the plain twin runs the pool's
// backward, relu's threshold_backward, the multiplies by inv and rinv, a
// materialised g * x reduced per channel, a reduction of g, and the fold's
// backward on [C] vectors: about a dozen passes over the epilogue's tensor.
// The kernel is one pass that reads g (a quarter of it pooled), x and the
// residual (each only where relu's mask or a fold's sum needs it: the
// pool-only epilogue reads g alone) and writes dx and dres:
// - relu's mask is recomputed from x (and res) with the forward's own
//   arithmetic (pre, then Word::keep: the pre-activation > 0, or NaN, as
//   threshold_backward passes it), so no mask or pre-pool tensor is saved
//   and dx, dres equal autograd's bit for bit; with the pool, each g / 4
//   (exact) goes to its 2x2 window;
// - the per-channel sums the parameter gradients need (g_m, g_m * x,
//   g_m * res under kResidualFold) stay in fp32 registers; each block adds
//   its threads' sums in shared memory in a fixed order and writes them to
//   a [3, blocks, C] scratch, which bn_act_grads_kernel sums in a fixed
//   order before the fold's backward: deterministic, no atomics;
// - what bounds it is bytes, as the forward: the same 16-byte vectors of
//   channels a thread, bf16x2 arithmetic and integer masks; two to four rows
//   of loads in flight a thread (48-160 bytes) at two 256-thread blocks an
//   SM (the sums and loads take 90-116 registers, spilling none). The block
//   covers all of a row's channel vectors (or a share of them, where a row
//   has more than 256) and 256 / vectors rows a pass, so a warp's loads
//   stay contiguous and the block's sums are its own channels'.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum : int { kFold = 1, kResidual = 2, kResidualFold = 4, kRelu = 8, kPool = 16 };
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;

// one BatchNorm's fp32 parameters, each [C]
struct Fold {
  const float *weight, *bias, *mean, *var;
};

// Arithmetic on one 32-bit word of T (one fp32, or two bf16), each step
// rounded to T once. For bf16 that is bf16x2 PTX: an op on two bf16 values
// rounded once to bf16 gives what PyTorch's fp32 op rounded to bf16 gives,
// since fp32's 24 bits are at least 2 x 8 + 2 (double rounding is then
// innocuous), and inline PTX is never contracted into an FMA.
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr int N = 1;  // elements a word
  __device__ static uint32_t mul(uint32_t a, uint32_t b) {
    return __float_as_uint(__fmul_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ static uint32_t add(uint32_t a, uint32_t b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ static uint32_t relu(uint32_t w) {  // clamp_min's: NaN kept, else fmaxf(y, 0)
    const float y = __uint_as_float(w);
    return __float_as_uint(isnan(y) ? y : fmaxf(y, 0.f));
  }
  // all ones where relu's backward passes the gradient: y > 0, or NaN
  __device__ static uint32_t keep(uint32_t w) {
    const float y = __uint_as_float(w);
    return (isnan(y) || y > 0.f) ? 0xffffffffu : 0u;
  }
  static constexpr uint32_t kQuarter = 0x3e800000u;  // 0.25
  __device__ static float get(uint32_t w, int) { return __uint_as_float(w); }
  __device__ static uint32_t pack(const float* f) { return __float_as_uint(f[0]); }
};
template <>
struct Word<bf16> {
  static constexpr int N = 2;  // element 0 in the low half
  __device__ static uint32_t mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static uint32_t add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  // clamp_min's ReLU on two bf16: a half with the sign bit set that is not
  // NaN (a negative number, -inf or -0.0) becomes +0.0, as fmaxf(y, 0) gives
  __device__ static uint32_t relu(uint32_t w) {
    const uint32_t neg = ((w >> 15) & 0x00010001u) * 0xffffu;
    const uint32_t nan = __vcmpgtu2(w & 0x7fff7fffu, 0x7f807f80u);
    return w & ~(neg & ~nan);
  }
  // all ones in each half where relu's backward passes the gradient: not
  // (a negative number, -inf, -0.0 or +0.0), so a positive number or NaN
  __device__ static uint32_t keep(uint32_t w) {
    const uint32_t neg = ((w >> 15) & 0x00010001u) * 0xffffu;
    const uint32_t nan = __vcmpgtu2(w & 0x7fff7fffu, 0x7f807f80u);
    const uint32_t zero = __vcmpeq2(w, 0u);
    return ~((neg & ~nan) | zero);
  }
  static constexpr uint32_t kQuarter = 0x3e803e80u;  // 0.25, 0.25
  __device__ static float get(uint32_t w, int i) {
    return __uint_as_float(i ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static uint32_t pack(const float* f) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[0], f[1]);
    return (uint32_t)__bfloat16_as_ushort(v.x) | ((uint32_t)__bfloat16_as_ushort(v.y) << 16);
  }
};

__device__ __forceinline__ uint32_t& word(uint4& v, int k) { return (&v.x)[k]; }
__device__ __forceinline__ uint32_t word(const uint4& v, int k) { return (&v.x)[k]; }

// inv and shift of channel c, as batch_norm computes them in fp32 (rounded
// to T by Word<T>::pack)
__device__ __forceinline__ void fold(const Fold& f, int c, float eps, float& inv, float& shift) {
  inv = __fmul_rn(rsqrtf(__fadd_rn(f.var[c], eps)), f.weight[c]);
  shift = __fsub_rn(f.bias[c], __fmul_rn(f.mean[c], inv));
}

// one thread's folded parameters for its 16 bytes of channels, held as T
// (which they are, once rounded): 4 registers each
struct Channels {
  uint4 inv, shift, rinv, rshift;
};

// the pre-activation of word k of one vector: the folds and the residual
template <typename T, bool RES>
__device__ __forceinline__ uint32_t pre(const Channels& ch, int flags, uint32_t x, uint32_t r,
                                        int k) {
  typedef Word<T> W;
  if (flags & kFold) x = W::add(W::mul(x, word(ch.inv, k)), word(ch.shift, k));
  if (RES) {
    if (flags & kResidualFold) r = W::add(W::mul(r, word(ch.rinv, k)), word(ch.rshift, k));
    x = W::add(x, r);
  }
  return x;
}

// the epilogue of word k of one vector, before the pool
template <typename T, bool RES>
__device__ __forceinline__ uint32_t epilogue(const Channels& ch, int flags, uint32_t x,
                                             uint32_t r, int k) {
  x = pre<T, RES>(ch, flags, x, r, k);
  return (flags & kRelu) ? Word<T>::relu(x) : x;
}

// a thread's folded parameters for its 16 bytes of channels from c0
template <typename T, bool RES>
__device__ __forceinline__ Channels fold_channels(const Fold& f, const Fold& rf, float eps,
                                                  int flags, int c0) {
  typedef Word<T> Op;
  Channels ch = {};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float inv[Op::N], shift[Op::N];
    if (flags & kFold) {
      for (int i = 0; i < Op::N; ++i) fold(f, c0 + k * Op::N + i, eps, inv[i], shift[i]);
      word(ch.inv, k) = Op::pack(inv), word(ch.shift, k) = Op::pack(shift);
    }
    if (RES && (flags & kResidualFold)) {
      for (int i = 0; i < Op::N; ++i) fold(rf, c0 + k * Op::N + i, eps, inv[i], shift[i]);
      word(ch.rinv, k) = Op::pack(inv), word(ch.rshift, k) = Op::pack(shift);
    }
  }
  return ch;
}

// input pixels (rows of cvecs vectors) of output row `row`: itself, or with
// the pool the 2x2 window (n, 2ph + a, 2pw + b) in avg_pool2d's order
template <bool POOL>
__device__ __forceinline__ void inputs(long long row, unsigned H, unsigned W, unsigned PH,
                                       unsigned PW, long long* in) {
  if constexpr (POOL) {
    const unsigned o = (unsigned)row, pw = o % PW, nph = o / PW, ph = nph % PH, n = nph / PH;
    const long long top = ((long long)n * H + 2 * ph) * W + 2 * pw;
    in[0] = top, in[1] = top + 1, in[2] = top + W, in[3] = top + W + 1;
  } else {
    in[0] = row;
  }
}

template <typename T>
__device__ __forceinline__ uint4 load(const T* base, long long vec) {
  return __ldg(reinterpret_cast<const uint4*>(base) + vec);
}

// rows (pixels) a thread loads before it computes: 64 bytes of x and res in
// flight a thread without the pool, 128 with it
template <bool POOL, bool RES>
__host__ __device__ constexpr int unroll() {
  return POOL ? 2 : (RES ? 2 : 4);
}

// Without the pool: rows = N*H*W pixels, each of cvecs vectors. With it:
// rows = N*PH*PW output pixels of an [N, H, W, C] input. RES: a residual is
// added (kResidual; not with the pool); the other flags are read at run time.
template <typename T, bool POOL, bool RES>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bn_act_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ out,
                  Fold f, Fold rf, float eps, int flags, long long rows, int cvecs, unsigned H,
                  unsigned W, unsigned PH, unsigned PW) {
  static_assert(!(POOL && RES), "the pool takes no residual");
  typedef Word<T> Op;
  constexpr int U = unroll<POOL, RES>();
  constexpr int L = POOL ? 4 : 1;  // input vectors an output vector reads
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x / cvecs;  // rows a pass
  const int cv = (int)(t % cvecs);
  const long long r0 = t / cvecs;
  if (r0 >= step) return;  // past the last whole row of vectors of a pass

  const Channels ch = fold_channels<T, RES>(f, rf, eps, flags, cv * 4 * Op::N);

  for (long long r = r0; r < rows; r += step * U) {
    uint4 xv[U][L], rv[U][L];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = r + u * step;
      if (row >= rows) break;
      long long in[L];
      inputs<POOL>(row, H, W, PH, PW, in);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        xv[u][l] = load(x, in[l] * cvecs + cv);
        rv[u][l] = RES ? load(res, in[l] * cvecs + cv) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = r + u * step;
      if (row >= rows) break;
      uint4 ov;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (POOL) {  // avg_pool2d's order: 0 + (h, w), (h, w+1), (h+1, w), (h+1, w+1)
          uint32_t e[L];
#pragma unroll
          for (int l = 0; l < L; ++l)
            e[l] = epilogue<T, RES>(ch, flags, word(xv[u][l], k), word(rv[u][l], k), k);
          float mean[Op::N];
#pragma unroll
          for (int i = 0; i < Op::N; ++i) {
            float sum = 0.f;
#pragma unroll
            for (int l = 0; l < L; ++l) sum = __fadd_rn(sum, Op::get(e[l], i));
            mean[i] = __fmul_rn(sum, 0.25f);  // exactly sum / 4
          }
          word(ov, k) = Op::pack(mean);
        } else {
          word(ov, k) = epilogue<T, RES>(ch, flags, word(xv[u][0], k), word(rv[u][0], k), k);
        }
      }
      reinterpret_cast<uint4*>(out)[row * cvecs + cv] = ov;
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

template <typename T, bool POOL, bool RES>
int launch(const void* x, const void* res, void* out, Fold f, Fold rf, float eps, int flags,
           long long N, long long H, long long W, long long C, cudaStream_t st) {
  constexpr int U = unroll<POOL, RES>();
  const int cvecs = (int)(C / (4 * Word<T>::N));
  const long long PH = POOL ? H / 2 : H, PW = POOL ? W / 2 : W;
  const long long rows = N * PH * PW;
  if (rows == 0) return 0;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaGetLastError();
  // enough threads for every row's vectors in U-row passes, at most a full card's worth,
  // and at least one whole row of vectors
  const long long want = (rows + U - 1) / U * cvecs;
  long long blocks = (want + kThreads - 1) / kThreads;
  blocks = blocks < (long long)sms * kBlocksPerSm ? blocks : (long long)sms * kBlocksPerSm;
  const long long least = (cvecs + kThreads - 1) / kThreads;
  blocks = blocks > least ? blocks : least;
  bn_act_kernel<T, POOL, RES><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(out), f, rf, eps,
      flags, rows, cvecs, (unsigned)H, (unsigned)W, (unsigned)PH, (unsigned)PW);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* res, void* out, Fold f, Fold rf, float eps, int flags,
             long long N, long long H, long long W, long long C, cudaStream_t st) {
  switch (flags & (kPool | kResidual)) {
    case 0: return launch<T, false, false>(x, res, out, f, rf, eps, flags, N, H, W, C, st);
    case kResidual: return launch<T, false, true>(x, res, out, f, rf, eps, flags, N, H, W, C, st);
    case kPool: return launch<T, true, false>(x, res, out, f, rf, eps, flags, N, H, W, C, st);
    default: return -1;  // the pool takes no residual
  }
}

// ---------------------------------------------------------------------------
// The backward: one pass over the activations, then the fold's gradients.

constexpr int kBackBlocksPerSm = 2;
constexpr int kSums = 3;  // per-channel sums: g_m, g_m * x, g_m * res

// rows (output pixels) a thread loads before it computes: g and x (and res)
// of 4 rows, 48-96 bytes a thread in flight, or of 2 with a residual; with
// the pool, one g and four x vectors for each of 2 output pixels, 160 bytes
template <bool POOL, bool RES>
__host__ __device__ constexpr int back_unroll() {
  return (POOL || RES) ? 2 : 4;
}

// the block layout: a block covers `tile` vectors of channels (all of a
// row's, or a third, ... of them where a row has more than kThreads) of
// kThreads / tile rows a pass; blocks along x walk the rows, along y the tiles
struct BackGrid {
  int tiles, tile, per;
  long long blocks;
};

template <bool POOL, bool RES>
BackGrid back_grid(long long rows, int cvecs, int sms) {
  BackGrid b;
  b.tiles = (cvecs + kThreads - 1) / kThreads;
  b.tile = (cvecs + b.tiles - 1) / b.tiles;
  b.per = kThreads / b.tile;
  const long long pass = (long long)b.per * back_unroll<POOL, RES>();
  const long long want = (rows + pass - 1) / pass;
  long long cap = (long long)sms * kBackBlocksPerSm / b.tiles;
  cap = cap > 1 ? cap : 1;
  b.blocks = want < cap ? want : cap;
  return b;
}

// A block's sums of its tile's channels over its rows, added in the order
// of the rows in shared memory; thread j of the block writes channel j (and
// j + kThreads, ...) of the tile to out. Every thread of the block calls it.
template <int V>
__device__ __forceinline__ void block_sum(const float (&acc)[V], float* red, int tile, int per,
                                          int cvecs, float* out) {
#pragma unroll
  for (int i = 0; i < V; ++i) red[threadIdx.x * V + i] = acc[i];
  __syncthreads();
  const int c0 = blockIdx.y * tile * V, C = cvecs * V;
  for (int j = threadIdx.x; j < tile * V && c0 + j < C; j += kThreads) {
    float sum = 0.f;
    for (int y = 0; y < per; ++y) sum += red[y * tile * V + j];
    out[c0 + j] = sum;
  }
  __syncthreads();
}

// Each thread owns a vector of channels and walks its rows as the forward
// does, recomputing the pre-activation from x (and res) to get relu's mask:
// g_m = g (g / 4 with the pool, spread over the window) where the mask
// passes, else 0; dx = g_m * inv (g_m without kFold), dres = g_m (g_m * rinv
// with kResidualFold), each rounded to T as autograd's multiply rounds it.
// It sums g_m, g_m * x and g_m * res per channel in fp32 registers; the
// block then adds its rows' sums in shared memory in a fixed order and
// writes them to partial[kSums][gridDim.x][C], for bn_act_grads_kernel.
template <typename T, bool POOL, bool RES>
__global__ void __launch_bounds__(kThreads, kBackBlocksPerSm)
    bn_act_backward_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           const T* __restrict__ res, T* __restrict__ dx, T* __restrict__ dres,
                           Fold f, Fold rf, float eps, int flags, long long rows, int cvecs,
                           int tile, unsigned H, unsigned W, unsigned PH, unsigned PW,
                           float* __restrict__ partial) {
  static_assert(!(POOL && RES), "the pool takes no residual");
  typedef Word<T> Op;
  constexpr int U = back_unroll<POOL, RES>();
  constexpr int L = POOL ? 4 : 1;
  constexpr int V = 4 * Op::N;  // channels a vector
  __shared__ float red[kThreads * V];

  const int per = kThreads / tile;
  const int cx = threadIdx.x % tile, ry = threadIdx.x / tile;
  const int cv = blockIdx.y * tile + cx;
  const bool active = ry < per && cv < cvecs;
  const bool fold_x = flags & kFold, fold_r = RES && (flags & kResidualFold);
  // x is read for relu's mask or inv's sum, res for the mask or rinv's: the
  // pool-only epilogue reads g alone
  const bool read_x = flags & (kRelu | kFold), read_r = RES && (flags & (kRelu | kResidualFold));
  const long long step = (long long)gridDim.x * per;  // rows a pass of the grid

  float sg[V] = {}, sgx[V] = {}, sgr[V] = {};
  if (active) {
    const Channels ch = fold_channels<T, RES>(f, rf, eps, flags, cv * V);
    for (long long r = blockIdx.x * (long long)per + ry; r < rows; r += step * U) {
      uint4 gv[U], xv[U][L], rv[U][L];
      long long in[U][L];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long row = r + u * step;
        if (row >= rows) break;
        inputs<POOL>(row, H, W, PH, PW, in[u]);
        gv[u] = load(g, row * cvecs + cv);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          xv[u][l] = read_x ? load(x, in[u][l] * cvecs + cv) : make_uint4(0, 0, 0, 0);
          rv[u][l] = read_r ? load(res, in[u][l] * cvecs + cv) : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long row = r + u * step;
        if (row >= rows) break;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          uint4 dv, drv;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t xw = word(xv[u][l], k), rw = word(rv[u][l], k);
            uint32_t gm = POOL ? Op::mul(word(gv[u], k), Op::kQuarter) : word(gv[u], k);
            if (flags & kRelu) gm &= Op::keep(pre<T, RES>(ch, flags, xw, rw, k));
            word(dv, k) = fold_x ? Op::mul(gm, word(ch.inv, k)) : gm;
            if (RES) word(drv, k) = fold_r ? Op::mul(gm, word(ch.rinv, k)) : gm;
            if (fold_x || fold_r) {
#pragma unroll
              for (int i = 0; i < Op::N; ++i) {
                const float gf = Op::get(gm, i);
                const int c = k * Op::N + i;
                sg[c] += gf;
                if (fold_x) sgx[c] = __fmaf_rn(gf, Op::get(xw, i), sgx[c]);
                if (fold_r) sgr[c] = __fmaf_rn(gf, Op::get(rw, i), sgr[c]);
              }
            }
          }
          reinterpret_cast<uint4*>(dx)[in[u][l] * cvecs + cv] = dv;
          if (RES) reinterpret_cast<uint4*>(dres)[in[u][l] * cvecs + cv] = drv;
        }
      }
    }
  }
  // the block's sums of each channel over its rows (uniform branches)
  float* out = partial + blockIdx.x * (long long)cvecs * V;
  const long long slot = (long long)gridDim.x * cvecs * V;  // floats a sum
  if (fold_x || fold_r) block_sum<V>(sg, red, tile, per, cvecs, out);
  if (fold_x) block_sum<V>(sgx, red, tile, per, cvecs, out + slot);
  if (fold_r) block_sum<V>(sgr, red, tile, per, cvecs, out + 2 * slot);
}

// the fp32 gradients of one BatchNorm's weight, bias, running_mean and
// running_var at channel c (out[0 .. 3][c]) through its fold, from the sums
// of the gradient at the multiply-add's output (sg: shift's gradient) and of
// that times its input (sgy: inv's): d_inv = sgy - sg * mean, d_weight =
// d_inv * rs, d_bias = sg, d_mean = -sg * inv, d_var = d_inv * weight *
// (-rs^3 / 2), with rs = rsqrt(var + eps), inv = rs * weight
__device__ void fold_grads(const Fold& f, int c, long long C, float eps, float sg, float sgy,
                           float* out) {
  const float rs = rsqrtf(__fadd_rn(f.var[c], eps)), w = f.weight[c];
  const float d_inv = sgy - sg * f.mean[c];
  out[c] = d_inv * rs;
  out[C + c] = sg;
  out[2 * C + c] = -(sg * (rs * w));
  out[3 * C + c] = d_inv * w * (-0.5f * rs * rs * rs);
}

// Sums each channel's partials over the `blocks` row blocks in a fixed
// order (8 slices of rows, then the slices), 32 channels a block, and
// writes grads[0 .. 3] (bn) and grads[4 .. 7] (the residual's), each [C].
constexpr int kSlices = kThreads / 32;
__global__ void __launch_bounds__(kThreads)
    bn_act_grads_kernel(const float* __restrict__ partial, long long blocks, int C, Fold f,
                        Fold rf, float eps, int flags, float* __restrict__ grads) {
  __shared__ float red[kSums][kSlices][32];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const bool fold_x = flags & kFold, fold_r = flags & kResidualFold;
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    float sum = 0.f;
    if (c < C && !((s == 1 && !fold_x) || (s == 2 && !fold_r)))
      for (long long b = slice; b < blocks; b += kSlices)
        sum += partial[((long long)s * blocks + b) * C + c];
    red[s][slice][lane] = sum;
  }
  __syncthreads();
  if (slice != 0 || c >= C) return;
  float t[kSums];
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    t[s] = 0.f;
    for (int y = 0; y < kSlices; ++y) t[s] += red[s][y][lane];
  }
  if (fold_x) fold_grads(f, c, C, eps, t[0], t[1], grads);
  if (fold_r) fold_grads(rf, c, C, eps, t[0], t[2], grads + 4 * (long long)C);
}

// floats of the scratch bn_act_backward_kernel's partial sums need
template <typename T, bool POOL, bool RES>
long long back_scratch(int flags, long long N, long long H, long long W, long long C) {
  if (!(flags & (kFold | kResidualFold))) return 0;
  const long long rows = POOL ? N * (H / 2) * (W / 2) : N * H * W;
  const BackGrid b = back_grid<POOL, RES>(rows, (int)(C / (4 * Word<T>::N)), sm_count());
  return (long long)kSums * b.blocks * C;
}

template <typename T, bool POOL, bool RES>
int launch_backward(const void* g, const void* x, const void* res, void* dx, void* dres, Fold f,
                    Fold rf, float* grads, float* scratch, long long scratch_floats, float eps,
                    int flags, long long N, long long H, long long W, long long C,
                    cudaStream_t st) {
  const int cvecs = (int)(C / (4 * Word<T>::N));
  const long long PH = POOL ? H / 2 : H, PW = POOL ? W / 2 : W;
  const long long rows = N * PH * PW;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaGetLastError();
  const BackGrid b = back_grid<POOL, RES>(rows, cvecs, sms);
  const bool sums = flags & (kFold | kResidualFold);
  if (sums && scratch_floats < (long long)kSums * b.blocks * C) return -1;
  if (rows > 0)
    bn_act_backward_kernel<T, POOL, RES><<<dim3((unsigned)b.blocks, (unsigned)b.tiles), kThreads,
                                           0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(res),
        static_cast<T*>(dx), static_cast<T*>(dres), f, rf, eps, flags, rows, cvecs, b.tile,
        (unsigned)H, (unsigned)W, (unsigned)PH, (unsigned)PW, scratch);
  if (sums)
    bn_act_grads_kernel<<<(unsigned)((C + 31) / 32), kThreads, 0, st>>>(
        scratch, rows > 0 ? b.blocks : 0, (int)C, f, rf, eps, flags, grads);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_backward(const void* g, const void* x, const void* res, void* dx, void* dres,
                      Fold f, Fold rf, float* grads, float* scratch, long long scratch_floats,
                      float eps, int flags, long long N, long long H, long long W, long long C,
                      cudaStream_t st) {
  switch (flags & (kPool | kResidual)) {
    case 0:
      return launch_backward<T, false, false>(g, x, res, dx, dres, f, rf, grads, scratch,
                                              scratch_floats, eps, flags, N, H, W, C, st);
    case kResidual:
      return launch_backward<T, false, true>(g, x, res, dx, dres, f, rf, grads, scratch,
                                             scratch_floats, eps, flags, N, H, W, C, st);
    case kPool:
      return launch_backward<T, true, false>(g, x, res, dx, dres, f, rf, grads, scratch,
                                             scratch_floats, eps, flags, N, H, W, C, st);
    default: return -1;  // the pool takes no residual
  }
}

// the arguments both directions check
bool bad_arguments(int dtype, int flags, bool res, long long N, long long H, long long W,
                   long long C) {
  const int per_vec = dtype == 0 ? 4 : 8;
  return (dtype != 0 && dtype != 1) || flags < 0 || flags >= 2 * kPool || N < 0 || H < 0 ||
         W < 0 || C < per_vec || C % per_vec != 0 || H >= (1LL << 31) || W >= (1LL << 31) ||
         N * H * W >= (1LL << 32) || ((flags & kResidualFold) && !(flags & kResidual)) ||
         ((flags & kResidual) && !res) || ((flags & kPool) && (flags & kResidual));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, res and out are channels-last
// (NHWC in memory) and 16-byte aligned; out is [N, H/2, W/2, C] with kPool,
// else [N, H, W, C]. flags: kFold 1, kResidual 2, kResidualFold 4 (with
// kResidual), kRelu 8, kPool 16 (without kResidual). w, b, m, v are the BatchNorm's fp32 [C]
// parameters (read with kFold), rw, rb, rm, rv the residual's (with
// kResidualFold). Returns 0, a cudaError_t from the launch, or -1 for
// arguments the kernel does not take.
int hgr_bn_act(int dtype, int flags, const void* x, const void* res, void* out, const float* w,
               const float* b, const float* m, const float* v, const float* rw, const float* rb,
               const float* rm, const float* rv, float eps, long long N, long long H,
               long long W, long long C, void* stream) {
  if (bad_arguments(dtype, flags, res != nullptr, N, H, W, C)) return -1;
  const Fold f{w, b, m, v}, rf{rw, rb, rm, rv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(x, res, out, f, rf, eps, flags, N, H, W, C, st)
                    : dispatch<bf16>(x, res, out, f, rf, eps, flags, N, H, W, C, st);
}

// Floats of scratch hgr_bn_act_backward needs for these arguments (0
// without a BatchNorm), or -1 for arguments it does not take.
long long hgr_bn_act_backward_scratch(int dtype, int flags, long long N, long long H, long long W,
                                      long long C) {
  if (bad_arguments(dtype, flags, true, N, H, W, C)) return -1;
  switch ((dtype == 1 ? 4 : 0) | (flags & kPool ? 2 : 0) | (flags & kResidual ? 1 : 0)) {
    case 0: return back_scratch<float, false, false>(flags, N, H, W, C);
    case 1: return back_scratch<float, false, true>(flags, N, H, W, C);
    case 2: return back_scratch<float, true, false>(flags, N, H, W, C);
    case 4: return back_scratch<bf16, false, false>(flags, N, H, W, C);
    case 5: return back_scratch<bf16, false, true>(flags, N, H, W, C);
    case 6: return back_scratch<bf16, true, false>(flags, N, H, W, C);
    default: return -1;
  }
}

// The backward of hgr_bn_act with the same dtype, flags, x, res and
// parameters: g is the gradient of its output (channels-last, [N, H/2, W/2,
// C] with kPool), dx and dres (with kResidual) receive the gradients of x
// and res, grads ([8, C] fp32, with kFold or kResidualFold) those of w, b, m,
// v in its rows 0-3 (with kFold) and of rw, rb, rm, rv in rows 4-7 (with
// kResidualFold); scratch holds scratch_floats floats, at least what
// hgr_bn_act_backward_scratch gives. With kPool and an odd H or W, dx's last
// row or column is left unwritten. Two launches at most; deterministic.
int hgr_bn_act_backward(int dtype, int flags, const void* g, const void* x, const void* res,
                        void* dx, void* dres, const float* w, const float* b, const float* m,
                        const float* v, const float* rw, const float* rb, const float* rm,
                        const float* rv, float* grads, float* scratch, float eps, long long N,
                        long long H, long long W, long long C, long long scratch_floats,
                        void* stream) {
  if (bad_arguments(dtype, flags, res != nullptr, N, H, W, C) || ((flags & kResidual) && !dres) ||
      ((flags & (kFold | kResidualFold)) && !grads))
    return -1;
  const Fold f{w, b, m, v}, rf{rw, rb, rm, rv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_backward<float>(g, x, res, dx, dres, f, rf, grads, scratch,
                                               scratch_floats, eps, flags, N, H, W, C, st)
                    : dispatch_backward<bf16>(g, x, res, dx, dres, f, rf, grads, scratch,
                                              scratch_floats, eps, flags, N, H, W, C, st);
}

const char* hgr_bn_act_error_string(int code) {
  if (code == -1) return "bad arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
