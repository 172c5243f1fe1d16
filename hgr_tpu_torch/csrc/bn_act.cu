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

// the epilogue of word k of one vector, before the pool
template <typename T, bool RES>
__device__ __forceinline__ uint32_t epilogue(const Channels& ch, int flags, uint32_t x,
                                             uint32_t r, int k) {
  typedef Word<T> W;
  if (flags & kFold) x = W::add(W::mul(x, word(ch.inv, k)), word(ch.shift, k));
  if (RES) {
    if (flags & kResidualFold) r = W::add(W::mul(r, word(ch.rinv, k)), word(ch.rshift, k));
    x = W::add(x, r);
  }
  if (flags & kRelu) x = W::relu(x);
  return x;
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

  Channels ch = {};
  const int c0 = cv * 4 * Op::N;  // the thread's first channel
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

  for (long long r = r0; r < rows; r += step * U) {
    uint4 xv[U][L], rv[U][L];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = r + u * step;
      if (row >= rows) break;
      long long in[L];
      if constexpr (POOL) {  // output pixel (n, ph, pw) reads (n, 2ph + a, 2pw + b)
        const unsigned o = (unsigned)row, pw = o % PW, nph = o / PW, ph = nph % PH, n = nph / PH;
        const long long top = ((long long)n * H + 2 * ph) * W + 2 * pw;
        in[0] = top, in[1] = top + 1, in[2] = top + W, in[3] = top + W + 1;
      } else {
        in[0] = row;
      }
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
  const int per_vec = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || flags < 0 || flags >= 2 * kPool || N < 0 || H < 0 ||
      W < 0 || C < per_vec || C % per_vec != 0 || H >= (1LL << 31) || W >= (1LL << 31) ||
      N * H * W >= (1LL << 32) ||
      ((flags & kResidualFold) && !(flags & kResidual)) || ((flags & kResidual) && !res))
    return -1;
  const Fold f{w, b, m, v}, rf{rw, rb, rm, rv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(x, res, out, f, rf, eps, flags, N, H, W, C, st)
                    : dispatch<bf16>(x, res, out, f, rf, eps, flags, N, H, W, C, st);
}

const char* hgr_bn_act_error_string(int code) {
  if (code == -1) return "bad arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
