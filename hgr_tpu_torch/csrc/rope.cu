// EVA-02's 2-D rotary embedding of q and k in one pass over device memory,
// for Hopper (sm_90a), with a plain C interface.
//
// Replaces no TPU kernel: the JAX package has no EVA-02 tower, and on a TPU
// XLA would fuse the turn into the q/k/v product's epilogue. In eager
// PyTorch the turn of the q/k/v GEMM's strided q and k rows is a pass for
// each op: the pair swap (an index kernel), t * cos, the swapped product and
// the sum, each reading and writing all of q and k.
//
// What it computes, for rows of Dh channels at token position t (row 0 of
// the tables is the class token's, cos 1 and sin 0) and each channel pair
// (2j, 2j+1), with cos and the signed sin' (rotate_half's sign on the even
// channel) fp32 tables [T, Dh]:
//   out_2j   = x_2j cos_2j + x_2j+1 sin'_2j
//   out_2j+1 = x_2j+1 cos_2j+1 + x_2j sin'_2j+1
// each product and the sum rounded to fp32 (no fused multiply-add), then the
// sum rounded once to the activation dtype T (bf16 or fp32). That is the
// twin's arithmetic (models/layers.py rotary: the fp32 products and sum of
// PyTorch's ops), bit for bit, and EVA's own (t * freqs_cos +
// rotate_half(t) * freqs_sin in fp32, then .type_as(v)): rotate_half's
// negation sits in the table's sign, which changes no product's bits.
//
// What bounds it on the H100: bytes. Four products and two sums a pair
// against 8 bytes in bf16 (a pair read, a pair written), far under the ~295
// FLOP per byte at which the SMs would be the limit. So the design moves
// each byte of q and k once, in 16-byte accesses, with enough in flight:
// - a thread takes 8 channels, four whole pairs, so the swap happens in its
//   registers: one 16-byte vector in bf16, two in fp32;
// - a block takes one token position t and kRows rows of the batch at that
//   position (b, t), all 2H Dh channels of each (4 KB a row in bf16 at
//   EVA02-CLIP-L/14's 32 heads of 64), a thread the same 8 channels of each
//   of its kRows rows; it loads its 8 cos and 8 sin values once (fp32, from
//   a table of 2 x 66 KB that stays in L1 and L2, since every head shares
//   it) and all kRows input vectors before it computes, so 64 bytes a
//   thread are in flight in bf16 (128 in fp32), about 64 KB an SM at four
//   256-thread blocks (56 registers);
// - consecutive blocks take consecutive positions of one group of rows, so
//   each row's reads and the writes are 4 KB runs of memory.
// On an H100 this reads 84-90% of the bound in bf16 at EVA02-CLIP-L/14's
// shape; a persistent grid, 2, 8 or 16 rows a block, 128-thread blocks and
// streaming cache hints on the loads and stores were each slower there
// (PERF.md).
// The input is a strided view (the q and k part of the q/k/v GEMM's [B, T,
// 3H, Dh] output) with any strides of whole 16-byte vectors; the output is
// contiguous [B, T, 2H, Dh]. Dh is a multiple of 8 up to 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 4;          // rows (b, t) of one position t a block
constexpr int kThreads = 256;     // the most threads a block
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ uint32_t word(const uint4& v, int k) { return (&v.x)[k]; }

// 8 channels of T as 16-byte vectors, to floats and back (rounded to T once)
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int V = 2;  // 16-byte vectors in 8 channels
  __device__ static void unpack(const uint4* v, float* f) {
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = __uint_as_float(word(v[k / 4], k % 4));
  }
  __device__ static void pack(const float* f, uint4* v) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      v[i] = make_uint4(__float_as_uint(f[4 * i]), __float_as_uint(f[4 * i + 1]),
                        __float_as_uint(f[4 * i + 2]), __float_as_uint(f[4 * i + 3]));
  }
};
template <>
struct Chunk<bf16> {
  static constexpr int V = 1;  // element 2k in the low half of word k
  __device__ static void unpack(const uint4* v, float* f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t w = word(v[0], k);
      f[2 * k] = __uint_as_float(w << 16);
      f[2 * k + 1] = __uint_as_float(w & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float a, float b) {  // a low, b high, each rounded
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return (uint32_t)__bfloat16_as_ushort(v.x) | ((uint32_t)__bfloat16_as_ushort(v.y) << 16);
  }
  __device__ static void pack(const float* f, uint4* v) {
    v[0] = make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

template <typename T>
struct RopeArgs {
  const T* x;         // row (b, t, r) at b * sb + t * st + r * sh elements
  T* out;             // contiguous [B, T, R, Dh]
  const float* cos;   // [T, Dh]
  const float* sin;   // [T, Dh], rotate_half's sign on even channels
  long long B;
  int nt, R, dv;      // positions, rows a position (2H), 8-channel chunks a row (Dh / 8)
  long long sb, st, sh;
};

// blockIdx.x: position t = blockIdx.x % nt of the row group blockIdx.x / nt
template <typename T>
__global__ void __launch_bounds__(kThreads) rope_kernel(const RopeArgs<T> a) {
  typedef Chunk<T> C;
  constexpr int V = C::V;
  const int t = (int)(blockIdx.x % (unsigned)a.nt);
  const long long b0 = (long long)(blockIdx.x / (unsigned)a.nt) * kRows;
  const int nvec = a.R * a.dv;  // 8-channel chunks a position's rows (b, t, :)
  const int dh = a.dv * 8;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int r = v / a.dv, c = (v - r * a.dv) * 8;
    uint4 in[kRows][V];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (b0 + i < a.B) {
        const uint4* src = reinterpret_cast<const uint4*>(
            a.x + (b0 + i) * a.sb + (long long)t * a.st + (long long)r * a.sh + c);
#pragma unroll
        for (int k = 0; k < V; ++k) in[i][k] = src[k];
      }
    }
    float cs[8], sn[8];
    const float4* cp = reinterpret_cast<const float4*>(a.cos + (long long)t * dh + c);
    const float4* sp = reinterpret_cast<const float4*>(a.sin + (long long)t * dh + c);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float4 cv = __ldg(cp + k), sv = __ldg(sp + k);
      cs[4 * k] = cv.x, cs[4 * k + 1] = cv.y, cs[4 * k + 2] = cv.z, cs[4 * k + 3] = cv.w;
      sn[4 * k] = sv.x, sn[4 * k + 1] = sv.y, sn[4 * k + 2] = sv.z, sn[4 * k + 3] = sv.w;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (b0 + i < a.B) {
        float f[8], o[8];
        C::unpack(in[i], f);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          o[j] = __fadd_rn(__fmul_rn(f[j], cs[j]), __fmul_rn(f[j + 1], sn[j]));
          o[j + 1] = __fadd_rn(__fmul_rn(f[j + 1], cs[j + 1]), __fmul_rn(f[j], sn[j + 1]));
        }
        uint4 res[V];
        C::pack(o, res);
        uint4* dst = reinterpret_cast<uint4*>(
            a.out + (((b0 + i) * a.nt + t) * a.R + r) * (long long)dh + c);
#pragma unroll
        for (int k = 0; k < V; ++k) dst[k] = res[k];
      }
    }
  }
}

template <typename T>
int rope(const void* x, void* out, const float* cos, const float* sin, long long B, int nt, int R,
         int dh, long long sb, long long st, long long sh, cudaStream_t stream) {
  if (B == 0 || nt == 0 || R == 0) return 0;
  const RopeArgs<T> a{static_cast<const T*>(x), static_cast<T*>(out), cos, sin, B, nt, R,
                      dh / 8, sb, st, sh};
  const long long blocks = (B + kRows - 1) / kRows * nt;
  const int nvec = R * (dh / 8);
  const int threads = nvec >= kThreads ? kThreads : (nvec + 31) / 32 * 32;
  rope_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x holds B x T x R rows of dh elements,
// row (b, t, r) at element b * sb + t * st + r * sh, each row contiguous;
// out is written as contiguous [B, T, R, dh]. cos and sin are contiguous
// fp32 [T, dh], sin signed as above. dh is a multiple of 8 from 8 to 128;
// every pointer is 16-byte aligned and every stride a multiple of 16 bytes.
// Returns 0, a cudaError_t from the launch, or -1 for arguments the kernel
// does not take.
int hgr_rope(int dtype, const void* x, void* out, const float* cos, const float* sin,
             long long B, long long T, long long R, long long dh, long long sb, long long st,
             long long sh, void* stream) {
  const int per_vec = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || B < 0 || T < 0 || R < 0 || dh < 8 || dh > kMaxHeadDim ||
      dh % 8 != 0 || sb < 0 || st < 0 || sh < 0 || sb % per_vec != 0 || st % per_vec != 0 ||
      sh % per_vec != 0 || T >= (1LL << 31) || R * (dh / 8) >= (1LL << 31) ||
      (B + kRows - 1) / kRows * T >= (1LL << 31) || !x || !out || !cos || !sin)
    return -1;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? rope<float>(x, out, cos, sin, B, (int)T, (int)R, (int)dh, sb, st, sh, st_)
                    : rope<bf16>(x, out, cos, sin, B, (int)T, (int)R, (int)dh, sb, st, sh, st_);
}

const char* hgr_rope_error_string(int code) {
  if (code == -1) return "bad arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
