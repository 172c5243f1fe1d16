// K1: fused softmax attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces hgr_tpu/ops/attention.py:_attn_kernel (the Pallas TPU kernel,
// launched by _pallas_attention_padded and wrapped by pallas_attention). It
// computes the same function: q pre-scaled by Dh^-0.5 in its own dtype,
// fp32 scores q.k^T plus an optional additive fp32 [T, T] mask, an fp32
// max-subtracted softmax, probabilities rounded to v's dtype, then P.V with
// fp32 accumulators, rounded to the output dtype. Head dim 64, T <= 256,
// bf16 or fp32. The TPU kernel's padding of T to 8 and Dh to 128 was a
// layout artefact; here the ragged edge is masked in the kernel.
//
// What bounds it on the H100: memory. At the bank build's shape (512
// prompts x 8 heads, T = 32, Dh = 64, bf16) q, k, v and o move 4 x 16.8 MB
// = 67 MB a launch for 1.07 GFLOP of products (16 FLOP per byte, far under
// the ~295 at which bf16 tensor cores become the limit): about 20 us at
// 3.35 TB/s. The bank build launches it 12 layers x 36 chunks = 432 times.
//
// Design (the simple first version): one block per (batch*head, tile of 32
// query rows), 8 warps. The block stages the head's K and V in shared
// memory with 16-byte loads (K rows padded by one 32-bit word so that lanes
// reading different keys hit different banks). Each warp owns one query
// row at a time: every lane scores keys lane, lane+32, ... against the q
// row held in registers, the warp reduces max and sum with shuffles, writes
// the rounded probabilities to a per-warp shared row, and each lane then
// accumulates two of the 64 output dims over all keys. q, k, v and o are
// read and written through strides, so the caller can pass views of the
// packed [B, T, 3D] projection with no transpose copy. The [T, T] scores
// never leave the SM. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;            // head dim
constexpr int kWarps = 8;          // warps per block
constexpr int kRowsPerBlock = 32;  // query rows per block
constexpr int kMaxT = 256;
constexpr int kKeysPerLane = kMaxT / 32;

struct Strides {
  long long b, h, t;  // in elements; the head-dim stride is 1
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static float round(float x) { return x; }
  __device__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  // fp32 q row (registers) . K row (shared memory words)
  __device__ static float dot(const float* q, const uint32_t* krow) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kDh; ++d) s = fmaf(q[d], __uint_as_float(krow[d]), s);
    return s;
  }
  // V elements 2*lane and 2*lane+1 of one row
  __device__ static float2 v2(const uint32_t* vrow, int lane) {
    return *reinterpret_cast<const float2*>(vrow + 2 * lane);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  // a word holds elements 2w (low half) and 2w+1 (high half); a bf16 is
  // the upper 16 bits of the fp32 with the same value
  __device__ static float dot(const float* q, const uint32_t* krow) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kDh / 2; ++w) {
      const uint32_t u = krow[w];
      s = fmaf(q[2 * w], __uint_as_float(u << 16), s);
      s = fmaf(q[2 * w + 1], __uint_as_float(u & 0xffff0000u), s);
    }
    return s;
  }
  __device__ static float2 v2(const uint32_t* vrow, int lane) {
    const uint32_t u = vrow[lane];
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
};

template <typename T>
__host__ __device__ constexpr int row_words() {
  return kDh / Elem<T>::kPerWord;
}

template <typename T>
size_t smem_bytes(int T_len) {
  constexpr int RW = row_words<T>();
  return sizeof(uint32_t) * ((size_t)T_len * RW + (size_t)T_len * (RW + 1)) +
         sizeof(float) * ((size_t)kWarps * kDh + (size_t)kWarps * T_len);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ mask,
              T* __restrict__ o, int H, int T_len, float scale, Strides qs,
              Strides ks, Strides vs, Strides os) {
  constexpr int RW = row_words<T>();  // 32-bit words per row
  constexpr int KW = RW + 1;          // padded K row stride
  constexpr int CHUNKS = RW / 4;      // 16-byte chunks per row
  constexpr int kElemsPerChunk = 16 / sizeof(T);

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* v_s = smem;                                     // [T][RW]
  uint32_t* k_s = v_s + T_len * RW;                         // [T][KW]
  float* q_s = reinterpret_cast<float*>(k_s + T_len * KW);  // [kWarps][kDh]
  float* p_s = q_s + kWarps * kDh;                          // [kWarps][T]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const T* qh = q + b * qs.b + h * qs.h;
  const T* kh = k + b * ks.b + h * ks.h;
  const T* vh = v + b * vs.b + h * vs.h;
  T* oh = o + b * os.b + h * os.h;

  for (int i = threadIdx.x; i < T_len * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const uint4 kv = *reinterpret_cast<const uint4*>(kh + r * ks.t + c * kElemsPerChunk);
    const uint4 vv = *reinterpret_cast<const uint4*>(vh + r * vs.t + c * kElemsPerChunk);
    uint32_t* kd = k_s + r * KW + c * 4;
    kd[0] = kv.x;
    kd[1] = kv.y;
    kd[2] = kv.z;
    kd[3] = kv.w;
    *reinterpret_cast<uint4*>(v_s + r * RW + c * 4) = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = q_s + warp * kDh;
  float* pw = p_s + warp * T_len;
  const int r_end = min(T_len, (int)(blockIdx.y + 1) * kRowsPerBlock);
  for (int r = blockIdx.y * kRowsPerBlock + warp; r < r_end; r += kWarps) {
    // the q row, pre-scaled in its own dtype as pallas_attention does
    const float2 qv = Elem<T>::load2(qh + r * qs.t + 2 * lane);
    qw[2 * lane] = Elem<T>::round(qv.x * scale);
    qw[2 * lane + 1] = Elem<T>::round(qv.y * scale);
    __syncwarp();
    float qf[kDh];
#pragma unroll
    for (int d = 0; d < kDh; ++d) qf[d] = qw[d];

    const float* mrow = mask ? mask + (long long)r * T_len : nullptr;
    float s[kKeysPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      s[i] = -INFINITY;
      if (j < T_len) {
        s[i] = Elem<T>::dot(qf, k_s + j * KW);
        if (mrow) s[i] += mrow[j];
        m = fmaxf(m, s[i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      if (lane + 32 * i < T_len) {
        s[i] = expf(s[i] - m);
        sum += s[i];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      if (j < T_len) pw[j] = Elem<T>::round(s[i] / sum);
    }
    __syncwarp();

    // P.V: this lane owns output dims 2*lane and 2*lane+1
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < T_len; ++j) {
      const float p = pw[j];
      const float2 vv = Elem<T>::v2(v_s + j * RW, lane);
      a0 = fmaf(p, vv.x, a0);
      a1 = fmaf(p, vv.y, a1);
    }
    Elem<T>::store2(oh + r * os.t + 2 * lane, a0, a1);
    __syncwarp();  // qw and pw are rewritten for this warp's next row
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* o, int B, int H, int T_len, float scale, Strides qs,
           Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(T_len);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (T_len + kRowsPerBlock - 1) / kRowsPerBlock);
  attention_fwd<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(o), H, T_len, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns 0, a
// cudaError_t from the launch, or -1 for shapes the kernel does not take.
int hgr_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                      const float* mask, void* o, int B, int H, int T_len,
                      int Dh, float scale, long long q_sb, long long q_sh,
                      long long q_st, long long k_sb, long long k_sh,
                      long long k_st, long long v_sb, long long v_sh,
                      long long v_st, long long o_sb, long long o_sh,
                      long long o_st, void* stream) {
  if (Dh != kDh || T_len < 1 || T_len > kMaxT || B < 1 || H < 1) return -1;
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st};
  const Strides vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, o, B, H, T_len, scale, qs, ks, vs, os, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, o, B, H, T_len, scale, qs, ks, vs, os, st);
  return -1;
}

const char* hgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
