// K1: fused softmax attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces hgr_tpu/ops/attention.py:_attn_kernel (the Pallas TPU kernel,
// launched by _pallas_attention_padded and wrapped by pallas_attention). It
// computes the same function: q pre-scaled by Dh^-0.5 in its own dtype,
// fp32 scores q.k^T plus an optional additive fp32 [T, T] mask, an fp32
// max-subtracted softmax, probabilities normalised in fp32 and rounded to
// v's dtype, then P.V with fp32 accumulators, rounded to the output dtype.
// Head dim 64, 1 <= T <= 256, bf16 or fp32, q/k/v/o through strides (the
// caller passes views of the packed [B, T, 3D] projection and gets a view of
// a [B, T, H, Dh] buffer back, so no head transpose is copied). The TPU
// kernel's padding of T to 8 and Dh to 128 was a layout artefact; here the
// ragged edge is masked in the kernel.
//
// What bounds it on the H100: bytes. At the bank build's shape (512 prompts
// x 8 heads, T = 32, Dh = 64, bf16) q, k, v and o move 4 x 16.8 MB = 67 MB
// a launch for 1.07 GFLOP of products: 16 FLOP per byte, far under the ~295
// at which bf16 tensor cores become the limit, so the floor is about 20 us
// at 3.35 TB/s. The bank build launches it 12 layers x 36 chunks = 432 times.
//
// bf16 design (attention_fwd_bf16), each part for a reason:
// - One block owns one prompt and a group of HG heads at a time (an item)
//   and covers all T query rows of each, so each head's K and V are read
//   from device memory once. One warp per 16 query rows; HG is the largest
//   divisor of H that fills the block (at T = 32: 4 heads, 8 warps).
// - Persistent blocks, two item buffers: the grid is as many blocks as fit
//   on the card, each walks items with a stride of the grid, and the next
//   item's copies are issued before the current one is computed. The copies
//   are cp.async.cg 16-byte copies into an XOR-swizzled layout (16-byte chunk
//   c of row r sits at c ^ (r & 7)), so that ldmatrix reads 8 rows of one
//   column chunk without bank conflicts; rows past T are zero-filled by the
//   copy itself. At T = 32 that is 48 KB an item and, with two blocks an SM,
//   up to 96 KB in flight per SM (3.35 TB/s at ~1 us needs ~25 KB).
// - q.k^T and P.V run on the tensor cores through mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate), fragments loaded by ldmatrix (V by ldmatrix.trans).
//   wgmma is not used: it takes 64-row tiles while a head has 32 rows at the
//   main shape, and since bytes bound the kernel the tensor-core rate is not
//   its limit; the point is to take the per-row scalar chain off the
//   critical path.
// - The softmax stays in registers: row max and sum by quad shuffles over the
//   accumulator fragments, probabilities exp(s - m) * (1/l) in fp32 (exp by
//   the SFU's ex2), rounded to bf16 and repacked straight into the A
//   fragments of P.V, which runs in two halves of 32 output dims so that
//   fewer accumulators are live at once.
// - One pass while a warp's scores fit its registers without spilling
//   (T <= 96, from -Xptxas -v); above that two passes over 48-key tiles: the
//   first finds each row's max and sum, the second recomputes q.k^T and
//   accumulates P.V with the final normalisation. No flash-style rescaling
//   of P.V: that would round unnormalised probabilities to bf16, which
//   _attn_kernel does not do. Each instantiation's block size and resident
//   blocks (template arguments) set its register budget. ldmatrix addresses
//   are a per-lane base XOR a compile-time chunk plus a compile-time row
//   offset, so they hold no register per tile: that is what lets T = 77 (80
//   keys, 40 score registers) run one pass with 3 blocks of 5 warps an SM.
// - The [T, T] mask is the same for every block. Each block sorts its 16x16
//   tiles once: all -inf (the tile is skipped: its probabilities are exactly
//   0), all 0 (nothing to add), or mixed. Mixed tiles go into shared-memory
//   slots (a row stride of 24 words keeps a quad's reads on distinct banks)
//   as far as the blocks-per-SM budget leaves room, the rest are read
//   through the cache. Any additive mask is taken and nothing is assumed
//   about its shape: a causal mask at T = 77 has 10 dead, 10 zero and 5
//   mixed tiles.
// - q is not pre-scaled in shared memory: the fp32 score is multiplied by
//   Dh^-0.5 = 2^-3, a power of two, which gives exactly the score of the
//   pre-scaled bf16 q.
// - The output tile goes through the warp's own (finished) q rows in shared
//   memory to 16-byte stores, 128 contiguous bytes per row.
//
// fp32 (attention_fwd_f32) keeps the first SIMT design: tensor cores would
// mean TF32, and fp32 is the parity mode. One block per (batch*head, tile of
// 32 query rows), K and V staged in shared memory, one warp per query row
// with fp32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kDh = 64;  // head dim
constexpr int kMaxT = 256;

struct Strides {
  long long b, h, t;  // in elements; the head-dim stride is 1
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMaxWarps = 16;          // warps per block: one per 16 rows, T <= 256
constexpr int kRowBytes = kDh * 2;     // one bf16 row: 128 bytes
constexpr int kChunks = kRowBytes / 16;
constexpr int kTwoPassTiles = 3;       // key tiles of 48 in the two passes
constexpr int kSmemPerSm = 228 * 1024; // an SM's shared memory
constexpr int kSmemReserved = 1024;    // the system's share of each block
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kSlotStride = 24;        // words per row of a staged 16x16 mask tile
constexpr int kSlotBytes = 16 * kSlotStride * 4;
// what a 16x16 tile of the mask holds, for one row tile's real rows (pad keys
// count as -inf): all -inf, all 0, anything else read from device memory, or
// (>= kSlot) anything else staged in shared-memory slot code - kSlot
constexpr uint8_t kDead = 0, kZero = 1, kGlobal = 2, kSlot = 3;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a swizzled [rows][64] bf16 tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

// The same as a row base XOR the chunk: swz(r, c) == row_base(r) ^ (c << 4),
// and row_base(r + 16n) == row_base(r) + 2048n. So an ldmatrix address is a
// per-lane base XOR a compile-time chunk plus a compile-time row offset, and
// needs no register per (tile, chunk). Tiles start on 128-byte boundaries.
__device__ __forceinline__ uint32_t row_base(int r) {
  return r * kRowBytes | ((r & 7) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b for one 16x8 fp32 tile; a 16x16 bf16 (row), b 16x8 bf16 (col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in fp32 by the SFU (relative error ~2^-22; subnormal results flush to 0)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16; the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Scores of this warp's 16 query rows (row0..row0+15) against key tiles
// kt0 .. kt0+KT-1: q.k^T * scale + mask, -inf past T. Accumulator layout of
// m16n8: S[j] covers keys kt0*16 + 8j .. +7; lane holds rows g and g+8
// (g = lane/4), keys 2(lane%4) and +1 (elements 0,1 for row g; 2,3 for g+8).
// codes[kt] says what the mask holds in key tile kt for these rows: a dead
// tile costs no mma. x * 2^-3 is exact, so fma(x, scale, m) rounds as the
// plain x * scale + m does.
template <int KT>
__device__ __forceinline__ void scores(float (&S)[2 * KT][4], uint32_t q_s, uint32_t k_s,
                                       int row0, int kt0, int RT, int T, float scale,
                                       const float* mask, const uint8_t* codes,
                                       const float* slots, int lane) {
  uint32_t dead = 0;  // bit j: key tile kt0 + j is past T or dead
#pragma unroll
  for (int j = 0; j < KT; ++j)
    if (kt0 + j >= RT || codes[kt0 + j] == kDead) dead |= 1u << j;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.f;
  // q rows row0 + lane%16, chunk 2kd + lane/16; keys 16kt + lane%8 +
  // 8(lane/16), chunk 2kd + (lane/8)%2
  const uint32_t qa = (q_s + row_base(row0 + (lane & 15))) ^ ((lane >> 4) << 4);
  const uint32_t ka = (k_s + row_base((lane & 7) + ((lane >> 4) << 3))) ^ (((lane >> 3) & 1) << 4);
#pragma unroll
  for (int kd = 0; kd < kDh / 16; ++kd) {
    uint32_t a[4];  // q rows row0..+15, dims 16kd..+15
    ldsm_x4(qa ^ (kd << 5), a);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (!((dead >> j) & 1u)) {
        // keys n0..n0+7 dims lo/hi, then keys n0+8..15 dims lo/hi
        uint32_t b[4];
        ldsm_x4((ka ^ (kd << 5)) + (kt0 + j) * 16 * kRowBytes, b);
        mma(S[2 * j], a, b[0], b[1]);
        mma(S[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const float* mrow[2];  // this lane's two mask rows, or null (no mask, pad row)
#pragma unroll
  for (int h = 0; h < 2; ++h)
    mrow[h] = mask != nullptr && row0 + g + 8 * h < T ? mask + (row0 + g + 8 * h) * T : nullptr;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const int code = (dead >> j) & 1u ? kDead : codes[kt0 + j];
#pragma unroll
    for (int jj = 2 * j; jj < 2 * j + 2; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x0 = S[jj][2 * h];
        float& x1 = S[jj][2 * h + 1];
        const int row = row0 + g + 8 * h, col = kt0 * 16 + 8 * jj + c2;
        if (code == kDead) {
          x0 = x1 = -INFINITY;
        } else if (code == kZero) {
          x0 *= scale;
          x1 *= scale;
        } else if (code == kGlobal) {
          x0 *= scale;
          x1 *= scale;
          if (mrow[h] != nullptr) {
            if (col < T) x0 += __ldg(mrow[h] + col);
            if (col + 1 < T) x1 += __ldg(mrow[h] + col + 1);
          }
          if (col >= T) x0 = -INFINITY;
          if (col + 1 >= T) x1 = -INFINITY;
        } else {
          const float2 m = *reinterpret_cast<const float2*>(
              slots + (code - kSlot) * 16 * kSlotStride + (g + 8 * h) * kSlotStride +
              8 * (jj - 2 * j) + c2);
          x0 = fmaf(x0, scale, m.x);
          x1 = fmaf(x1, scale, m.y);
        }
      }
    }
  }
}

// P rounded to bf16 A fragments: rows row0..+15, keys 16j..+15 of the pass
template <int KT>
__device__ __forceinline__ void pack_p(uint32_t (&P)[KT][4], const float (&S)[2 * KT][4],
                                       const float (&inv)[2]) {
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      P[j][h] = pack_bf16(S[2 * j][2 * h] * inv[h], S[2 * j][2 * h + 1] * inv[h]);
      P[j][2 + h] = pack_bf16(S[2 * j + 1][2 * h] * inv[h], S[2 * j + 1][2 * h + 1] * inv[h]);
    }
}

// O += P.V over the live key tiles kt0..kt0+KT-1, for output dims
// 32half..32half+31 (O[n] covers dims 32half + 8n..+7)
template <int KT>
__device__ __forceinline__ void pv_half(float (&O)[4][4], const uint32_t (&P)[KT][4],
                                        uint32_t v_s, int kt0, int RT, const uint8_t* codes,
                                        int half, int lane) {
  // keys 16kt + lane%8 + 8((lane/8)%2), chunk 4half + 2nd + lane/16
  const uint32_t va = (v_s + row_base((lane & 7) + (((lane >> 3) & 1) << 3))) ^ ((lane >> 4) << 4);
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const int kt = kt0 + j;
    if (kt < RT && codes[kt] != kDead) {
#pragma unroll
      for (int nd = 0; nd < 2; ++nd) {
        // V^T: keys 16kt..+7 / +8..15 of 16 dims: the low 8, then the high 8
        uint32_t bv[4];
        ldsm_x4_trans((va ^ ((4 * half + 2 * nd) << 4)) + kt * 16 * kRowBytes, bv);
        mma(O[2 * nd], P[j], bv[0], bv[1]);
        mma(O[2 * nd + 1], P[j], bv[2], bv[3]);
      }
    }
  }
}

// one half of the output tile, rounded to bf16, into rows row0..+15 of the
// swizzled tile at byte offset off
__device__ __forceinline__ void stage_half(uint8_t* smem, int off, const float (&O)[4][4],
                                           int row0, int half, int lane) {
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(smem + off + swz(row0 + g + 8 * h, 4 * half + n) + 2 * c2) =
          pack_bf16(O[n][2 * h], O[n][2 * h + 1]);
}

// KT: 16-key tiles a pass holds in registers. kThreads and kMinBlocks are
// the block size and resident blocks that the instantiation serves; they set
// its register budget (65536 / (kThreads * kMinBlocks), at most 255).
template <int KT, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attention_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ mask,
                   bf16* __restrict__ o, int B, int H, int HG, int T_len, float scale,
                   int n_slots, Strides qs, Strides ks, Strides vs, Strides os) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int Tp = (T_len + 15) & ~15;  // rows padded to the 16-row mma tile
  const int RT = Tp / 16;
  const int tile = Tp * kRowBytes;    // one swizzled [Tp][64] bf16 tile
  const int buf_bytes = 3 * HG * tile;  // one item: [head][q|k|v][Tp][64]
  const int groups = H / HG, n_items = B * groups;
  const uint32_t base = smem_addr(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  uint8_t* codes = smem + 2 * buf_bytes;                          // [RT][RT]
  uint32_t* live = reinterpret_cast<uint32_t*>(codes + ((RT * RT + 15) & ~15));  // [RT]
  uint32_t* nonzero = live + kMaxT / 16;                          // [RT]
  float* slots = reinterpret_cast<float*>(nonzero + kMaxT / 16);  // [n_slots][16][kSlotStride]

  // every copy of one work item (prompt, head group) into buffer buf, as
  // one cp.async group; rows past T are zero-filled
  auto issue = [&](int item, int buf) {
    const int b = item / groups, h0 = (item % groups) * HG, c = threadIdx.x & 7;
    for (int t = 0; t < 3 * HG; ++t) {
      const int which = t % 3;
      const Strides s = which == 0 ? qs : which == 1 ? ks : vs;
      const bf16* src = (which == 0 ? q : which == 1 ? k : v) + b * s.b +
                        (h0 + t / 3) * s.h + c * 8;
      const uint32_t dst = base + buf * buf_bytes + t * tile;
      for (int r = threadIdx.x >> 3; r < Tp; r += blockDim.x >> 3)
        cp_async16(dst + swz(r, c), src + min(r, T_len - 1) * s.t, r < T_len ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int item = blockIdx.x;  // the grid is never larger than n_items
  issue(item, 0);

  // once per block: what each 16x16 tile of the mask holds (pad keys count
  // as -inf), and the mixed tiles copied into the free slots (-inf on pad
  // keys, 0 on pad rows). Dead tiles are exact to skip: their probabilities
  // are exactly 0. Without a mask every tile is zero, but the last one holds
  // the pad keys.
  if (mask == nullptr) {
    for (int t = threadIdx.x; t < RT * RT; t += blockDim.x)
      codes[t] = t % RT == RT - 1 && T_len % 16 ? kGlobal : kZero;
  } else {
    // each thread reads 16-key row segments (16 loads in flight) and ORs
    // the segment's tile bit into the row tile's live / nonzero words
    if (threadIdx.x < RT) live[threadIdx.x] = nonzero[threadIdx.x] = 0u;
    __syncthreads();
    for (int sg = threadIdx.x; sg < T_len * RT; sg += blockDim.x) {
      const int r = sg / RT, kt = sg % RT;
      float m[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = kt * 16 + i;
        m[i] = c < T_len ? __ldg(mask + r * T_len + c) : -INFINITY;
      }
      bool is_live = false, is_zero = true;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        is_live |= m[i] != -INFINITY;
        is_zero &= m[i] == 0.f;
      }
      if (is_live) atomicOr(live + r / 16, 1u << kt);
      if (!is_zero) atomicOr(nonzero + r / 16, 1u << kt);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = 0, n = 0; t < RT * RT; ++t) {
        const int rt = t / RT, kt = t % RT;
        const uint8_t code = !((live[rt] >> kt) & 1u) ? kDead
                             : !((nonzero[rt] >> kt) & 1u) ? kZero
                             : n < n_slots ? kSlot + n++ : kGlobal;
        codes[t] = code;
      }
    }
    __syncthreads();
    for (int t = warp; t < RT * RT; t += n_warps) {
      if (codes[t] < kSlot) continue;
      const int rt = t / RT, kt = t % RT;
      float* dst = slots + (codes[t] - kSlot) * 16 * kSlotStride;
#pragma unroll
      for (int i = lane; i < 256; i += 32) {
        const int r = rt * 16 + i / 16, c = kt * 16 + i % 16;
        dst[(i / 16) * kSlotStride + i % 16] =
            c >= T_len ? -INFINITY : r < T_len ? __ldg(mask + r * T_len + c) : 0.f;
      }
    }
  }

  const int n_pass = (RT + KT - 1) / KT;
  constexpr float kLog2e = 1.4426950408889634f;
  for (int n = 0; item < n_items; item += gridDim.x, ++n) {
    // the next item's copies go out before this one is computed
    if (item + (int)gridDim.x < n_items) {
      issue(item + gridDim.x, (n + 1) & 1);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int b = item / groups, h0 = (item % groups) * HG;

    // each warp: 16 query rows of one head
    for (int wi = warp; wi < HG * RT; wi += n_warps) {
      const int hi = wi / RT, rt = wi % RT, row0 = rt * 16;
      const int q_off = (n & 1) * buf_bytes + hi * 3 * tile;
      const uint32_t q_s = base + q_off, k_s = q_s + tile, v_s = k_s + tile;
      const uint8_t* row_codes = codes + rt * RT;

      // pass 1: each row's max m and sum l of exp(s - m), in fp32; S keeps
      // exp(s - m) when one pass covers all keys
      float S[2 * KT][4];
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      for (int p = 0; p < n_pass; ++p) {
        scores<KT>(S, q_s, k_s, row0, p * KT, RT, T_len, scale, mask, row_codes, slots, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float cm = -INFINITY;
#pragma unroll
          for (int j = 0; j < 2 * KT; ++j) cm = fmaxf(cm, fmaxf(S[j][2 * h], S[j][2 * h + 1]));
          const float mn = fmaxf(m[h], quad_max(cm));
          const float mref = mn == -INFINITY ? 0.f : mn;  // a row masked so far
          float cs = 0.f;
#pragma unroll
          for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              S[j][e] = exp2_sfu(fmaf(S[j][e], kLog2e, -mref * kLog2e));
              cs += S[j][e];
            }
          l[h] = l[h] * exp2_sfu((m[h] - mref) * kLog2e) + quad_sum(cs);
          m[h] = mn;
        }
      }
      float mref[2], inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mref[h] = m[h] == -INFINITY ? 0.f : m[h];
        inv[h] = 1.f / l[h];
      }

      // pass 2: P = exp(s - m) / l rounded to bf16, O += P.V; the output
      // tile goes through this warp's own q rows to 16-byte stores
      if (n_pass == 1) {
        // q is read: the halves of O take turns, each staged when done
        uint32_t P[KT][4];
        pack_p<KT>(P, S, inv);
        __syncwarp();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float O[4][4] = {};
          pv_half<KT>(O, P, v_s, 0, RT, row_codes, half, lane);
          stage_half(smem, q_off, O, row0, half, lane);
        }
      } else {
        float O[2][4][4] = {};
        for (int p = 0; p < n_pass; ++p) {
          scores<KT>(S, q_s, k_s, row0, p * KT, RT, T_len, scale, mask, row_codes, slots, lane);
#pragma unroll
          for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              S[j][e] = exp2_sfu(fmaf(S[j][e], kLog2e, -mref[e >> 1] * kLog2e));
          uint32_t P[KT][4];
          pack_p<KT>(P, S, inv);
          pv_half<KT>(O[0], P, v_s, p * KT, RT, row_codes, 0, lane);
          pv_half<KT>(O[1], P, v_s, p * KT, RT, row_codes, 1, lane);
        }
        __syncwarp();
        stage_half(smem, q_off, O[0], row0, 0, lane);
        stage_half(smem, q_off, O[1], row0, 1, lane);
      }
      __syncwarp();
      bf16* oh = o + b * os.b + (h0 + hi) * os.h;
#pragma unroll
      for (int i = lane; i < 16 * kChunks; i += 32) {
        const int r = row0 + i / kChunks, c = i % kChunks;
        if (r < T_len)
          *reinterpret_cast<uint4*>(oh + r * os.t + c * 8) =
              *reinterpret_cast<const uint4*>(smem + q_off + swz(r, c));
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }
}

// How many blocks of one instantiation fit on the current card at once, for
// one block size and shared-memory size. Cached: the queries cost more host
// time than a small launch takes on the card.
template <int KT, int kThreads, int kMinBlocks>
cudaError_t resident_blocks(int threads, size_t smem, int* blocks) {
  struct Seen {
    int dev, threads;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static Seen seen[32];
  static int n_seen = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen && i < 32; ++i) {
    if (seen[i].dev == dev && seen[i].threads == threads && seen[i].smem == smem) {
      *blocks = seen[i].blocks;
      return cudaSuccess;
    }
  }
  // the attribute is per function: allow the most any launch needs
  e = cudaFuncSetAttribute(attention_fwd_bf16<KT, kThreads, kMinBlocks>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmemBytes);
  int sms, per_sm;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, attention_fwd_bf16<KT, kThreads, kMinBlocks>, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  seen[n_seen++ % 32] = Seen{dev, threads, smem, *blocks};
  return cudaSuccess;
}

template <int KT, int kThreads, int kMinBlocks>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* mask,
                        bf16* o, int B, int H, int T_len, float scale, Strides qs,
                        Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const int Tp = (T_len + 15) & ~15, RT = Tp / 16;
  int HG = 1;  // heads a block: the largest divisor of H that fills <= kThreads
  for (int d = 1; d <= H; ++d)
    if (H % d == 0 && d * RT * 32 <= kThreads) HG = d;
  const int warps = HG * RT;  // one warp per 16 query rows
  // shared memory: two item buffers, the tile codes, and as many mask slots
  // as leave room for kMinBlocks blocks on an SM
  const size_t budget = kSmemPerSm / kMinBlocks - kSmemReserved;
  const size_t fixed = 2 * (size_t)HG * 3 * Tp * kRowBytes + ((RT * RT + 15) & ~15) +
                       2 * (kMaxT / 16) * sizeof(uint32_t);
  int n_slots = 0;
  if (mask != nullptr && fixed < budget) n_slots = (int)((budget - fixed) / kSlotBytes);
  if (n_slots > RT * RT) n_slots = RT * RT;
  const size_t smem = fixed + (size_t)n_slots * kSlotBytes;
  int blocks;  // persistent: as many blocks as fit on the card at once
  if (warps * 32 > kThreads || smem > kMaxSmemBytes) return cudaErrorInvalidConfiguration;
  const cudaError_t e = resident_blocks<KT, kThreads, kMinBlocks>(warps * 32, smem, &blocks);
  if (e != cudaSuccess) return e;
  const long long n_items = (long long)B * (H / HG);
  const int grid = (int)(n_items < blocks ? n_items : blocks);  // each walks items
  attention_fwd_bf16<KT, kThreads, kMinBlocks><<<grid, warps * 32, smem, stream>>>(
      q, k, v, mask, o, B, H, HG, T_len, scale, n_slots, qs, ks, vs, os);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: SIMT
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;          // warps per block
constexpr int kRowsPerBlock = 32;     // query rows per block
constexpr int kKeysPerLane = kMaxT / 32;
constexpr int kKPad = kDh + 1;        // K row stride in words (bank spread)

__global__ void __launch_bounds__(kF32Warps * 32)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ mask,
                  float* __restrict__ o, int H, int T_len, float scale, Strides qs,
                  Strides ks, Strides vs, Strides os) {
  extern __shared__ __align__(16) float smf[];
  float* v_s = smf;                        // [T][kDh]
  float* k_s = v_s + T_len * kDh;          // [T][kKPad]
  float* q_s = k_s + T_len * kKPad;        // [kF32Warps][kDh]
  float* p_s = q_s + kF32Warps * kDh;      // [kF32Warps][T]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* qh = q + b * qs.b + h * qs.h;
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;
  float* oh = o + b * os.b + h * os.h;

  for (int i = threadIdx.x; i < T_len * (kDh / 4); i += blockDim.x) {
    const int r = i / (kDh / 4), c = i % (kDh / 4);
    const float4 kv = *reinterpret_cast<const float4*>(kh + r * ks.t + c * 4);
    const float4 vv = *reinterpret_cast<const float4*>(vh + r * vs.t + c * 4);
    float* kd = k_s + r * kKPad + c * 4;
    kd[0] = kv.x;
    kd[1] = kv.y;
    kd[2] = kv.z;
    kd[3] = kv.w;
    *reinterpret_cast<float4*>(v_s + r * kDh + c * 4) = vv;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = q_s + warp * kDh;
  float* pw = p_s + warp * T_len;
  const int r_end = min(T_len, (int)(blockIdx.y + 1) * kRowsPerBlock);
  for (int r = blockIdx.y * kRowsPerBlock + warp; r < r_end; r += kF32Warps) {
    // the q row, pre-scaled as pallas_attention does
    const float2 qv = *reinterpret_cast<const float2*>(qh + r * qs.t + 2 * lane);
    qw[2 * lane] = qv.x * scale;
    qw[2 * lane + 1] = qv.y * scale;
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
        const float* krow = k_s + j * kKPad;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < kDh; ++d) acc = fmaf(qf[d], krow[d], acc);
        s[i] = acc;
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
      if (j < T_len) pw[j] = s[i] / sum;
    }
    __syncwarp();

    // P.V: this lane owns output dims 2*lane and 2*lane+1
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < T_len; ++j) {
      const float p = pw[j];
      const float2 vv = *reinterpret_cast<const float2*>(v_s + j * kDh + 2 * lane);
      a0 = fmaf(p, vv.x, a0);
      a1 = fmaf(p, vv.y, a1);
    }
    *reinterpret_cast<float2*>(oh + r * os.t + 2 * lane) = make_float2(a0, a1);
    __syncwarp();  // qw and pw are rewritten for this warp's next row
  }
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* mask,
                       float* o, int B, int H, int T_len, float scale, Strides qs,
                       Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)T_len * kDh + (size_t)T_len * kKPad +
                                       (size_t)kF32Warps * kDh + (size_t)kF32Warps * T_len);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B * H, (T_len + kRowsPerBlock - 1) / kRowsPerBlock);
  attention_fwd_f32<<<grid, kF32Warps * 32, smem, stream>>>(q, k, v, mask, o, H, T_len,
                                                            scale, qs, ks, vs, os);
  return cudaGetLastError();
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
    return (int)launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), mask, static_cast<float*>(o), B, H,
                           T_len, scale, qs, ks, vs, os, st);
  if (dtype != 1) return -1;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  const int RT = (T_len + 15) / 16;
  // One pass while a warp's scores (8 x RT fp32 registers) fit its register
  // budget without spilling (-Xptxas -v), T <= 96; two passes over 48-key
  // tiles above. Block size and resident blocks per SM set that budget:
  // 65536 / (warps per SM rounded up to 4 per scheduler) registers.
#define HGR_BF16(kt, threads, blocks) \
  (int)launch_bf16<kt, threads, blocks>(qb, kb, vb, mask, ob, B, H, T_len, scale, qs, ks, vs, os, st)
  switch (RT) {
    case 1: return HGR_BF16(1, 256, 2);
    case 2: return HGR_BF16(2, 256, 2);
    case 3: return HGR_BF16(3, 256, 2);
    case 4: return HGR_BF16(4, 128, 3);
    case 5: return HGR_BF16(5, 160, 3);
    case 6: return HGR_BF16(6, 192, 2);
    default: return HGR_BF16(kTwoPassTiles, kMaxWarps * 32, 1);
  }
#undef HGR_BF16
  return -1;
}

const char* hgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
