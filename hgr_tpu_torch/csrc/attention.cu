// K1: fused softmax attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces hgr_tpu/ops/attention.py:_attn_kernel (the Pallas TPU kernel,
// launched by _pallas_attention_padded and wrapped by pallas_attention). It
// computes the same function: q pre-scaled by Dh^-0.5 in its own dtype,
// fp32 scores q.k^T plus an optional additive fp32 [T, T] mask, an fp32
// max-subtracted softmax, probabilities normalised in fp32 and rounded to
// v's dtype, then P.V with fp32 accumulators, rounded to the output dtype.
// Head dim 64 (fp32 also 16, bf16 also 72: there the fp32 scores are
// scaled by 72^-0.5, which is no power of two, so not bit for bit the
// pre-scaled q's), any T >= 1, bf16 or fp32, q/k/v/o through strides (the
// caller passes views of the packed [B, T, 3D] projection and gets a view of
// a [B, T, H, Dh] buffer back, so no head transpose is copied). The TPU
// kernel's padding of T to 8 and Dh to 128 was a layout artefact; here the
// ragged edge is masked in the kernel.
//
// K1's device kernels: attention_fwd_bf16 (bf16, T <= 96),
// attention_fwd_bf16_tiled (bf16, T >= 97), attention_fwd_f32_one (fp32, T
// <= 64) and attention_fwd_f32_multi (fp32, T > 64), with the mask pre-passes
// attention_mask_codes and attention_f32_mask_codes. All are launched by
// hgr_attention_fwd at the bottom.
//
// What bounds the short kernel on the H100: bytes. At the bank build's
// shape (512 prompts x 8 heads, T = 32, Dh = 64, bf16) q, k, v and o move 4
// x 16.8 MB = 67 MB a launch for 1.07 GFLOP of products: 16 FLOP per byte,
// far under the ~295 at which bf16 tensor cores become the limit, so the
// floor is about 20 us at 3.35 TB/s. The bank build launches it 12 layers x
// 36 chunks = 432 times.
//
// Short bf16 design (attention_fwd_bf16, T <= 96), each part for a reason:
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
// - One pass: a warp's scores fit its registers without spilling up to T =
//   96 (-Xptxas -v). Each instantiation's block size and resident blocks
//   (template arguments) set its register budget. ldmatrix addresses are a
//   per-lane base XOR a compile-time chunk plus a compile-time row offset,
//   so they hold no register per tile: that is what lets T = 77 (80 keys, 40
//   score registers) run with 3 blocks of 5 warps an SM.
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
// Long bf16 design (attention_fwd_bf16_tiled, T >= 97: ViT-B/16's 197,
// ViT-L/14's 257, ViT-L/14@336's 577). A head no longer fits a block, and
// the work per byte grows with T: at ViT-L/14's (512, 16, 257) the bytes
// take 0.32 ms at 3.35 TB/s, the three products (q.k^T twice, P.V) 0.21 ms
// on the tensor cores, and the two exponentials a score about 0.27 ms on
// the SFUs (16 ex2 a clock an SM). So the kernel is bound by bytes and the
// SFU, and its design keeps the tensor cores, the SFUs and the copies
// working at once:
// - Tiles. A block is one warpgroup (4 warps, 16 query rows each) on a
//   64-row query tile of one (prompt, head). The grid is (B*H x query
//   tiles) with the tile fastest, so the tiles of one head run together and
//   their re-reads of K and V hit the L2. Four blocks an SM without a mask
//   (50 KB of shared memory and at most 128 registers a thread each; three
//   with one, whose code needs more registers), so that while one
//   warpgroup exponentiates the others' products and copies run: the
//   warpgroups of an SM, not a pipeline within one, hide each other's
//   latencies. No producer warp: a fifth warp would leave room for fewer
//   blocks an SM (an SM grants registers to groups of four warps), and
//   setmaxnreg, which could shrink its share, works on whole warpgroups.
// - Products on wgmma, A from registers: S = q.K^T as m64n64k16 with q's A
//   fragments loaded once by ldmatrix (reading q from shared memory for
//   every product doubled the shared-memory traffic of q.k^T), and O +=
//   P.V with P in registers (the S accumulator rounded to bf16 is wgmma's
//   A-fragment layout) and V read through the transpose bit (V is
//   key-major). K and V sit in the 128-byte swizzle (16-byte chunk c of row
//   r at c ^ (r & 7)) on a 1,024-byte boundary, which TMA writes and the
//   descriptors read. Each product's four k16 steps are issued together
//   and waited once.
// - Copies. A ring of 5 slots of 8 KB (a 64-key block of K or of V) filled
//   by TMA through tensor maps over the caller's strided views (dims Dh, H,
//   T, B; boxes of 64 x 64), one mbarrier a slot. Rows past T come back as
//   zeros. Thread 0 loads Q once and refills slots as soon as every warp is
//   done with them (a block barrier); the first pass loads K only, so its
//   copies run five blocks ahead.
// - Exact two passes, as _attn_kernel's normalisation demands (no
//   flash-style rescaling of P.V, which would round unnormalised
//   probabilities to bf16): pass 1 finds each row's max and sum of
//   exp(s - m) over every key block; pass 2 recomputes q.k^T and
//   accumulates P.V with P = exp(s - m) / l rounded to bf16. ex2.approx
//   with the log2(e) and softmax-scale fold.
// - wgmma stays asynchronous only if no branch that differs between the
//   warps of the warpgroup touches a product's registers, and the products
//   in flight fit the registers; ptxas serializes every wgmma of the kernel
//   otherwise. So a warp whose rows all lie past T computes like the others
//   and only skips its stores, and P.V is waited before the next block.
// - The ragged tail: the last key block's products run at N = 64 on zeros
//   past T, but only its groups of 8 keys that reach below T are
//   exponentiated (T = 257: 8 of 64 keys), and its P.V takes as many k16
//   steps as they need.
// - The mask. A pre-pass kernel sorts the mask's 64 x 64 blocks once a
//   launch into dead (skipped by the copies and the products alike: exactly
//   zero probability, about half the blocks of a causal mask), zero
//   (nothing to add) and mixed (added from device memory through the L2).
//   Without a mask nothing is read, there is no pre-pass, and the kernel is
//   compiled without the mask's code (its instantiation kMask = false).
// - The output goes through the (finished) Q tile to 16-byte stores.
// - Head dim 72 (SigLIP So400m's 16 heads of 1,152), at every T: 72 is no
//   multiple of 16, the k16 steps of q.k^T need dims 64..79 with 72..79
//   zero, and a 144-byte row is wider than the 128-byte swizzle. So each
//   K or V tile comes in two TMA boxes on one mbarrier: dims 0..63 as
//   above, and a [64][16] tail in the 32-byte swizzle whose dims 72..79
//   TMA fills with zeros itself (they lie past the tensor map's 72), so no
//   copy pads q, k or v. q.k^T takes a fifth k16 step on the tail, q's A
//   fragment for it read from q directly (two words a lane, its dims 72..79
//   zero); P.V adds an m64n16k16 product a k16 step into eight more
//   accumulators, of which dims 64..71 are stored straight from registers.
//   No configuration masks a head of 72, so it takes no mask. A slot is
//   10 KB. Past T = 64 without a mask a block is two warpgroups
//   on a 128-row query tile, sharing each K and V tile (68 KB, two blocks
//   an SM): at T = 729 every query tile reads every key block in both
//   passes, and halving those reads from the L2 took SigLIP's launch from
//   9.46 to 5.8-6.2 ms on an H100, where a fourth 64-row block an SM
//   gained nothing.

// fp32 design (attention_fwd_f32_one for T <= 64, attention_fwd_f32_multi
// past it; head dim 64 or 16, unpadded). fp32 is the parity mode, so its
// products must keep fp32's accuracy (an earlier SIMT kernel kept them off
// the tensor cores for that). They run on the tensor cores as 3xTF32
// (CUTLASS's "fast fp32"): each operand is split as x = hi + lo, hi =
// tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties away
// (cvt.rna's rounding, done in integer instructions, which issued faster on
// the H100), which holds x to about 2^-22 of |x|; each product is lo.hi +
// hi.lo + hi.hi, the small cross terms first, into one fp32 accumulator
// (mma.sync m16n8k8 tf32). Products of TF32 values are exact, and the
// dropped lo.lo term is about 2^-22 of the product: fp32's accuracy, where
// one TF32 product keeps about 2^-11 (tests/test_torch_attention.py
// emulates both). What bounds it on the H100: at 495 / 3 = 165 TFLOP/s of
// fp32-accurate products and 3.35 TB/s, attention does T / 4 FLOP a byte
// (4 T^2 Dh FLOP over q, k, v and o's 16 T Dh bytes) against the card's 49,
// and mma.sync reaches only part of the tensor cores' peak: bytes bound it
// up to T of about 100 (the bank build's T = 32: 134 MB, 0.040 ms), the
// products past it (ViT-L/14's 257). Three products a product, each split
// on the way in, make a warp's work per key six times that of a bf16 kernel
// (k8 steps, three terms): the design keeps that work fed. So:
// - T <= 64: one block per (prompt, head), a warp per 16 query rows, so
//   that K and V are read from device memory once; at T = 32, 4,096 blocks
//   of two warps and 16 KB of shared memory, many an SM, whose copies and
//   products overlap each other's. T > 64: 8 warps a block: the whole head
//   up to T = 128, else a 64-row query tile with the keys in two halves,
//   each with its own online softmax, merged at the end, so that short
//   grids (64 heads at T = 256) still give each scheduler warps to switch
//   between; 32-key tiles keep a thread at 128 registers without spills
//   (two blocks an SM).
// - q, K and V through cp.async 16-byte copies into shared memory (q once;
//   past T = 64, K and V through a ring of two stages, a 32-key tile of each
//   for each half a stage, the next step's copies issued before the current
//   one is computed); rows past T zero-filled by the copy. A 16-byte chunk
//   XOR swizzle (f32_off) keeps the fragment loads free of bank conflicts.
// - Scores stay in registers: the m16n8 accumulator of q.k^T is P's A
//   fragment for P.V as it lies, because the 8 keys of each k-step are
//   permuted (logical k = t is key 2t, k = t + 4 is 2t + 1) and V's B
//   fragments read the same keys; likewise q's and K's dims, so that each
//   lane reads 16 contiguous bytes. V's fragments read NT = Dh / 8
//   contiguous dims of a key row (output dim NT c + n of n-tile n).
// - One pass with an online softmax: a running max and sum of each row,
//   the accumulators rescaled when the max grows. Nothing is rounded to a
//   narrower type, so this is _attn_kernel's normalise-then-multiply up to
//   fp32 rounding. exp by the SFU's ex2 with the log2 e fold (its relative
//   error about 2^-22, inside phase 3's 1e-5).
// - The mask: any additive fp32 [T, T] mask, read through the L2 only where
//   it is not 0. Past T = 64 a pre-pass (attention_f32_mask_codes) sorts its
//   16-row x 8-key groups once a launch: a group that is all -inf for a
//   warp's rows costs no product (its probabilities are exactly 0), a step
//   dead for every warp of a block is not copied, and a group that is all 0
//   adds nothing. A last tile computes only its groups of 8 keys below T.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kDh = 64;  // head dim

struct Strides {
  long long b, h, t;  // in elements; the head-dim stride is 1
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kShortRowTiles = 16;     // most row tiles of the short kernel's bitmasks
constexpr int kShortMaxT = 96;         // the short kernel's longest T; the tiled one's above
constexpr int kRowBytes = kDh * 2;     // one bf16 row: 128 bytes
constexpr int kChunks = kRowBytes / 16;
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
  uint32_t* nonzero = live + kShortRowTiles;                          // [RT]
  float* slots = reinterpret_cast<float*>(nonzero + kShortRowTiles);  // [n_slots][16][kSlotStride]

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

      // each row's max m and sum l of exp(s - m), in fp32; S keeps exp(s - m)
      float S[2 * KT][4];
      float m[2], l[2], inv[2];
      scores<KT>(S, q_s, k_s, row0, 0, RT, T_len, scale, mask, row_codes, slots, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j) cm = fmaxf(cm, fmaxf(S[j][2 * h], S[j][2 * h + 1]));
        m[h] = quad_max(cm);
        const float mref = m[h] == -INFINITY ? 0.f : m[h];  // a row masked throughout
        float cs = 0.f;
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            S[j][e] = exp2_sfu(fmaf(S[j][e], kLog2e, -mref * kLog2e));
            cs += S[j][e];
          }
        l[h] = quad_sum(cs);
        inv[h] = 1.f / l[h];
      }

      // P = exp(s - m) / l rounded to bf16, O += P.V; q is read, so the
      // halves of O take turns, each staged in this warp's own q rows when
      // done, then 16-byte stores
      uint32_t P[KT][4];
      pack_p<KT>(P, S, inv);
      __syncwarp();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float O[4][4] = {};
        pv_half<KT>(O, P, v_s, 0, RT, row_codes, half, lane);
        stage_half(smem, q_off, O, row0, half, lane);
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
                       2 * kShortRowTiles * sizeof(uint32_t);
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
// bf16, T >= 97: 64-row query tiles on wgmma, K and V through a TMA ring
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                          // query rows a block; keys a K/V block
constexpr int kTileBytes = kTile * kRowBytes;      // one [64][64] bf16 tile: 8 KB
constexpr int kSlots = 5;                          // ring slots, each a K or a V tile
constexpr int kTiledThreads = 128;                 // one warpgroup
constexpr int kWideDh = 72;                        // the head dim with a tail (SigLIP So400m)
constexpr int kTailDims = 16;                      // dims 64..79 of a wide head, 72.. zero
constexpr int kTailBytes = kTile * kTailDims * 2;  // a [64][16] tail tile: 2 KB
// one ring slot: a [64][64] tile, and at head dim 72 its [64][16] tail
template <int kHd>
constexpr int kRingSlotBytes = kHd == kDh ? kTileBytes : kTileBytes + kTailBytes;
// the aligned Q tile, the ring, an mbarrier a slot and Q's, and room to
// align the dynamic base to 1,024 bytes (the 128-byte swizzle's period):
// 50 KB at head dim 64 (four blocks an SM), 60 KB at 72 (three)
template <int kHd, int kWg = 1>
constexpr int kTiledSmemBytes =
    1024 + kWg * kTileBytes + kSlots * kRingSlotBytes<kHd> + (kSlots + 1) * 8;
constexpr int kTensorMapRefused = -2;              // hgr_attention_fwd's code for it

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// thread 0's arrival, with the bytes its copies will complete
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box (rows t.., the map's box of dims from d, head h, prompt b) of a
// tensor map over (Dh, H, T, B) into swizzled shared memory; rows past T
// and dims past Dh are zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int t, int b, int d = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// wgmma's descriptor of a bf16 tile in the 128-byte swizzle: start address,
// 8-row groups 1,024 bytes apart (the leading offset is unused). It reads K
// (K-major) and, with the transpose bit, key-major V; one k16 step is +32
// bytes (+2) along K's rows, +2,048 (+128) down V's keys.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// The same for a tail tile of 32-byte rows in the 32-byte swizzle (16-byte
// chunk c of row r at c ^ ((r >> 2) & 1)): 8-row groups 256 bytes apart. It
// reads K's dims 64..79 (K-major: one k16 step) and, with the transpose bit,
// V's (N = 16); one k16 step is +512 bytes (+32) down V's keys.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (16ull << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// keeps the compiler from moving accumulator registers across a wgmma
template <int N>
__device__ __forceinline__ void keep(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// m64nNk16 products, bf16 in, fp32 accumulators d[N / 8][4]: a warp holds
// rows 16 w + lane / 4 (elements 0, 1) and + 8 (elements 2, 3), columns
// 8 i + 2 (lane % 4) and + 1, as mma.sync's m16n8 C fragment. d (+)= a . b
// with a (64 rows x 16 bf16) from registers in mma.sync's A-fragment layout
// (each warp its 16 rows) and b (16 x N) from shared memory: K-major (q.k^T:
// b's rows are keys) when kTransB is 0, N-major (P.V: V's rows are keys)
// when it is 1. acc = 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(kTransB));
}

// m64n16k16, as wgmma_rs: the products into a wide head's output dims 64..79
template <int kTransB>
__device__ __forceinline__ void wgmma_rs16(float (&d)[2][4], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(kTransB));
}

// What each 64 x 64 block of the mask holds for the real rows of query tile
// blockIdx.y against the real keys of key block blockIdx.x: all -inf
// (kDead), all 0 (kZero) or anything else (kGlobal); one byte a block in
// codes[query tile][key block]
__global__ void __launch_bounds__(256)
attention_mask_codes(const float* __restrict__ mask, int T_len, uint8_t* __restrict__ codes) {
  const int c = blockIdx.x * kTile + (threadIdx.x & (kTile - 1));
  const int r_end = min(T_len, (int)(blockIdx.y + 1) * kTile);
  bool live = false, zero = true;
  if (c < T_len)
    for (int r = blockIdx.y * kTile + threadIdx.x / kTile; r < r_end; r += blockDim.x / kTile) {
      const float m = __ldg(mask + (long long)r * T_len + c);
      live |= m != -INFINITY;
      zero &= m == 0.f;
    }
  live = __syncthreads_or(live);
  zero = __syncthreads_and(zero);
  if (threadIdx.x == 0)
    codes[blockIdx.y * gridDim.x + blockIdx.x] = !live ? kDead : zero ? kZero : kGlobal;
}

// What the warpgroup's steps share. Ring position pos (the count of tiles
// loaded so far) is slot pos % kSlots, in its (pos / kSlots)th use. A block
// takes one position in the first pass (K) and two in the second (K, V).
// This lane's query rows are row and row + 8. At head dim 72 a slot holds a
// tile's dims 0..63 and, kTileBytes on, its tail: dims 64..79, which TMA
// fills with zeros past 72 (kt_map, vt_map: boxes of 16 dims).
template <int kHd>
struct Tiled {
  uint32_t ring, full;
  const CUtensorMap *k_map, *v_map, *kt_map, *vt_map;
  const float* mask;
  const uint8_t* codes;  // this query tile's codes a key block, or null
  float scale;
  int T_len, n_kb, hd, b, row, lane;
  int load_pos, load_pass, load_kb;  // the next load: ring position, pass, key block
  bool load_v;                       // ... and whether it is V's tile

  __device__ __forceinline__ uint32_t slot(int pos) const {
    return ring + (pos % kSlots) * kRingSlotBytes<kHd>;
  }
  __device__ __forceinline__ uint8_t code(int kb) const {
    return codes != nullptr ? codes[kb] : kZero;
  }
  __device__ __forceinline__ void wait_full(int pos) const {
    mbar_wait(full + 8 * (pos % kSlots), (pos / kSlots) & 1);
  }
  // the next key block after kb that the mask leaves live (n_kb: none);
  // without a mask (kMask false) every block is
  template <bool kMask = true>
  __device__ __forceinline__ int next_live(int kb) const {
    if constexpr (!kMask) return kb + 1;
    do ++kb;
    while (kb < n_kb && code(kb) == kDead);
    return kb;
  }
  // thread 0 loads the next tile (a live block's K in the first pass, its
  // K then V in the second) at ring position load_pos; every thread keeps
  // the count
  __device__ __forceinline__ void load_next() {
    if (load_pass > 1) return;
    if (threadIdx.x == 0) {
      const uint32_t bar = full + 8 * (load_pos % kSlots);
      mbar_expect_tx(bar, kRingSlotBytes<kHd>);
      tma_load(slot(load_pos), load_v ? v_map : k_map, bar, hd, load_kb * kTile, b);
      if constexpr (kHd != kDh)
        tma_load(slot(load_pos) + kTileBytes, load_v ? vt_map : kt_map, bar, hd,
                 load_kb * kTile, b, kDh);
    }
    ++load_pos;
    load_v = load_pass == 1 && !load_v;
    if (load_v) return;
    load_kb = next_live(load_kb);
    if (load_kb == n_kb) {
      ++load_pass;
      load_kb = next_live(-1);
    }
  }
  // every warp is done with the n oldest tiles in use: load into their slots
  __device__ __forceinline__ void refill(int n) {
    __syncthreads();
    for (int i = 0; i < n; ++i) load_next();
  }
};

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// S = q.K^T for the 64 keys of the K tile at k_s, q's A fragments qf (and
// at head dim 72 qt, dims 64..79) from registers; issued, not waited
template <int kHd>
__device__ __forceinline__ void issue_s(float (&S)[8][4], const uint32_t (&qf)[4][4],
                                        const uint32_t (&qt)[4], uint32_t k_s) {
  wgmma_fence();
  const uint64_t b_desc = sw128_desc(k_s);
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) wgmma_rs<0>(S, qf[kk], b_desc + 2 * kk, kk);
  if constexpr (kHd != kDh) wgmma_rs<0>(S, qt, sw32_desc(k_s + kTileBytes), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// the scores of mixed key block kb (the first key kb * 64): scaled (a power
// of two: exact), plus the mask read through the L2, -inf past T
template <int kHd>
__device__ __forceinline__ void prep(float (&S)[8][4], const Tiled<kHd>& t, int kb) {
  const int c2 = 2 * (t.lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = t.row + 8 * (e >> 1), c = kb * kTile + 8 * j + c2 + (e & 1);
      float x = S[j][e] * t.scale;
      if (r < t.T_len && c < t.T_len) x += __ldg(t.mask + (long long)r * t.T_len + c);
      S[j][e] = c < t.T_len ? x : -INFINITY;
    }
}

// The scores s of a block are mul * S: S scaled and masked by prep (mul =
// 1), or plain q.k^T (mul = the softmax scale, a power of two for Dh = 64:
// then fmaf(S, mul * log2 e, .) rounds as fmaf(s, log2 e, .) does).
//
// the first pass: the block folded into each row's max m and sum l of exp(s - m)
template <int NG>
__device__ __forceinline__ void fold(const float (&S)[NG][4], float mul, float (&m)[2],
                                     float (&l)[2]) {
  constexpr float kLog2e = 1.4426950408889634f;
  const float k = mul * kLog2e;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cm = -INFINITY;
#pragma unroll
    for (int j = 0; j < NG; ++j) cm = fmaxf(cm, fmaxf(S[j][2 * h], S[j][2 * h + 1]));
    const float mn = fmaxf(m[h], quad_max(cm) * mul);
    const float mr = mn == -INFINITY ? 0.f : mn;  // a row masked so far
    float cs = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) cs += exp2_sfu(fmaf(S[j][e], k, -mr * kLog2e));
    l[h] = l[h] * exp2_sfu((m[h] - mr) * kLog2e) + quad_sum(cs);
    m[h] = mn;
  }
}

// the second pass: O += P.V for the V at ring position pos, P = exp(s - mref) * inv
// rounded to bf16 in A fragments of 16 keys (groups 2j and 2j + 1; a group
// past the block's 8 NG keys is zero), and at head dim 72 Ot += P.V's dims
// 64..79 from the slot's tail; issued, not waited
template <int kHd, int NG>
__device__ __forceinline__ void issue_pv(float (&O)[8][4], float (&Ot)[2][4],
                                         const float (&S)[NG][4], float mul,
                                         const float (&mref)[2], const float (&inv)[2],
                                         const Tiled<kHd>& t, int pos) {
  constexpr float kLog2e = 1.4426950408889634f;
  const float k = mul * kLog2e;
  constexpr int KS = (NG + 1) / 2;
  uint32_t P[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int g = 2 * j + half;
        uint32_t p = 0u;
        if (g < NG)
          p = pack_bf16(exp2_sfu(fmaf(S[g][2 * h], k, -mref[h] * kLog2e)) * inv[h],
                        exp2_sfu(fmaf(S[g][2 * h + 1], k, -mref[h] * kLog2e)) * inv[h]);
        P[j][2 * half + h] = p;
      }
  const uint32_t v_s = t.slot(pos + 1);
  t.wait_full(pos + 1);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < KS; ++j) wgmma_rs<1>(O, P[j], sw128_desc(v_s + j * 16 * kRowBytes), 1);
  if constexpr (kHd != kDh) {
#pragma unroll
    for (int j = 0; j < KS; ++j)
      wgmma_rs16<1>(Ot, P[j], sw32_desc(v_s + kTileBytes + j * 16 * kTailDims * 2), 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// One live key block kb at ring position pos of pass `pass`: q.k^T issued and
// waited, K's slot (and the previous block's V slot, v_free) refilled, then
// the scores folded (pass 0) or P.V issued and waited (pass 1; V is the
// tile at pos + 1). NG groups of 8 keys hold the block's keys below T (the
// last block's may be fewer): exponentials for those only. kMask: the
// block is mixed (scaled and masked by prep; NG is 8) rather than plain.
// Every warp runs the same code, its rows past T or not: ptxas serializes
// every wgmma of the kernel when a branch that differs between the warps of
// the warpgroup touches a product's registers, or when the products in
// flight would need more registers than the launch bound leaves.
template <int pass, int NG, bool kMask, int kHd>
__device__ __forceinline__ void tiled_block(const uint32_t (&qf)[4][4], const uint32_t (&qt)[4],
                                            int kb, int pos, bool v_free, Tiled<kHd>& t,
                                            float (&m)[2], float (&l)[2], const float (&mref)[2],
                                            const float (&inv)[2], float (&O)[8][4],
                                            float (&Ot)[2][4]) {
  float S[8][4];
  t.wait_full(pos);
  issue_s<kHd>(S, qf, qt, t.slot(pos));
  wgmma_wait0();
  keep(S);
  if constexpr (pass == 1) {
    keep(O);
    if constexpr (kHd != kDh) keep(Ot);
  }
  t.refill(v_free ? 2 : 1);
  float(&live)[NG][4] = reinterpret_cast<float(&)[NG][4]>(S);
  float mul = t.scale;  // the scores are mul * S
  if constexpr (kMask) {
    prep(S, t, kb);
    mul = 1.f;
  } else if ((kb + 1) * kTile > t.T_len) {  // -inf past T
    const int c0 = kb * kTile + 2 * (t.lane & 3);
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + 8 * j + (e & 1) >= t.T_len) live[j][e] = -INFINITY;
  }
  if constexpr (pass == 0) {
    fold(live, mul, m, l);
  } else {
    issue_pv<kHd>(O, Ot, live, mul, mref, inv, t, pos);
    wgmma_wait0();
    keep(O);
    if constexpr (kHd != kDh) keep(Ot);
  }
}

// One pass over the tile's live key blocks in order, from ring position pos
// on. pass 0 folds each row's max and sum into m and l, pass 1 adds P.V into
// O. tail_ng: groups of 8 keys of the last block below T.
template <int pass, bool kMask, int kHd>
__device__ __forceinline__ void tiled_pass(const uint32_t (&qf)[4][4], const uint32_t (&qt)[4],
                                           int& pos, int tail_ng, Tiled<kHd>& t, float (&m)[2],
                                           float (&l)[2], const float (&mref)[2],
                                           const float (&inv)[2], float (&O)[8][4],
                                           float (&Ot)[2][4]) {
  bool v_free = false;  // the previous block's V slot waits to be refilled
  for (int kb = t.template next_live<kMask>(-1); kb < t.n_kb;
       kb = t.template next_live<kMask>(kb), pos += 1 + pass) {
    const int ng = kb == t.n_kb - 1 ? tail_ng : 8;
#define HGR_TILED_BLOCK(NG, MASK) \
  tiled_block<pass, NG, MASK, kHd>(qf, qt, kb, pos, v_free, t, m, l, mref, inv, O, Ot)
    if (kMask && t.code(kb) == kGlobal) {
      HGR_TILED_BLOCK(8, kMask);
    } else if (ng == 8) {
      HGR_TILED_BLOCK(8, false);
    } else if (ng == 4) {
      HGR_TILED_BLOCK(4, false);
    } else if (ng == 2) {
      HGR_TILED_BLOCK(2, false);
    } else {
      HGR_TILED_BLOCK(1, false);
    }
#undef HGR_TILED_BLOCK
    v_free = pass == 1;
  }
  if (v_free) t.refill(1);
}

// One block, kWg warpgroups: query tile qt (64 kWg rows, 64 a warpgroup) of
// one (prompt, head); blockIdx.x = (prompt * H + head) * n_qt + qt. The
// warpgroups share each K and V tile of the ring (kWg 2: head dim 72
// without a mask past T = 64). codes (the pre-pass's, with a mask; kWg 1)
// says which key blocks are dead; kMask: there is a mask (its code is
// compiled only then). kHd: the head dim, 64 or 72; at 72 q's dims 64..71
// come from q itself (their A fragment is two words a lane, dims 72..79
// zero), K's and V's through the tail maps, and the output's dims 64..71 go
// from their accumulators straight to o.
template <bool kMask, int kHd, int kWg>
__global__ void __launch_bounds__(kTiledThreads * kWg,
                                  kWg == 2 ? 2 : kMask || kHd != kDh ? 3 : 4)
attention_fwd_bf16_tiled(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap kt_map,
                         const __grid_constant__ CUtensorMap vt_map,
                         const bf16* __restrict__ q, Strides qs,
                         const float* __restrict__ mask, const uint8_t* __restrict__ codes,
                         bf16* __restrict__ o, int H, int T_len, float scale, Strides os) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const int wg = kWg == 1 ? 0 : threadIdx.x >> 7;  // this thread's warpgroup: its 64 rows
  const uint32_t q_base = (raw + 1023) & ~1023u;  // the Q tiles, then the ring
  const uint32_t q_s = q_base + wg * kTileBytes;
  uint8_t* smem = smem_raw + (q_s - raw);
  const uint32_t ring = q_base + kWg * kTileBytes;
  const uint32_t full = ring + kSlots * kRingSlotBytes<kHd>, q_bar = full + 8 * kSlots;
  const int n_kb = (T_len + kTile - 1) / kTile, n_qt = (T_len + kWg * kTile - 1) / (kWg * kTile);
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt, b = bh / H, hd = bh % H;
  const int warp = kWg == 1 ? threadIdx.x >> 5 : (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row0 = (qt * kWg + wg) * kTile;  // this warpgroup's first query row

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(full + 8 * s, 1);  // thread 0's expect_tx
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Tiled<kHd> t{ring, full, &k_map, &v_map, &kt_map, &vt_map, mask,
               codes != nullptr ? codes + qt * n_kb : nullptr, scale, T_len, n_kb, hd, b,
               row0 + warp * 16 + (lane >> 2), lane, 0, 0, 0, false};
  t.load_kb = t.next_live(-1);
  t.load_pass = t.load_kb < n_kb ? 0 : 2;  // 2: nothing to load
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, kWg * kTileBytes);
#pragma unroll
    for (int w = 0; w < kWg; ++w)
      tma_load(q_base + w * kTileBytes, &q_map, q_bar, hd, (qt * kWg + w) * kTile, b);
  }
  for (int s = 0; s < kSlots; ++s) t.load_next();

  const int tail = T_len - (n_kb - 1) * kTile;  // keys of the last block, 1..64
  const int tail_ng = tail <= 8 ? 1 : tail <= 16 ? 2 : tail <= 32 ? 4 : 8;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, mref[2] = {0.f, 0.f},
        inv[2] = {0.f, 0.f};
  float O[8][4];   // the output's fp32 accumulators, from the second pass on
  float Ot[2][4];  // at head dim 72: its dims 64..79
  uint32_t qtf[4] = {0u, 0u, 0u, 0u};  // at head dim 72: q's dims 64..79 (72.. zero)
  if constexpr (kHd != kDh) {
    const bf16* qh = q + b * qs.b + hd * qs.h + kDh + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = t.row + 8 * h;
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(qh + min(r, T_len - 1) * qs.t));
      qtf[h] = r < T_len ? w : 0u;
    }
  }
  mbar_wait(q_bar, 0);
  uint32_t qf[4][4];  // this warp's 16 q rows as A fragments, dims 16 kk..+15
  {
    const uint32_t qa = (q_s + row_base(warp * 16 + (lane & 15))) ^ ((lane >> 4) << 4);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) ldsm_x4(qa ^ (kk << 5), qf[kk]);
  }
  int pos = 0;
  tiled_pass<0, kMask>(qf, qtf, pos, tail_ng, t, m, l, mref, inv, O, Ot);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mref[h] = m[h] == -INFINITY ? 0.f : m[h];
    inv[h] = 1.f / l[h];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) Ot[n][e] = 0.f;
  tiled_pass<1, kMask>(qf, qtf, pos, tail_ng, t, m, l, mref, inv, O, Ot);

  // the output through the Q tile, once every warp is done with it
  __syncthreads();
  if (row0 + warp * 16 >= T_len) return;  // this warp's rows all lie past T
  const int r0 = warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(smem + swz(r0 + 8 * h, n) + 2 * c2) =
          pack_bf16(O[n][2 * h], O[n][2 * h + 1]);
  __syncwarp();
  bf16* oh = o + b * os.b + hd * os.h;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = warp * 16 + i / kChunks, c = i % kChunks, gr = row0 + r;
    if (gr < T_len)
      *reinterpret_cast<uint4*>(oh + gr * os.t + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz(r, c));
  }
  if constexpr (kHd != kDh) {  // dims 64..71: a quad's four words are a row's 16 bytes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + r0 + 8 * h;
      if (gr < T_len)
        *reinterpret_cast<uint32_t*>(oh + gr * os.t + kDh + c2) =
            pack_bf16(Ot[0][2 * h], Ot[0][2 * h + 1]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (so that the library links no -lcuda)
cudaError_t encode_tiled(EncodeTiled* fn) {
  static std::once_flag once;
  static EncodeTiled found = nullptr;
  static cudaError_t err = cudaSuccess;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
    if (err == cudaSuccess && (status != cudaDriverEntryPointSuccess || p == nullptr))
      err = cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(p);
  });
  *fn = found;
  return err;
}

// the tensor map of q, k or v: dims (Dh, H, T, B) with the caller's strides,
// boxes of 64 rows x 64 dims in the 128-byte swizzle (tail: of 16 dims in the
// 32-byte swizzle), zeros out of bounds
bool tile_map(EncodeTiled encode, CUtensorMap* map, const bf16* p, int Dh, int B, int H,
              int T_len, Strides s, bool tail = false) {
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)H, (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.t * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(tail ? kTailDims : kDh), 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(p), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                tail ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// codes: (T / 64 rounded up)^2 bytes of device memory, given with a mask;
// Dh 64, or 72 without a mask
int launch_bf16_tiled(const bf16* q, const bf16* k, const bf16* v, const float* mask,
                      uint8_t* codes, bf16* o, int B, int H, int T_len, int Dh, float scale,
                      Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const int n_kb = (T_len + kTile - 1) / kTile;
  // two warpgroups a block share each K and V tile at head dim 72 without a
  // mask past T = 64: 128-row query tiles
  const int wgs = Dh == kWideDh && mask == nullptr && T_len > kTile ? 2 : 1;
  const int n_qt = (T_len + wgs * kTile - 1) / (wgs * kTile);
  const long long n_blocks = (long long)B * H * n_qt;
  if (n_blocks > 0x7fffffffLL || (mask != nullptr && codes == nullptr) ||
      (Dh != kDh && (Dh != kWideDh || mask != nullptr)))
    return -1;
  EncodeTiled encode;
  cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap maps[5];
  if (!tile_map(encode, &maps[0], q, Dh, B, H, T_len, qs) ||
      !tile_map(encode, &maps[1], k, Dh, B, H, T_len, ks) ||
      !tile_map(encode, &maps[2], v, Dh, B, H, T_len, vs))
    return kTensorMapRefused;
  if (Dh == kDh) {  // no tail: the maps are passed and never read
    maps[3] = maps[1];
    maps[4] = maps[2];
  } else if (!tile_map(encode, &maps[3], k, Dh, B, H, T_len, ks, true) ||
             !tile_map(encode, &maps[4], v, Dh, B, H, T_len, vs, true)) {
    return kTensorMapRefused;
  }
  auto kernel = Dh == kDh ? (mask != nullptr ? attention_fwd_bf16_tiled<true, kDh, 1>
                                             : attention_fwd_bf16_tiled<false, kDh, 1>)
                : wgs == 2 ? attention_fwd_bf16_tiled<false, kWideDh, 2>
                           : attention_fwd_bf16_tiled<false, kWideDh, 1>;
  const int smem = Dh == kDh ? kTiledSmemBytes<kDh>
                   : wgs == 2 ? kTiledSmemBytes<kWideDh, 2> : kTiledSmemBytes<kWideDh>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (mask != nullptr) {
    attention_mask_codes<<<dim3(n_kb, n_kb), 256, 0, stream>>>(mask, T_len, codes);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(int)n_blocks, kTiledThreads * wgs, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], q, qs, mask,
      mask != nullptr ? codes : nullptr, o, H, T_len, scale, os);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: tensor cores at fp32 accuracy (3xTF32)
// ---------------------------------------------------------------------------

constexpr int kF32OneKeys = 64;     // T <= 64: one tile holds every key
constexpr int kF32Keys = 32;        // keys a K/V tile of the streamed kernel (T > 64)
constexpr int kF32Warps = 8;        // its warps at most: a warp a row tile to T = 128, else
                                    // 4 row tiles x 2 key halves
constexpr int kF32CodeKeys = 64;    // keys a mask code covers: 8 groups of 8

// x as two TF32 values: hi = x rounded to TF32 (nearest, ties away from
// zero), lo = the rest, rounded again; hi + lo holds x to about 2^-22 of
// |x|. The same bits as cvt.rna.tf32.f32 (add half of the 13 dropped bits'
// unit to the magnitude, cut them), in integer instructions, which issue
// faster than the conversion.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(__fsub_rn(x, __uint_as_float(hi))) + 0x1000u) & 0xffffe000u;
}

// d += a . b for one 16x8 fp32 tile; a 16x8 (row) and b 8x8 (col) in TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b at fp32 accuracy, a given split (ah + al), b = (b0, b1) split
// here: the two small cross terms first, then hi . hi, one fp32 accumulator
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split_tf32(b0, b0h, b0l);
  split_tf32(b1, b1h, b1l);
  mma_tf32(d, al, b0h, b1h);
  mma_tf32(d, ah, b0l, b1l);
  mma_tf32(d, ah, b0h, b1h);
}

// the A fragment of four fp32 values, split
__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3, uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
  split_tf32(a0, ah[0], al[0]);
  split_tf32(a1, ah[1], al[1]);
  split_tf32(a2, ah[2], al[2]);
  split_tf32(a3, ah[3], al[3]);
}

// Float offset of 16-byte chunk c of row r in a K or V tile ([rows][Dh]
// fp32). At Dh 64 (16 chunks a row) the chunk's low three bits are XORed
// with f(r) = {0, 4, 1, 5, 4, 0, 5, 1}[r % 8]: the fragment loads of
// f32_tile then touch 8 distinct bank groups a quarter warp (K: rows g and
// g + 1, chunks t; V: rows 2t or 2t + 1, chunks 2g and 2g + 1). At Dh 16 a
// row is 4 chunks, and K's loads are free of conflicts as they lie.
template <int HD>
__device__ __forceinline__ int f32_off(int r, int c) {
  if constexpr (HD == 64) {
    const int f = ((r >> 1) & 1) | (((r ^ (r >> 2)) & 1) << 2);
    return r * HD + ((c ^ f) << 2);
  } else {
    return r * HD + (c << 2);
  }
}

// This lane's place: rows row and row + 8 (g = lane / 4), t = lane % 4
struct F32Lane {
  const float* mask;
  int T_len;
  float scale;
  int row, g, t;
};

// One key tile (keys key0 .. key0 + 8 NG - 1, in shared memory at k_s and
// v_s) for this warp's 16 query rows (at q_s, [16][Dh] in K's layout),
// folded into the online softmax: the
// running max m and (this lane's part of the) sum l of each row, and O, the
// output accumulators, rescaled when the max grows. Bit j of live: group j
// (keys key0 + 8j .. + 7) holds a score that the mask leaves finite (a dead
// group costs no product: its probabilities are exactly 0); of nz: the mask
// is not 0 there (only then is it read, through the L2). Accumulator layout
// of m16n8: S[j] holds keys key0 + 8j + 2t (elements 0, 2) and + 1 (1, 3)
// of rows row (0, 1) and row + 8 (2, 3). O[n] holds output dims NT c + n for
// columns c = 2t (elements 0, 2) and 2t + 1 (1, 3), NT = Dh / 8: V's B
// fragments read dims NT g .. + NT - 1 of one key row, contiguous.
template <int HD, int NG, bool kMask>
__device__ __forceinline__ void f32_tile(const float* q_s, const float* k_s,
                                         const float* v_s, int key0, uint32_t live, uint32_t nz,
                                         const F32Lane& w, float (&m)[2], float (&l)[2],
                                         float (&O)[HD / 8][4]) {
  constexpr int NT = HD / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  const int g = w.g, t = w.t;
  float S[NG][4];
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.f;

  // S = q . K^T over dims 16p + 4t .. + 3 of each lane: k-step 2p + s takes
  // dims 4t + 2s and + 1 as logical k = t and t + 4 (the dims of a k-step
  // are permuted so, in q's A fragments and K's B fragments alike, so that
  // each lane reads 16 contiguous bytes); K's B fragment is key 8j + g
#pragma unroll
  for (int p = 0; p < HD / 16; ++p) {
    uint32_t ah[2][4], al[2][4];
    const float4 qa = *reinterpret_cast<const float4*>(q_s + f32_off<HD>(g, 4 * p + t));
    const float4 qb = *reinterpret_cast<const float4*>(q_s + f32_off<HD>(g + 8, 4 * p + t));
    split_a(qa.x, qb.x, qa.y, qb.y, ah[0], al[0]);
    split_a(qa.z, qb.z, qa.w, qb.w, ah[1], al[1]);
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if ((live >> j) & 1u) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + f32_off<HD>(8 * j + g, 4 * p + t));
        mma_3xtf32(S[j], ah[0], al[0], kv.x, kv.y);
        mma_3xtf32(S[j], ah[1], al[1], kv.z, kv.w);
      }
    }
  }

  // s = q.k^T * scale + mask, -inf past T and in dead groups; the tile
  // folded into m and l
  const bool ragged = key0 + 8 * NG > w.T_len;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const bool lv = (live >> j) & 1u, add = (nz >> j) & 1u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = w.row + 8 * (e >> 1), c = key0 + 8 * j + 2 * t + (e & 1);
      float x = S[j][e] * w.scale;
      if (kMask && add && r < w.T_len && c < w.T_len)
        x += __ldg(w.mask + (long long)r * w.T_len + c);
      if (!lv || (ragged && c >= w.T_len)) x = -INFINITY;
      S[j][e] = x;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cm = -INFINITY;
#pragma unroll
    for (int j = 0; j < NG; ++j) cm = fmaxf(cm, fmaxf(S[j][2 * h], S[j][2 * h + 1]));
    const float mn = fmaxf(m[h], quad_max(cm));
    const float mr = mn == -INFINITY ? 0.f : mn;  // a row masked so far
    const float alpha = exp2_sfu((m[h] - mr) * kLog2e);
    m[h] = mn;
    l[h] *= alpha;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      O[n][2 * h] *= alpha;
      O[n][2 * h + 1] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        S[j][e] = exp2_sfu(fmaf(S[j][e], kLog2e, -mr * kLog2e));
        l[h] += S[j][e];
      }
  }

  // O += P . V, one k-step a live group of 8 keys. The keys of a k-step are
  // permuted (logical k = t is key 2t, k = t + 4 is 2t + 1), so that the
  // accumulator S[j] is P's A fragment as it lies: no shuffles.
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    if (!((live >> j) & 1u)) continue;
    uint32_t ah[4], al[4];
    split_a(S[j][0], S[j][2], S[j][1], S[j][3], ah, al);
    float v0[NT], v1[NT];  // keys 8j + 2t and + 1, dims NT g .. + NT - 1
    const int r0 = 8 * j + 2 * t;
    if constexpr (HD == 64) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(v_s + f32_off<HD>(r0, 2 * g + i));
        const float4 b = *reinterpret_cast<const float4*>(v_s + f32_off<HD>(r0 + 1, 2 * g + i));
        v0[4 * i] = a.x, v0[4 * i + 1] = a.y, v0[4 * i + 2] = a.z, v0[4 * i + 3] = a.w;
        v1[4 * i] = b.x, v1[4 * i + 1] = b.y, v1[4 * i + 2] = b.z, v1[4 * i + 3] = b.w;
      }
    } else {
      const float2 a = *reinterpret_cast<const float2*>(v_s + r0 * HD + NT * g);
      const float2 b = *reinterpret_cast<const float2*>(v_s + (r0 + 1) * HD + NT * g);
      v0[0] = a.x, v0[1] = a.y, v1[0] = b.x, v1[1] = b.y;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_3xtf32(O[n], ah, al, v0[n], v1[n]);
  }
}

// rows row and row + 8 below T: O / l, each lane's 2 NT contiguous dims of a
// row (columns 2t and 2t + 1) as 16-byte stores
template <int HD>
__device__ __forceinline__ void f32_store(float* oh, long long o_st, const F32Lane& w,
                                          const float (&O)[HD / 8][4], const float (&l)[2]) {
  constexpr int NT = HD / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / quad_sum(l[h]);
    const int r = w.row + 8 * h;
    float out[2 * NT];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int n = 0; n < NT; ++n) out[c * NT + n] = O[n][2 * h + c] * inv;
    if (r < w.T_len) {
#pragma unroll
      for (int i = 0; i < 2 * NT; i += 4)
        *reinterpret_cast<float4*>(oh + r * o_st + 2 * NT * w.t + i) =
            make_float4(out[i], out[i + 1], out[i + 2], out[i + 3]);
    }
  }
}

// K and V rows key0 .. key0 + rows - 1 of one head into the tile pair at k_s
// (K, then V kTile floats on; without with_v, K's rows alone: q's) by
// cp.async; rows past T zero-filled. The caller commits the group.
template <int HD>
__device__ __forceinline__ void f32_copy(float* k_s, int k_tile_floats, const float* kh,
                                         const float* vh, long long k_st, long long v_st,
                                         int key0, int rows, int T_len, bool with_v = true) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks, key = key0 + r;
    const long long src = (long long)min(key, T_len - 1);
    const int off = f32_off<HD>(r, c), n = key < T_len ? 16 : 0;
    cp_async16(smem_addr(k_s + off), kh + src * k_st + 4 * c, n);
    if (with_v) cp_async16(smem_addr(k_s + k_tile_floats + off), vh + src * v_st + 4 * c, n);
  }
}

// T <= 64: one block per (prompt, head), a warp per 16 query rows, one
// tile of 8 NG keys; the whole mask is added (no codes)
template <int HD, int NG>
__global__ void __launch_bounds__(4 * 32)
attention_fwd_f32_one(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ mask,
                      float* __restrict__ o, int H, int T_len, float scale, Strides qs,
                      Strides ks, Strides vs, Strides os) {
  extern __shared__ __align__(16) float f32_smem[];  // K | V: [8 NG][Dh] each, then q's rows
  constexpr int kTileFloats = 8 * NG * HD;
  const int b = blockIdx.x / H, hd = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const F32Lane w{mask, T_len, scale, warp * 16 + (lane >> 2), lane >> 2, lane & 3};
  float* q_s = f32_smem + 2 * kTileFloats;
  const float* qh = q + b * qs.b + hd * qs.h;
  f32_copy<HD>(f32_smem, kTileFloats, k + b * ks.b + hd * ks.h, v + b * vs.b + hd * vs.h, ks.t,
               vs.t, 0, 8 * NG, T_len);
  f32_copy<HD>(q_s, 0, qh, qh, qs.t, qs.t, 0, 16 * (blockDim.x >> 5), T_len, false);
  asm volatile("cp.async.commit_group;\n" ::);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float O[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[n][e] = 0.f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  f32_tile<HD, NG, true>(q_s + warp * 16 * HD, f32_smem, f32_smem + kTileFloats, 0, 0xffu,
                         mask != nullptr ? 0xffu : 0u, w, m, l, O);
  f32_store<HD>(o + b * os.b + hd * os.h, os.t, w, O, l);
}

// What each group of 8 keys of the mask holds for the real rows of 16-row
// tile blockIdx.y, in 64-key block blockIdx.x: bit g (g < 8) some entry is
// not -inf (the group is live), bit 8 + g some entry is not 0; pad keys
// count as dead. codes[row tile][64-key block].
__global__ void __launch_bounds__(128)
attention_f32_mask_codes(const float* __restrict__ mask, int T_len, uint32_t* __restrict__ codes) {
  __shared__ uint32_t bits;
  if (threadIdx.x == 0) bits = 0u;
  __syncthreads();
  const int r = blockIdx.y * 16 + threadIdx.x / 8, grp = threadIdx.x % 8;
  const int c0 = blockIdx.x * kF32CodeKeys + 8 * grp;
  bool live = false, nz = false;
  if (r < T_len)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c0 + i < T_len) {
        const float x = __ldg(mask + (long long)r * T_len + c0 + i);
        live |= x != -INFINITY;
        nz |= x != 0.f;
      }
  if (live) atomicOr(&bits, 1u << grp);
  if (nz) atomicOr(&bits, 1u << (8 + grp));
  __syncthreads();
  if (threadIdx.x == 0) codes[blockIdx.y * gridDim.x + blockIdx.x] = bits;
}

// T > 64: R x KS warps on query rows qt * 16 R .. + 16 R - 1 of one
// (prompt, head); blockIdx.x = (prompt * H + head) * n_qt + qt. Warp w
// takes row tile w % R and key half w / R. Up to T = 128 the block holds
// the whole head, a warp a row tile, one half (KS = 1); past it a 64-row
// query tile (R = 4; the tiles of a head adjacent in the grid, so that their
// reads of K and V meet in the L2) and two halves, each every other key
// tile of kF32Keys with its own online softmax, the two merged at the end.
// A step of the ring is a key tile for each half, copied in one cp.async
// group into one of two stages; the copies of step i + 1 run while step i is
// computed. The last tile holds tail_ng groups of 8 keys below T; its
// others count as dead. With a mask, codes (attention_f32_mask_codes) say
// which groups of each tile are live for each warp's rows; a step live for
// no warp is not copied. kMask: there is a mask (its code is compiled only
// then).
template <int HD, bool kMask>
__global__ void __launch_bounds__(kF32Warps * 32, 2)
attention_fwd_f32_multi(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ mask,
                        const uint32_t* __restrict__ codes, float* __restrict__ o, int H,
                        int T_len, int n_qt, int KS, int tail_ng, float scale, Strides qs,
                        Strides ks, Strides vs, Strides os) {
  // the block's q rows [16 R][Dh], the ring [stage][half][K | V][keys][Dh]
  // (both in K's swizzled layout), then a byte a step
  extern __shared__ __align__(16) float f32_smem[];
  constexpr int kTileFloats = kF32Keys * HD, kGroups = kF32Keys / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = (blockDim.x >> 5) / KS, half = warp / R, rt = warp % R;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt, b = bh / H, hd = bh % H;
  const float* kh = k + b * ks.b + hd * ks.h;
  const float* vh = v + b * vs.b + hd * vs.h;
  const int rt0 = qt * R;           // the block's first row tile
  const int row0 = (rt0 + rt) * 16;  // this warp's first row
  const F32Lane w{mask, T_len, scale, row0 + (lane >> 2), lane >> 2, lane & 3};
  const int n_kb = (T_len + kF32Keys - 1) / kF32Keys, n_steps = (n_kb + KS - 1) / KS;
  const int n_cb = (T_len + kF32CodeKeys - 1) / kF32CodeKeys;
  float* ring = f32_smem + 16 * R * HD;
  uint8_t* step_live = reinterpret_cast<uint8_t*>(ring + 4 * KS * kTileFloats);

  // the group bits (live | nonzero << 8) of row tile r in key tile kb
  auto code = [&](int r, int kb) -> uint32_t {
    if constexpr (!kMask) return (1u << kGroups) - 1u;
    const int key0 = kb * kF32Keys, sh = (key0 % kF32CodeKeys) / 8;
    const uint32_t c = __ldg(codes + r * n_cb + key0 / kF32CodeKeys) >> sh;
    return (c & ((1u << kGroups) - 1u)) | (((c >> 8) & ((1u << kGroups) - 1u)) << 8);
  };
  if constexpr (kMask) {
    for (int s = threadIdx.x; s < n_steps; s += blockDim.x) {
      uint32_t any = 0u;
      for (int kb = s * KS; kb < min(n_kb, s * KS + KS); ++kb)
        for (int i = 0; i < R && (rt0 + i) * 16 < T_len; ++i) any |= code(rt0 + i, kb) & 0xffu;
      step_live[s] = any != 0u;
    }
    __syncthreads();
  }
  auto next = [&](int s) {
    do ++s;
    while (kMask && s < n_steps && !step_live[s]);
    return s;
  };
  auto slot = [&](int st, int h) { return ring + (st * KS + h) * 2 * kTileFloats; };
  // every key tile of step s into stage st, one cp.async group
  auto issue = [&](int s, int st) {
    for (int h = 0; h < KS && s * KS + h < n_kb; ++h) {
      const int kb = s * KS + h;
      f32_copy<HD>(slot(st, h), kTileFloats, kh, vh, ks.t, vs.t, kb * kF32Keys,
                   kb == n_kb - 1 ? 8 * tail_ng : kF32Keys, T_len);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // q's rows and the first live step (if any) in one group
  const float* qh = q + b * qs.b + hd * qs.h;
  f32_copy<HD>(f32_smem, 0, qh, qh, qs.t, qs.t, rt0 * 16, 16 * R, T_len, false);
  int ld = next(-1);
  issue(ld, 0);
  ld = next(ld);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float O[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[n][e] = 0.f;
  int st = 0;
  for (int s = next(-1); s < n_steps; s = next(s), st ^= 1) {
    if (ld < n_steps) {  // the next live step into the other stage
      issue(ld, st ^ 1);
      ld = next(ld);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // step s has landed
    __syncthreads();
    const int kb = s * KS + half;
    uint32_t c = row0 < T_len && kb < n_kb ? code(rt0 + rt, kb) : 0u;
    if (kb == n_kb - 1) c &= ((1u << tail_ng) - 1u) | 0xff00u;  // no groups past T
    if (c & 0xffu) {
      const float* k_s = slot(st, half);
      f32_tile<HD, kGroups, kMask>(f32_smem + rt * 16 * HD, k_s, k_s + kTileFloats, kb * kF32Keys,
                                   c & 0xffu, c >> 8, w, m, l, O);
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  if (KS == 2) {  // the second half's max, sum and accumulators into the first's
    float* x = ring + rt * (HD / 2 + 4) * 32 + lane;  // [row tile][value][lane]
    if (half == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) x[h * 32] = m[h], x[(2 + h) * 32] = l[h];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(4 + 4 * n + e) * 32] = O[n][e];
    }
    __syncthreads();
    if (half == 1) return;
    constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = x[h * 32], mn = fmaxf(m[h], m1), mr = mn == -INFINITY ? 0.f : mn;
      const float a0 = exp2_sfu((m[h] - mr) * kLog2e), a1 = exp2_sfu((m1 - mr) * kLog2e);
      l[h] = l[h] * a0 + x[(2 + h) * 32] * a1;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e)
          O[n][e] = O[n][e] * a0 + x[(4 + 4 * n + e) * 32] * a1;
    }
  }
  f32_store<HD>(o + b * os.b + hd * os.h, os.t, w, O, l);
}

// 8-key groups of a tile of `keys` keys, rounded up to an instantiation's
int f32_groups(int keys) {
  const int g = (keys + 7) / 8;
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : g <= 6 ? 6 : 8;
}

// the streamed kernel's mask codes: bytes of scratch (0 for T <= 64)
long long f32_codes_bytes(int T_len) {
  if (T_len <= kF32OneKeys) return 0;
  const long long rt = (T_len + 15) / 16, cb = (T_len + kF32CodeKeys - 1) / kF32CodeKeys;
  return rt * cb * (long long)sizeof(uint32_t);
}

// codes: f32_codes_bytes(T) of device memory, given with a mask
template <int HD>
int launch_f32(const float* q, const float* k, const float* v, const float* mask, uint32_t* codes,
               float* o, int B, int H, int T_len, float scale, Strides qs, Strides ks,
               Strides vs, Strides os, cudaStream_t stream) {
  if (T_len <= kF32OneKeys) {  // one block per (prompt, head), a warp per 16 rows
    const int ng = f32_groups(T_len), warps = (T_len + 15) / 16;
    const size_t smem = (2 * 8 * ng + 16 * warps) * HD * sizeof(float);
    auto kernel = ng == 1   ? attention_fwd_f32_one<HD, 1>
                  : ng == 2 ? attention_fwd_f32_one<HD, 2>
                  : ng == 4 ? attention_fwd_f32_one<HD, 4>
                  : ng == 6 ? attention_fwd_f32_one<HD, 6>
                            : attention_fwd_f32_one<HD, 8>;
    kernel<<<B * H, warps * 32, smem, stream>>>(q, k, v, mask, o, H, T_len, scale, qs, ks, vs, os);
    return (int)cudaGetLastError();
  }
  if (mask != nullptr && codes == nullptr) return -1;
  const int n_kb = (T_len + kF32Keys - 1) / kF32Keys;
  const int tail_ng = (T_len - (n_kb - 1) * kF32Keys + 7) / 8;  // groups of the last tile
  // row tiles a block: the whole head up to T = 128 (a warp each), else 4
  // (64-row query tiles) with two key halves
  const int KS = T_len <= kF32Warps * 16 ? 1 : 2;
  const int R = KS == 1 ? (T_len + 15) / 16 : kF32Warps / 2;
  const int n_qt = (T_len + 16 * R - 1) / (16 * R);
  const long long n_blocks = (long long)B * H * n_qt;
  if (n_blocks > 0x7fffffffLL) return -1;
  const int n_steps = (n_kb + KS - 1) / KS;
  const size_t smem = (16 * R + 2 * 2 * (size_t)KS * kF32Keys) * HD * sizeof(float) +
                      ((n_steps + 15) & ~15);
  if (smem > kMaxSmemBytes) return -1;
  if (mask != nullptr) {
    const int rt = (T_len + 15) / 16, cb = (T_len + kF32CodeKeys - 1) / kF32CodeKeys;
    attention_f32_mask_codes<<<dim3(cb, rt), 128, 0, stream>>>(mask, T_len, codes);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  auto kernel =
      mask != nullptr ? attention_fwd_f32_multi<HD, true> : attention_fwd_f32_multi<HD, false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(int)n_blocks, R * KS * 32, smem, stream>>>(q, k, v, mask, codes, o, H, T_len, n_qt,
                                                       KS, tail_ng, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Device bytes the caller passes as hgr_attention_fwd's codes with a mask:
// the mask-block codes of the tiled bf16 kernel (T >= 97) or of the
// streamed fp32 kernel (T > 64), else 0.
long long hgr_attention_codes_bytes(int dtype, int T_len) {
  const long long n_kb = (T_len + kTile - 1) / kTile;
  if (dtype == 0) return f32_codes_bytes(T_len);
  return dtype == 1 && T_len > kShortMaxT ? n_kb * n_kb : 0;
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; codes is
// hgr_attention_codes_bytes of scratch (may be null when that is 0 or there
// is no mask). Returns 0, a cudaError_t from the launch, -1 for shapes the
// kernel does not take, or -2 when the driver refuses a tensor map.
int hgr_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                      const float* mask, void* codes, void* o, int B, int H, int T_len,
                      int Dh, float scale, long long q_sb, long long q_sh,
                      long long q_st, long long k_sb, long long k_sh,
                      long long k_st, long long v_sb, long long v_sh,
                      long long v_st, long long o_sb, long long o_sh,
                      long long o_st, void* stream) {
  if (T_len < 1 || B < 1 || H < 1) return -1;
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st};
  const Strides vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {  // fp32: head dim 64 or 16
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    uint32_t* cf = static_cast<uint32_t*>(codes);
    if (Dh == 64)
      return launch_f32<64>(qf, kf, vf, mask, cf, of, B, H, T_len, scale, qs, ks, vs, os, st);
    if (Dh == 16)
      return launch_f32<16>(qf, kf, vf, mask, cf, of, B, H, T_len, scale, qs, ks, vs, os, st);
    return -1;
  }
  if (dtype != 1 || (Dh != kDh && (Dh != kWideDh || mask != nullptr))) return -1;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  // head dim 72 takes the tiled kernel at every T (SigLIP's text tower at 64)
  if (T_len > kShortMaxT || Dh == kWideDh)
    return launch_bf16_tiled(qb, kb, vb, mask, static_cast<uint8_t*>(codes), ob, B, H, T_len,
                             Dh, scale, qs, ks, vs, os, st);
  // One pass while a warp's scores (8 x RT fp32 registers) fit its register
  // budget without spilling (-Xptxas -v), T <= 96. Block size and resident
  // blocks per SM set that budget: 65536 / (warps per SM rounded up to 4 per
  // scheduler) registers.
#define HGR_BF16(kt, threads, blocks) \
  (int)launch_bf16<kt, threads, blocks>(qb, kb, vb, mask, ob, B, H, T_len, scale, qs, ks, vs, os, st)
  switch ((T_len + 15) / 16) {
    case 1: return HGR_BF16(1, 256, 2);
    case 2: return HGR_BF16(2, 256, 2);
    case 3: return HGR_BF16(3, 256, 2);
    case 4: return HGR_BF16(4, 128, 3);
    case 5: return HGR_BF16(5, 160, 3);
    default: return HGR_BF16(6, 192, 2);
  }
#undef HGR_BF16
}

const char* hgr_cuda_error_string(int code) {
  if (code == -1) return "bad arguments";
  if (code == kTensorMapRefused) return "the driver refused a tensor map (cuTensorMapEncodeTiled)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
