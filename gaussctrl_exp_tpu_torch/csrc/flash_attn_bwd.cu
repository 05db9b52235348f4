// Kernels B4 (dK, dV) and B5 (dQ): the flash-attention backward for Hopper
// (sm_90a).
//
// Replace the backward of the library TPU flash attention that
// gaussctrl_exp_tpu/diffusion/attention.py:37 `_flash_sdpa` runs
// (jax.experimental.pallas.ops.tpu.flash_attention): its custom VJP launches
// `_flash_attention_bwd_dkv` (B4) and `_flash_attention_bwd_dq` (B5), reached
// from gaussctrl_exp_tpu/diffusion/mv_generator.py:198, the depth generator's
// training step, which differentiates through the SD1.x UNet.
//
// They compute the gradient of the non-causal O = softmax(Q·Kᵀ·D^-½)·V with
// an fp32 softmax, for (B, H, S, D) queries and (B, H, T, D) keys and values,
// from the forward's per-row log-sum-exp `lse` (B3 writes it), the output
// cotangent dO and delta = rowsum(dO ∘ O) (fp32, computed by the wrapper):
//   P = exp(Q·Kᵀ·scale − lse),  dP = dO·Vᵀ,  dS = P ∘ (dP − delta),
//   dV = Pᵀ·dO,  dK = dSᵀ·Q·scale  (B4),     dQ = dS·K·scale  (B5).
// Neither kernel writes the S×T matrices: P, dP and dS live in registers.
//
// What bounds them: per (batch, head, query, key, dim) B4 does 4 products
// (Q·Kᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) and B5 3 (Q·Kᵀ, dO·Vᵀ, dS·K), 2 operations
// each. At the depth generator's training shape (4, 8, 4096, 4096, 40) fp32
// that is 1.7e11 and 1.3e11 operations on ~10 MB, as long as the S×T scores
// never reach device memory. On an H100 SXM at its data sheet's peaks (700
// W): 2.56 and 1.92 ms at the fp32 FMA rate (67 TFLOP/s), 1.04 and 0.78 ms
// at a third of the TF32 tensor-core rate (494.7 TFLOP/s), which is what
// fp32-accurate products cost there (3×TF32); the exponentials, one per
// score and kernel, take 0.14 ms. In bf16 the tensor cores' 989 TFLOP/s
// bound them.
//
// Design:
//  * B4 works on the transposed problem, so that no product needs a
//    transposed register fragment: each warp owns 16 (or 32) key rows and
//    computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ directly, whose C fragments become
//    the A fragments of Pᵀ·dO and dSᵀ·Q in registers. dK and dV accumulate
//    in fp32 registers and are written once.
//  * B5 is B3's layout: each warp owns 16 (or 32) query rows with Q and dO
//    as A fragments; its dS fragments feed dS·K.
//  * bf16 (mma.sync.m16n8k16, fp32 accumulators; redesigned for Hopper).
//    At the generator's (4, 8, 4096, 4096, 40) B4's four products take
//    0.174 ms and B5's three 0.130 ms at 989 TFLOP/s, and one exponential a
//    score and kernel 0.139 ms on the special-function unit: B5 is held by
//    its exponentials as much as by its products. So the design keeps the
//    tensor cores fed from shared memory and spends one FFMA and one
//    `ex2.approx.ftz` a score:
//    - B4 and B5 are one body (bwd_bf16): a CTA owns 128 rows (32 a warp, two
//      16-row mma blocks, at D ≤ 48) or 64, their A fragments read once into
//      registers (D ≤ 80) or by `ldmatrix` at each use; tiles of 64 (D ≤ 80)
//      or 32 rows of the other two operands go through a two-stage ring
//      filled by `cp.async` 16 bytes a thread (zero-fill past the rows and
//      past D), tile j + 1's copy in flight while tile j is computed, one
//      barrier a tile. Rows are stored as they arrive, with a pitch of an
//      odd number of 16-byte chunks, so the eight row addresses of each
//      `ldmatrix` phase fall in distinct bank groups.
//    - Each tile is walked 16 rows at a time: the two score products'
//      B fragments by `ldmatrix.x4` from the rows as they lie (m16n8k8 with
//      `.x2` over a last 8 of D, so D = 40 is 16 + 16 + 8), then P and dS,
//      then the gradient products, whose B fragments `ldmatrix.x4.trans`
//      reads from the same rows: no transposed copy. The scores of 16 rows
//      are all the registers the slice holds beside the accumulators.
//    - P = ex2(fma(s, scale·log2 e, −lse·log2 e)): one FFMA and one
//      `ex2.approx.ftz` a score. P and dS are rounded to bf16 as the A
//      fragments of their products, as the forward rounds P.
//    - Rows past S or T are zero rows, so their products add nothing; only
//      B5's keys past T in the last tile get P = 0 (P = exp(−lse) of a zero
//      row need not be finite). Slices past the last row are skipped.
//    - Where B4's key blocks give too few CTAs for the card
//      (gctorch_flash_attn_bwd_dkv_splits decides), the query tiles are split
//      over `splits` CTAs that write fp32 partial sums, and a second kernel
//      adds them in a fixed order (as fp32).
//  * fp32 (3×TF32 on mma.sync.m16n8k8, tf32_mma.cuh): the CTA's own 64 rows (K
//    and V for B4, Q and dO for B5) and a two-stage ring of the other operands'
//    tiles are copied by `cp.async`, 16 bytes a thread, row-major with a pitch
//    of D + 4 floats. m16n8k8's C fragment holds columns 2·tq and 2·tq + 1, its
//    A fragment columns tq and tq + 4: the gradient products relabel their
//    k-slots (slot tq is column 2·tq, slot tq + 4 is 2·tq + 1) and read the B
//    fragments with the same labels, so they come from the row-major tiles and
//    no transposed copy is made. The CTA's own rows are split into TF32 hi and
//    lo once, when they land (D ≤ 48; above, shared memory holds them only as
//    they are and their fragments are split as they are read), each ring tile
//    once when it lands, P and dS in registers. The gradient products sum each
//    ring tile in a fresh accumulator and add it to dK, dV or dQ on the FP32
//    pipe: the tensor cores truncate their fp32 sums, and a chain over
//    thousands of rows gathers that bias. P = ex2 of one FFMA of the raw score
//    against lse·log2 e (`ex2.approx.ftz`). Where B4's key blocks give too few
//    CTAs for the card (gctorch_flash_attn_bwd_dkv_splits decides), the query
//    tiles are split over `splits` CTAs that write partial sums, and a second
//    kernel adds them in a fixed order.
//  * fp32: keys past T get P = 0; queries past S run on zero rows (so dO =
//    0, delta = 0 and P·dO = dS = 0) and store nothing.
//  * Both: D is zero-padded in registers and shared memory only. Strides are
//    taken for batch, head and
//    sequence (D contiguous), and the outputs are written in the (B, L, H, D)
//    layout the wrapper allocates.
//  * No atomics: the result is the same bit for bit on every run.
//
// Registers a thread, fp32 B4 / B5, by width (ptxas -v for sm_90a, as
// chip_smoke.py printed them on an NVIDIA H100 80GB HBM3, 700 W): 8: 102 /
// 101, 16: 128 / 109, 24: 166 / 144, 32: 171 / 154, 40: 217 / 168, 48: 239
// / 170, 64: 210 / 141, 80: 252 / 167, 96: 255 / 178, 128: 255 / 194, 160:
// 255 / 226. B4 spills 4 bytes at 96 and 12 at 160 (dK and dV alone hold D
// registers); B5 spills nothing. bf16 B4 / B5 (the same build): 16: 128 /
// 111, 32: 196 / 153, 40: 232 / 162, 48: 250 / 200, 64: 203 / 157, 80: 236 /
// 185, 96: 204 / 165, 128: 246 / 182, 160: 255 / 206; B4 spills 44 bytes at
// 160. Both ask ptxas for 2 CTAs an SM, B5 for 3 at D ≤ 40 (Bf16Tile::B5_CTAS).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int MAX_D = 160;
constexpr float LOG2E = 1.4426950408889634f;
// B4 splits a key block's queries over more CTAs until the card has this
// many CTAs an SM
constexpr int DKV_CTAS_PER_SM = 2;
long long sum_launches = 0;  // launches of gctorch_attn_bwd_b4_dkv_sum

struct Strides {
  long long b, h, s;
};

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;  // (B, H, S) contiguous
  void *dq, *dk, *dv;
  int H, S, T, D;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float scale, scale_log2;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// ---------------------------------------------------------------- bf16

// own rows a bf16 CTA holds (keys for B4, queries for B5) and rows a ring
// tile of the other operands, for head width d: the same for D as for the
// width DT it is rounded up to
constexpr int bf16_own_rows(int d) { return d <= 48 ? 2 * WARPS * 16 : WARPS * 16; }
constexpr int bf16_ring_rows(int d) { return d <= 80 ? 64 : 32; }

// the bf16 tiling for head width DT (D ≤ DT; DT one of 16, 32, 40, 48, 64,
// 80, 96, 128, 160)
template <int DT>
struct Bf16Tile {
  static constexpr int THREADS = WARPS * 32;
  static constexpr int MT = DT <= 48 ? 2 : 1;              // 16-row mma blocks of own rows a warp
  static constexpr int ROWS = bf16_own_rows(DT);           // own rows a CTA
  static constexpr int BN = bf16_ring_rows(DT);            // rows a ring tile
  static constexpr bool OWN_REGS = DT <= 80;               // the own rows' A fragments live in registers
  static constexpr int PITCH = (DT / 8) % 2 ? DT : DT + 8;  // smem row pitch: an odd number of 16-byte chunks
  static constexpr int CHUNKS = DT / 8;                    // 16-byte copies a row
  static constexpr int K16 = DT / 16;                      // 16-wide steps of the score products over D
  static constexpr bool K8 = DT % 16 != 0;                 // and a last 8-wide one
  static constexpr int NT = DT / 8;                        // 8-wide n-tiles of the gradient products
  static constexpr int OWN = ROWS * PITCH;                 // elements of one own operand
  static constexpr int TILE = BN * PITCH;                  // elements of one ring operand
  // a ring stage: the two operands' tiles, then (B4) the tile's lse and delta
  static constexpr int STAGE_BYTES = 2 * TILE * 2 + 2 * BN * 4;
  static constexpr size_t BYTES = 2 * OWN * 2 + 2 * STAGE_BYTES;
  // CTAs an SM that B5 asks ptxas for: 3 (at most 168 registers a thread)
  // where that costs no spill and no time, at D ≤ 40 (B4 holds two
  // accumulators and asks for 2)
  static constexpr int B5_CTAS = DT <= 40 ? 3 : 2;
  static_assert(OWN_REGS || !K8, "the 8-wide step takes the own rows' fragments from registers");
};

template <int DT>
using OwnFrag = uint32_t[Bf16Tile<DT>::MT][Bf16Tile<DT>::K16][4];  // own rows' A fragments over D
template <int DT>
using OwnTail = uint32_t[Bf16Tile<DT>::MT][2];  // and over the last 8 of D (m16n8k8)
template <int DT>
using SliceC = float[Bf16Tile<DT>::MT][2][4];  // a 16-row slice's scores (C fragments)
template <int DT>
using Acc = float[Bf16Tile<DT>::MT][Bf16Tile<DT>::NT][4];  // gradient accumulators

__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// 16 bytes global → shared, asynchronously; zeros where !ok (nothing is read)
__device__ __forceinline__ void cp_async16(uint16_t* dst, const void* src, bool ok) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + N) of a (rows, D) bf16 matrix into a shared tile of pitch
// PITCH, 16 bytes a copy; zeros past `rows` and past D
template <class P, int N>
__device__ __forceinline__ void stage_bf16(uint16_t* dst, const __nv_bfloat16* base, long long stride, int r0,
                                           int rows, int D) {
#pragma unroll
  for (int e0 = 0; e0 < N * P::CHUNKS; e0 += P::THREADS) {
    const int e = e0 + threadIdx.x;
    if (N * P::CHUNKS % P::THREADS == 0 || e < N * P::CHUNKS) {
      const int r = e / P::CHUNKS, c = (e % P::CHUNKS) * 8, row = r0 + r;
      const bool ok = row < rows && c < D;
      cp_async16(dst + r * P::PITCH + c, ok ? base + (long long)row * stride + c : base, ok);
    }
  }
}

// the A fragment of own block i at 16-wide step kk: from registers, or by
// ldmatrix from the own rows (arow: this lane's ldmatrix row and column)
template <int DT>
__device__ __forceinline__ void own_a(uint32_t (&a)[4], const OwnFrag<DT>& regs, const uint16_t* arow, int i,
                                      int kk) {
  if constexpr (Bf16Tile<DT>::OWN_REGS) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = regs[i][kk][e];
  } else {
    ldsm_x4(a, arow + 16 * i * Bf16Tile<DT>::PITCH + kk * 16);
  }
}

// the own rows' A fragments into registers (ldmatrix.x4 block b: rows + (b %
// 2)·8, columns + (b / 2)·8; .x2 for the last 8 columns, lanes 0-15 give rows
// 0-15)
template <int DT>
__device__ __forceinline__ void own_to_regs(OwnFrag<DT>& r, OwnTail<DT>& t, const uint16_t* arow, int lane) {
  using P = Bf16Tile<DT>;
#pragma unroll
  for (int i = 0; i < P::MT; ++i) {
#pragma unroll
    for (int kk = 0; kk < P::K16; ++kk) ldsm_x4(r[i][kk], arow + 16 * i * P::PITCH + kk * 16);
    if constexpr (P::K8) ldsm_x2(t[i], arow - (lane >> 4) * 8 + 16 * i * P::PITCH + P::K16 * 16);
  }
}

// s = X·Uᵀ and dp = Y·Wᵀ of the warp's own blocks against the 16 ring rows at
// U and W (B fragments by ldmatrix from the rows as they lie: block b of
// .x4 holds rows + (b / 2)·8, columns + (b % 2)·8)
template <int DT>
__device__ __forceinline__ void slice_scores(SliceC<DT>& s, SliceC<DT>& dp, const OwnFrag<DT>& xr,
                                             const OwnTail<DT>& xt, const uint16_t* xrow, const OwnFrag<DT>& yr,
                                             const OwnTail<DT>& yt, const uint16_t* yrow, const uint16_t* U,
                                             const uint16_t* W, int lane) {
  using P = Bf16Tile<DT>;
  constexpr int MT = P::MT, PITCH = P::PITCH;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][nt][j] = dp[i][nt][j] = 0.f;
  const int boff = ((lane >> 4) * 8 + (lane & 7)) * PITCH + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < P::K16; ++kk) {
    uint32_t bu[4], bw[4];
    ldsm_x4(bu, U + boff + kk * 16);
    ldsm_x4(bw, W + boff + kk * 16);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[4];
      own_a<DT>(a, xr, xrow, i, kk);
      mma16(s[i][0], a, bu[0], bu[1]);
      mma16(s[i][1], a, bu[2], bu[3]);
      own_a<DT>(a, yr, yrow, i, kk);
      mma16(dp[i][0], a, bw[0], bw[1]);
      mma16(dp[i][1], a, bw[2], bw[3]);
    }
  }
  if constexpr (P::K8) {  // the last 8 of D: .x2 blocks hold rows 0-7 and 8-15
    const int toff = (lane & 15) * PITCH + P::K16 * 16;
    uint32_t bu[2], bw[2];
    ldsm_x2(bu, U + toff);
    ldsm_x2(bw, W + toff);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma8(s[i][0], xt[i], bu[0]);
      mma8(s[i][1], xt[i], bu[1]);
      mma8(dp[i][0], yt[i], bw[0]);
      mma8(dp[i][1], yt[i], bw[1]);
    }
  }
}

// acc += A·R over the 16 ring rows at R (R's rows contracted, D along n): A
// the own blocks' A fragments of P or dS, R's B fragments by ldmatrix.trans
// from its rows as they lie (block b of .x4 holds rows + (b % 2)·8, columns +
// (b / 2)·8; .x2 for an odd last n-tile)
template <int DT>
__device__ __forceinline__ void slice_grad(Acc<DT>& acc, const uint32_t (&a)[Bf16Tile<DT>::MT][4], const uint16_t* R,
                                           int lane) {
  using P = Bf16Tile<DT>;
  constexpr int MT = P::MT, NT = P::NT;
  const uint16_t* r = R + (((lane >> 3) & 1) * 8 + (lane & 7)) * P::PITCH + (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < NT / 2; ++dp) {
    uint32_t b[4];
    ldsm_x4_t(b, r + dp * 16);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma16(acc[i][2 * dp], a[i], b[0], b[1]);
      mma16(acc[i][2 * dp + 1], a[i], b[2], b[3]);
    }
  }
  if constexpr (NT % 2) {
    uint32_t b[2];
    ldsm_x2_t(b, r - (lane >> 4) * 8 + (NT - 1) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) mma16(acc[i][NT - 1], a[i], b[0], b[1]);
  }
}

// B4 (DKV) and B5 in bf16. A CTA owns ROWS rows: keys (B4: K and V as X and
// Y) or queries (B5: Q and dO); tiles of BN rows of the other two operands (B4:
// Q and dO as U and W, with their lse and delta; B5: K and V) go through a
// two-stage cp.async ring, walked 16 rows at a time. Each 16-row slice:
// scores X·Uᵀ and Y·Wᵀ; P = ex2(fma(s, scale·log2 e, −lse·log2 e)) and dS =
// P ∘ (dP − delta), packed to bf16 as the A fragments of the gradient
// products; B4: dV += P·W and dK += dS·U, B5: dQ += dS·U, with U and W read
// transposed by ldmatrix. B4's grid z walks query tiles [z·tiles, (z + 1)·
// tiles): with one split it writes dK·scale and dV; with more, its unscaled
// fp32 partials go to the workspace `ws` (dK's splits, then dV's, each (B·H,
// T, D)) for gctorch_attn_bwd_b4_dkv_sum.
template <int DT, bool DKV, bool MASK>
__device__ __forceinline__ void bf16_slice(Acc<DT>& acc0, Acc<DT>& acc1, const OwnFrag<DT>& xr,
                                           const OwnTail<DT>& xt, const uint16_t* xrow, const OwnFrag<DT>& yr,
                                           const OwnTail<DT>& yt, const uint16_t* yrow, const uint16_t* U,
                                           const uint16_t* W, const float* L, const float (&nl)[Bf16Tile<DT>::MT][2],
                                           const float (&del)[Bf16Tile<DT>::MT][2], int key0, int T, float sl2,
                                           int lane) {
  using P = Bf16Tile<DT>;
  constexpr int MT = P::MT;
  const int tq = lane & 3;
  SliceC<DT> s, dp;
  slice_scores<DT>(s, dp, xr, xt, xrow, yr, yt, yrow, U, W, lane);
  // C element j of n-tile nt: row g (j < 2) or g + 8 of each block, column
  // nt·8 + 2·tq + (j & 1): a query (B4) or a key (B5) of the slice. The C
  // fragments of the two n-tiles are the A fragment of the 16-row contraction
  uint32_t pa[MT][4], dsa[MT][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    float cn[2], cd[2];  // B4: −lse·log2 e and delta of the two columns
    if constexpr (DKV) {
      const float2 l2 = *reinterpret_cast<const float2*>(L + nt * 8 + 2 * tq);
      const float2 d2 = *reinterpret_cast<const float2*>(L + P::BN + nt * 8 + 2 * tq);
      cn[0] = -l2.x * LOG2E;
      cn[1] = -l2.y * LOG2E;
      cd[0] = d2.x;
      cd[1] = d2.y;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float n, d;
        if constexpr (DKV) {
          n = cn[j & 1];
          d = cd[j & 1];
        } else {
          n = nl[i][j >> 1];
          d = del[i][j >> 1];
        }
        p[j] = ex2(fmaf(s[i][nt][j], sl2, n));
        if constexpr (MASK) {
          if (key0 + nt * 8 + 2 * tq + (j & 1) >= T) p[j] = 0.f;
        }
        ds[j] = p[j] * (dp[i][nt][j] - d);
      }
      pa[i][2 * nt] = pack_bf16(p[0], p[1]);
      pa[i][2 * nt + 1] = pack_bf16(p[2], p[3]);
      dsa[i][2 * nt] = pack_bf16(ds[0], ds[1]);
      dsa[i][2 * nt + 1] = pack_bf16(ds[2], ds[3]);
    }
  }
  if constexpr (DKV) slice_grad<DT>(acc1, pa, W, lane);  // dV += Pᵀ·dO
  slice_grad<DT>(acc0, dsa, U, lane);                     // dK += dSᵀ·Q, dQ += dS·K
}

template <int DT, bool DKV>
__device__ __forceinline__ void bwd_bf16(const Args& a, float* ws, int tiles) {
  using P = Bf16Tile<DT>;
  constexpr int MT = P::MT, BN = P::BN, PITCH = P::PITCH, NT = P::NT;
  extern __shared__ __align__(128) uint16_t bsm[];
  uint16_t* X = bsm;
  uint16_t* Y = bsm + P::OWN;
  unsigned char* ring = reinterpret_cast<unsigned char*>(bsm + 2 * P::OWN);

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int own0 = blockIdx.x * P::ROWS;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const __nv_bfloat16 *xb = DKV ? kb : qb, *yb = DKV ? vb : dob, *ub = DKV ? qb : kb, *wb = DKV ? dob : vb;
  const long long x_s = DKV ? a.ks.s : a.qs.s, y_s = DKV ? a.vs.s : a.dos.s;
  const long long u_s = DKV ? a.qs.s : a.ks.s, w_s = DKV ? a.dos.s : a.vs.s;
  const int n_own = DKV ? a.T : a.S, n_ring = DKV ? a.S : a.T;
  const float* lse = a.lse + (long long)bh * a.S;
  const float* delta = a.delta + (long long)bh * a.S;
  const int n_t = (n_ring + BN - 1) / BN;
  const int t0 = DKV ? blockIdx.z * tiles : 0, t1 = DKV ? min(n_t, t0 + tiles) : n_t;

  stage_bf16<P, P::ROWS>(X, xb, x_s, own0, n_own, a.D);
  stage_bf16<P, P::ROWS>(Y, yb, y_s, own0, n_own, a.D);
  auto load_tile = [&](int t) {  // one commit group a tile, empty past the split's last
    if (t < t1) {
      uint16_t* U = reinterpret_cast<uint16_t*>(ring + ((t - t0) & 1) * P::STAGE_BYTES);
      stage_bf16<P, BN>(U, ub, u_s, t * BN, n_ring, a.D);
      stage_bf16<P, BN>(U + P::TILE, wb, w_s, t * BN, n_ring, a.D);
      if constexpr (DKV) {  // zeros past S: there Q = dO = 0, so P·dO = dS·Q = 0
        float* L = reinterpret_cast<float*>(U + 2 * P::TILE);
        for (int r = threadIdx.x; r < BN; r += P::THREADS) {
          const bool ok = t * BN + r < a.S;
          cp_async4(L + r, ok ? lse + t * BN + r : lse, ok);
          cp_async4(L + BN + r, ok ? delta + t * BN + r : delta, ok);
        }
      }
    }
    cp_commit();
  };
  load_tile(t0);  // the own rows land with the first tile

  // B5: the lse and delta of this thread's query rows g and g + 8 of each
  // block (rows past S: zeros, and dS = 0 there as dO = 0)
  float nl[MT][2], del[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = own0 + warp * 16 * MT + 16 * i + g + 8 * r;
      const bool in = !DKV && row < a.S;
      nl[i][r] = in ? -lse[row] * LOG2E : 0.f;
      del[i][r] = in ? delta[row] : 0.f;
    }

  // this lane's ldmatrix address in the own rows: rows + (lane & 15), columns + (lane / 16)·8
  const int arow = (warp * 16 * MT + (lane & 15)) * PITCH + (lane >> 4) * 8;
  OwnFrag<DT> xr, yr;
  OwnTail<DT> xt, yt;
  Acc<DT> acc0, acc1;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc0[i][nt][j] = acc1[i][nt][j] = 0.f;

  for (int t = t0; t < t1; ++t) {
    cp_wait_all();
    __syncthreads();  // tile t has landed for all; every warp is done with tile t − 1
    if constexpr (P::OWN_REGS) {
      if (t == t0) {
        own_to_regs<DT>(xr, xt, X + arow, lane);
        own_to_regs<DT>(yr, yt, Y + arow, lane);
      }
    }
    load_tile(t + 1);
    const uint16_t* U = reinterpret_cast<const uint16_t*>(ring + ((t - t0) & 1) * P::STAGE_BYTES);
    const uint16_t* W = U + P::TILE;
    const float* L = reinterpret_cast<const float*>(U + 2 * P::TILE);
    // slices past the last ring row hold only zeros: skip them. B5's keys
    // past T in the last tile get P = 0 (a zero key row gives a finite score
    // but P = exp(−lse) need not be)
    const int left = n_ring - t * BN, n_sl = left < BN ? (left + 15) / 16 : BN / 16;
    const bool mask = !DKV && left < BN;
    for (int sl = 0; sl < n_sl; ++sl) {
      const int o = sl * 16 * PITCH;
      if (mask)
        bf16_slice<DT, DKV, !DKV>(acc0, acc1, xr, xt, X + arow, yr, yt, Y + arow, U + o, W + o, L + sl * 16, nl,
                                  del, t * BN + sl * 16, n_ring, a.scale_log2, lane);
      else
        bf16_slice<DT, DKV, false>(acc0, acc1, xr, xt, X + arow, yr, yt, Y + arow, U + o, W + o, L + sl * 16, nl,
                                   del, t * BN + sl * 16, n_ring, a.scale_log2, lane);
    }
  }
  cp_wait_all();  // a split with no tile still has the own rows' copies in flight

  // stores: rows own0 + warp·16·MT + 16·i + g (+ 8), columns nt·8 + 2·tq
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = own0 + warp * 16 * MT + 16 * i + g + 8 * r;
      if (row >= n_own) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + tq * 2;
        if (c >= a.D) continue;
        const float x0 = acc0[i][nt][2 * r], x1 = acc0[i][nt][2 * r + 1];
        if constexpr (DKV) {
          const float v0 = acc1[i][nt][2 * r], v1 = acc1[i][nt][2 * r + 1];
          if (ws == nullptr) {
            __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(a.dk) + b * a.dks.b + h * a.dks.h;
            __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(a.dv) + b * a.dvs.b + h * a.dvs.h;
            *reinterpret_cast<uint32_t*>(dkb + (long long)row * a.dks.s + c) = pack_bf16(x0 * a.scale, x1 * a.scale);
            *reinterpret_cast<uint32_t*>(dvb + (long long)row * a.dvs.s + c) = pack_bf16(v0, v1);
          } else {
            const long long n = (long long)gridDim.y * a.T * a.D;
            float* dkw = ws + blockIdx.z * n + ((long long)bh * a.T + row) * a.D + c;
            *reinterpret_cast<float2*>(dkw) = make_float2(x0, x1);
            *reinterpret_cast<float2*>(dkw + gridDim.z * n) = make_float2(v0, v1);
          }
        } else {
          __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
          *reinterpret_cast<uint32_t*>(dqb + (long long)row * a.dqs.s + c) = pack_bf16(x0 * a.scale, x1 * a.scale);
        }
      }
    }
}

template <int DT>
__global__ void __launch_bounds__(WARPS * 32, 2) gctorch_attn_bwd_b4_dkv_bf16(Args a, float* ws, int tiles) {
  bwd_bf16<DT, true>(a, ws, tiles);
}

template <int DT>
__global__ void __launch_bounds__(WARPS * 32, Bf16Tile<DT>::B5_CTAS) gctorch_attn_bwd_b5_dq_bf16(Args a) {
  bwd_bf16<DT, false>(a, nullptr, 0);
}

// B4's second pass when the queries were split: dK and dV as the sums of
// the splits' partials, taken in split order (no atomics: the same bits on
// every run), dK scaled, written in the output layout and type
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <class T>
__global__ void __launch_bounds__(256) gctorch_attn_bwd_b4_dkv_sum(Args a, const float* ws, int splits, int BH) {
  const long long n = (long long)BH * a.T * a.D;
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i >= n) return;
  float sk = 0.f, sv = 0.f;
  for (int z = 0; z < splits; ++z) {
    sk += ws[z * n + i];
    sv += ws[(splits + z) * n + i];
  }
  const int d = static_cast<int>(i % a.D);
  const long long r = i / a.D;
  const int t = static_cast<int>(r % a.T), bh = static_cast<int>(r / a.T);
  const int b = bh / a.H, h = bh % a.H;
  put(static_cast<T*>(a.dk) + b * a.dks.b + h * a.dks.h + t * a.dks.s + d, sk * a.scale);
  put(static_cast<T*>(a.dv) + b * a.dvs.b + h * a.dvs.h + t * a.dvs.s + d, sv);
}

// the second pass over B·H·T·D entries, counted
template <class T>
int launch_sum(const Args& a, int B, cudaStream_t st, float* ws, int splits) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = (long long)B * a.H * a.T * a.D;
  gctorch_attn_bwd_b4_dkv_sum<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(a, ws, splits, B * a.H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++sum_launches;
  return 0;
}

// ---------------------------------------------------------------- fp32

constexpr int F32_ROWS = WARPS * 16;  // keys a B4 CTA owns, queries a B5 CTA owns (16 a warp)

// the fp32 tiling for head width DT (D ≤ DT, both multiples of 8); its ring
// tiles hold queries (B4) or keys (B5)
template <int DT>
struct F32Tile {
  static constexpr int THREADS = WARPS * 32;
  static constexpr int ROWS = F32_ROWS;
  static constexpr int BN = f32_ring_rows(DT);
  // row pitch in floats: DT + 4 is 4 × an odd number mod 32, so the reads
  // (row g, column tq) and (row 2·tq, column g) of a warp hit 32 banks
  static constexpr int PITCH = DT + 4;
  static constexpr int CHUNKS = DT / 4;  // 16-byte copies a row
  static constexpr int KD = DT / 8;      // k-steps over D of the score products, n-tiles of the gradients
  static constexpr int NB = BN / 8;      // n-tiles of the scores, k-steps of the gradient products
  // the CTA's own rows of two operands, split into TF32 hi and lo once
  // where they fit (their lo parts after both hi parts), else kept as they
  // are and split as their fragments are read
  static constexpr bool PRESPLIT = DT <= 48;
  static constexpr int OWN_LO = 2 * ROWS * PITCH;
  static constexpr int FIXED = (PRESPLIT ? 4 : 2) * ROWS * PITCH;
  // a ring stage: two operands' tiles, split in place into hi when they have
  // landed, their lo parts LO floats on, then lse and delta (B4)
  static constexpr int LO = 2 * BN * PITCH;
  static constexpr int LSE = 2 * LO;
  static constexpr int STAGE = LSE + 2 * BN;
  static constexpr size_t BYTES = (FIXED + 2 * STAGE) * sizeof(float);
};

// x[0, n) split in place into hi, and lo into x[n, 2n)
__device__ __forceinline__ void split_in_place(float* x, int n) {
  for (int e = threadIdx.x; e < n; e += WARPS * 32) {
    const float v = x[e];
    const uint32_t hi = tf32(v);
    x[e] = __uint_as_float(hi);
    x[n + e] = __uint_as_float(tf32(v - __uint_as_float(hi)));
  }
}

// a ring stage that has landed, and with the first the CTA's own rows,
// split into hi and lo; then a barrier
template <int DT>
__device__ __forceinline__ void split_landed(float* fixed, float* stage, bool first) {
  using P = F32Tile<DT>;
  if constexpr (P::PRESPLIT)
    if (first) split_in_place(fixed, 2 * P::ROWS * P::PITCH);
  split_in_place(stage, P::LO);
  __syncthreads();
}

// acc[nd] += a·B over one ring tile (NB k-steps of 8 rows), B the tile's
// rows read with the relabelled k-slots from b = tile + 2·tq·PITCH + g
// (hi, lo LO floats on); each n-tile of D is summed in a fresh accumulator
// and added to acc on the FP32 pipe
template <int DT>
__device__ __forceinline__ void grad_tiles(float (&acc)[F32Tile<DT>::KD][4], const FragA (&a)[F32Tile<DT>::NB],
                                           const float* b) {
  using P = F32Tile<DT>;
#pragma unroll
  for (int nd = 0; nd < P::KD; ++nd) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kq = 0; kq < P::NB; ++kq) mma3(t, a[kq], b + kq * 8 * P::PITCH + nd * 8, P::PITCH, P::LO);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nd][j] += t[j];
  }
}

// B4 in fp32. Grid (key blocks of ROWS, B·H, splits): split z walks query
// tiles [z·tiles, (z + 1)·tiles). With one split it writes dK·scale and dV;
// with more, its unscaled partials go to the workspace `ws` (dK's splits,
// then dV's, each (B·H, T, D)) for gctorch_attn_bwd_b4_dkv_sum.
template <int DT>
__global__ void __launch_bounds__(WARPS * 32, 1) gctorch_attn_bwd_b4_dkv_f32(Args a, float* ws, int tiles) {
  using P = F32Tile<DT>;
  constexpr int BN = P::BN, PITCH = P::PITCH, KD = P::KD, NB = P::NB;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;
  float* Vs = fsm + P::ROWS * PITCH;
  float* ring = fsm + P::FIXED;  // a stage: Q, dO [BN][PITCH] (hi, then lo), lse [BN], delta [BN]

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int key0 = blockIdx.x * P::ROWS;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* dob = static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const float* lse = a.lse + (long long)bh * a.S;
  const float* delta = a.delta + (long long)bh * a.S;
  const int n_q = (a.S + BN - 1) / BN;
  const int t0 = blockIdx.z * tiles, t1 = min(n_q, t0 + tiles);

  stage_f32<P, P::ROWS>(Ks, kb, a.ks.s, key0, a.T, a.D);  // split into hi and lo when they land
  stage_f32<P, P::ROWS>(Vs, vb, a.vs.s, key0, a.T, a.D);
  auto load_tile = [&](int t) {  // one commit group a tile, empty past the split's last
    if (t < t1) {
      float* st = ring + ((t - t0) & 1) * P::STAGE;
      const int q0 = t * BN;
      stage_f32<P, BN>(st, qb, a.qs.s, q0, a.S, a.D);
      stage_f32<P, BN>(st + BN * PITCH, dob, a.dos.s, q0, a.S, a.D);
      for (int r = threadIdx.x; r < BN; r += WARPS * 32) {  // zeros past S: P·dO = 0 and dS = 0 there
        const bool ok = q0 + r < a.S;
        cp_async4(st + P::LSE + r, ok ? lse + q0 + r : lse, ok);
        cp_async4(st + P::LSE + BN + r, ok ? delta + q0 + r : delta, ok);
      }
    }
    cp_commit();
  };
  load_tile(t0);  // K and V land with the first tile

  // this warp's key rows: fragment rows g and g + 8
  const int kl0 = warp * 16 + g, kl1 = kl0 + 8;
  const bool ok0 = key0 + kl0 < a.T, ok1 = key0 + kl1 < a.T;
  float dk[KD][4], dv[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[nd][j] = dv[nd][j] = 0.f;

  for (int t = t0; t < t1; ++t) {
    cp_wait_all();
    __syncthreads();  // tile t has landed for all; every warp is done with tile t − 1
    float* Qt = ring + ((t - t0) & 1) * P::STAGE;
    split_landed<DT>(fsm, Qt, t == t0);
    load_tile(t + 1);
    const float* dOt = Qt + BN * PITCH;
    const float* lse_t = Qt + P::LSE;
    const float* del_t = lse_t + BN;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys × BN queries
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
    // (one product after the other, so that K's and V's fragments are not
    // live together: at D = 160, dK and dV alone hold 160 registers)
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      FragA ka;
      load_a<P>(ka, Ks, kl0, kd * 8 + tq);
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) mma3(s[nt], ka, Qt + (nt * 8 + g) * PITCH + kd * 8 + tq, 4, P::LO);
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      FragA va;
      load_a<P>(va, Vs, kl0, kd * 8 + tq);
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) mma3(dp[nt], va, dOt + (nt * 8 + g) * PITCH + kd * 8 + tq, 4, P::LO);
    }

    // Pᵀ and dSᵀ in place of the scores: C element j of n-tile nt is query
    // nt·8 + 2·tq + (j & 1), key row kl0 for j < 2 and kl1 above
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = nt * 8 + 2 * tq + j;
        const float nl = -lse_t[qc] * LOG2E, del = del_t[qc];
        const float p0 = ok0 ? ex2(fmaf(s[nt][j], a.scale_log2, nl)) : 0.f;
        const float p1 = ok1 ? ex2(fmaf(s[nt][2 + j], a.scale_log2, nl)) : 0.f;
        s[nt][j] = p0;
        s[nt][2 + j] = p1;
        dp[nt][j] = p0 * (dp[nt][j] - del);
        dp[nt][2 + j] = p1 * (dp[nt][2 + j] - del);
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q over the tile's queries, 8 at a time. The C
    // fragment of n-tile kq holds queries 2·tq and 2·tq + 1 of rows g, g + 8;
    // as an A fragment its k-slot tq is query 2·tq and slot tq + 4 query
    // 2·tq + 1, so the B fragments of dO and Q are read with the same labels
    // (b0 from query 2·tq, b1 from 2·tq + 1, column g), row-major.
    // Each n-tile of D is summed over the tile's queries in a fresh
    // accumulator and added to dK, dV on the FP32 pipe (grad_tiles): the
    // tensor cores truncate their fp32 sums, and one chain over 4,096
    // queries put dK 2.93e-5 (relative L2) off autograd at (4, 8, 4096, 77,
    // 40), against a limit of 1e-5 (tests/test_torch_kernels.py, NVIDIA H100
    // 80GB HBM3, 700 W). dV first, then dK.
    FragA fa[NB];
#pragma unroll
    for (int kq = 0; kq < NB; ++kq) split_a(fa[kq], s[kq][0], s[kq][2], s[kq][1], s[kq][3]);
    grad_tiles<DT>(dv, fa, dOt + 2 * tq * PITCH + g);
#pragma unroll
    for (int kq = 0; kq < NB; ++kq) split_a(fa[kq], dp[kq][0], dp[kq][2], dp[kq][1], dp[kq][3]);
    grad_tiles<DT>(dk, fa, Qt + 2 * tq * PITCH + g);
  }
  cp_wait_all();  // a split with no tile still has K's and V's copies in flight

  const float sk = ws == nullptr ? a.scale : 1.f;
  float *dkb, *dvb;
  long long dk_row, dv_row;
  if (ws == nullptr) {
    dkb = static_cast<float*>(a.dk) + b * a.dks.b + h * a.dks.h;
    dvb = static_cast<float*>(a.dv) + b * a.dvs.b + h * a.dvs.h;
    dk_row = a.dks.s;
    dv_row = a.dvs.s;
  } else {
    const long long n = (long long)gridDim.y * a.T * a.D;
    dkb = ws + blockIdx.z * n + (long long)bh * a.T * a.D;
    dvb = dkb + gridDim.z * n;
    dk_row = dv_row = a.D;
  }
#pragma unroll
  for (int nd = 0; nd < KD; ++nd) {
    const int c = nd * 8 + tq * 2;
    if (c >= a.D) continue;
    if (ok0) {
      const long long r = key0 + kl0;
      *reinterpret_cast<float2*>(dkb + r * dk_row + c) = make_float2(dk[nd][0] * sk, dk[nd][1] * sk);
      *reinterpret_cast<float2*>(dvb + r * dv_row + c) = make_float2(dv[nd][0], dv[nd][1]);
    }
    if (ok1) {
      const long long r = key0 + kl1;
      *reinterpret_cast<float2*>(dkb + r * dk_row + c) = make_float2(dk[nd][2] * sk, dk[nd][3] * sk);
      *reinterpret_cast<float2*>(dvb + r * dv_row + c) = make_float2(dv[nd][2], dv[nd][3]);
    }
  }
}

// B5 in fp32: B3's layout, each warp owning 16 query rows; the CTA's Q and
// dO rows stay in shared memory, key tiles of K and V go through the ring
template <int DT>
__global__ void __launch_bounds__(WARPS * 32, 1) gctorch_attn_bwd_b5_dq_f32(Args a) {
  using P = F32Tile<DT>;
  constexpr int BN = P::BN, PITCH = P::PITCH, KD = P::KD, NB = P::NB;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* dOs = fsm + P::ROWS * PITCH;
  float* ring = fsm + P::FIXED;  // a stage: K, V [BN][PITCH] (hi, then lo)

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * P::ROWS;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* dob = static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h;

  stage_f32<P, P::ROWS>(Qs, qb, a.qs.s, row0, a.S, a.D);
  stage_f32<P, P::ROWS>(dOs, dob, a.dos.s, row0, a.S, a.D);
  const int n_k = (a.T + BN - 1) / BN;
  auto load_tile = [&](int t) {  // one commit group a tile, empty past the last
    if (t < n_k) {
      float* st = ring + (t & 1) * P::STAGE;
      stage_f32<P, BN>(st, kb, a.ks.s, t * BN, a.T, a.D);
      stage_f32<P, BN>(st + BN * PITCH, vb, a.vs.s, t * BN, a.T, a.D);
    }
    cp_commit();
  };
  load_tile(0);  // Q and dO land with the first tile

  // this warp's query rows r0 (fragment row g) and r1 = r0 + 8; rows past S
  // run on zeros (P finite, dS = 0) and store nothing
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const bool in0 = row0 + r0 < a.S, in1 = row0 + r1 < a.S;
  const float* lse = a.lse + (long long)bh * a.S + row0;
  const float* delta = a.delta + (long long)bh * a.S + row0;
  const float nl0 = in0 ? -lse[r0] * LOG2E : 0.f, nl1 = in1 ? -lse[r1] * LOG2E : 0.f;
  const float del0 = in0 ? delta[r0] : 0.f, del1 = in1 ? delta[r1] : 0.f;

  float dq[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  for (int t = 0; t < n_k; ++t) {
    cp_wait_all();
    __syncthreads();  // tile t has landed for all; every warp is done with tile t − 1
    float* Kt = ring + (t & 1) * P::STAGE;
    split_landed<DT>(fsm, Kt, t == 0);
    load_tile(t + 1);
    const float* Vt = Kt + BN * PITCH;

    // S = Q·Kᵀ and dP = dO·Vᵀ for the warp's 16 queries × BN keys
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = kd * 8 + tq;
      FragA qa, oa;
      load_a<P>(qa, Qs, r0, c);
      load_a<P>(oa, dOs, r0, c);
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        mma3(s[nt], qa, Kt + (nt * 8 + g) * PITCH + c, 4, P::LO);
        mma3(dp[nt], oa, Vt + (nt * 8 + g) * PITCH + c, 4, P::LO);
      }
    }

    // dS in place of dP; keys past T (zero rows of K, in the last tile) get P = 0
    const int k0 = t * BN;
    const bool ragged = k0 + BN > a.T;
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p0 = ex2(fmaf(s[nt][j], a.scale_log2, nl0));
        float p1 = ex2(fmaf(s[nt][2 + j], a.scale_log2, nl1));
        if (ragged && k0 + nt * 8 + 2 * tq + j >= a.T) p0 = p1 = 0.f;
        dp[nt][j] = p0 * (dp[nt][j] - del0);
        dp[nt][2 + j] = p1 * (dp[nt][2 + j] - del1);
      }

    // dQ += dS·K over the tile's keys, 8 at a time, with B4's relabelled
    // k-slots (slot tq is key 2·tq, slot tq + 4 key 2·tq + 1): K row-major
    FragA da[NB];
#pragma unroll
    for (int kq = 0; kq < NB; ++kq) split_a(da[kq], dp[kq][0], dp[kq][2], dp[kq][1], dp[kq][3]);
    grad_tiles<DT>(dq, da, Kt + 2 * tq * PITCH + g);
  }
  cp_wait_all();

  float* dqb = static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int nd = 0; nd < KD; ++nd) {
    const int c = nd * 8 + tq * 2;
    if (c >= a.D) continue;
    if (in0)
      *reinterpret_cast<float2*>(dqb + (long long)(row0 + r0) * a.dqs.s + c) =
          make_float2(dq[nd][0] * a.scale, dq[nd][1] * a.scale);
    if (in1)
      *reinterpret_cast<float2*>(dqb + (long long)(row0 + r1) * a.dqs.s + c) =
          make_float2(dq[nd][2] * a.scale, dq[nd][3] * a.scale);
  }
}

template <int DT>
int launch_bf16(int which, const Args& a, int B, cudaStream_t st, float* ws, int splits) {
  using P = Bf16Tile<DT>;
  const int bytes = static_cast<int>(P::BYTES);
  cudaError_t e;
  if (which == 0) {
    e = cudaFuncSetAttribute(gctorch_attn_bwd_b4_dkv_bf16<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n_q = (a.S + P::BN - 1) / P::BN;
    const int tiles = (n_q + splits - 1) / splits;  // query tiles a split; a split past the last has none
    gctorch_attn_bwd_b4_dkv_bf16<DT><<<dim3((a.T + P::ROWS - 1) / P::ROWS, B * a.H, splits), WARPS * 32, bytes, st>>>(
        a, splits > 1 ? ws : nullptr, tiles);
    if (splits > 1) return launch_sum<__nv_bfloat16>(a, B, st, ws, splits);
  } else {
    e = cudaFuncSetAttribute(gctorch_attn_bwd_b5_dq_bf16<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    gctorch_attn_bwd_b5_dq_bf16<DT><<<dim3((a.S + P::ROWS - 1) / P::ROWS, B * a.H), WARPS * 32, bytes, st>>>(a);
  }
  return 0;
}
template <int DT>
int launch_f32(int which, const Args& a, int B, cudaStream_t st, float* ws, int splits) {
  using P = F32Tile<DT>;
  const int bytes = static_cast<int>(P::BYTES);
  cudaError_t e;
  if (which == 0) {
    e = cudaFuncSetAttribute(gctorch_attn_bwd_b4_dkv_f32<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n_q = (a.S + P::BN - 1) / P::BN;
    const int tiles = (n_q + splits - 1) / splits;  // query tiles a split; a split past the last has none
    gctorch_attn_bwd_b4_dkv_f32<DT><<<dim3((a.T + P::ROWS - 1) / P::ROWS, B * a.H, splits), WARPS * 32, bytes, st>>>(
        a, splits > 1 ? ws : nullptr, tiles);
    if (splits > 1) return launch_sum<float>(a, B, st, ws, splits);
  } else {
    e = cudaFuncSetAttribute(gctorch_attn_bwd_b5_dq_f32<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    gctorch_attn_bwd_b5_dq_f32<DT><<<dim3((a.S + P::ROWS - 1) / P::ROWS, B * a.H), WARPS * 32, bytes, st>>>(a);
  }
  return 0;
}

}  // namespace

// Over how many CTAs B4 splits each key block's queries, for a card of
// `sms` SMs: 1 where its ceil(T / rows) · B · H CTAs already give two an SM
// (rows: the keys a CTA owns, 64 in fp32, bf16_own_rows in bf16), else
// enough to reach that, at most one split per 64 queries in fp32 and per 256
// in bf16, and no more than leaves each split a ring tile. A bf16 split's
// queries cost little beside its own rows' load and the round trip of its
// fp32 partials: split 3 ways (86 queries each) at (4, 8, 256, 256, 160) B4
// was slower than unsplit; split 8 ways (512 each) at (4, 8, 4096, 77, 40),
// 0.026 ms against 0.107 unsplit (chip_smoke.py --attention, NVIDIA
// H100 80GB HBM3, 700 W). The caller sizes the workspace of
// gctorch_flash_attn_bwd from it.
extern "C" int gctorch_flash_attn_bwd_dkv_splits(int B, int H, int S, int T, int D, int is_bf16, int sms) {
  const int rows = is_bf16 ? bf16_own_rows(D) : F32_ROWS, ring = is_bf16 ? bf16_ring_rows(D) : f32_ring_rows(D);
  const long long ctas = (long long)((T + rows - 1) / rows) * B * H;
  const long long want = (long long)DKV_CTAS_PER_SM * sms;
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0 || D <= 0 || ctas >= want) return 1;
  const int per_split = is_bf16 ? 256 : 64;
  const long long most = (S + per_split - 1) / per_split;
  const int splits = static_cast<int>((want + ctas - 1) / ctas < most ? (want + ctas - 1) / ctas : most);
  const int n_q = (S + ring - 1) / ring;
  const int tiles = (n_q + splits - 1) / splits;
  return (n_q + tiles - 1) / tiles;
}

// Launches of B4's second pass, which sums the splits' partials, since the
// library was loaded.
extern "C" long long gctorch_flash_attn_bwd_sum_launches() { return sum_launches; }

// which: 0 launches B4 (writes dk, dv), 1 launches B5 (writes dq).
// q, dout, dq (B, H, S, D); k, v, dk, dv (B, H, T, D): each given by its
// pointer and its batch, head and sequence strides in elements (D
// contiguous; fp32 rows start on 16-byte boundaries). lse and delta: fp32
// (B, H, S) contiguous. is_bf16: 1 for bf16, 0 for fp32. splits (fp32 B4
// only, else 1; gctorch_flash_attn_bwd_dkv_splits gives the rule's): the
// number of CTAs that share a key block's queries; with more than 1,
// workspace holds 2 · splits · B · H · T · D floats for their partial
// sums. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a shape it does not take).
extern "C" int gctorch_flash_attn_bwd(int which, const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta, void* dq,
                                      void* dk, void* dv, int B, int H, int S, int T, int D, int is_bf16,
                                      long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                                      long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                      long long v_ss, long long do_sb, long long do_sh, long long do_ss,
                                      long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
                                      long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
                                      long long dv_ss, float scale, void* stream, void* workspace,
                                      int splits) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0 || D <= 0 || D % 8 != 0 || D > MAX_D || B * H > 65535 ||
      (which != 0 && which != 1) || splits < 1 || splits > 65535 ||
      (splits > 1 && (which != 0 || workspace == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.H = H;
  a.S = S;
  a.T = T;
  a.D = D;
  a.qs = Strides{q_sb, q_sh, q_ss};
  a.ks = Strides{k_sb, k_sh, k_ss};
  a.vs = Strides{v_sb, v_sh, v_ss};
  a.dos = Strides{do_sb, do_sh, do_ss};
  a.dqs = Strides{dq_sb, dq_sh, dq_ss};
  a.dks = Strides{dk_sb, dk_sh, dk_ss};
  a.dvs = Strides{dv_sb, dv_sh, dv_ss};
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  int err = 0;
  if (is_bf16) {
    switch (D <= 16 ? 0 : D <= 32 ? 1 : D <= 40 ? 2 : D <= 48 ? 3 : D <= 64 ? 4 : D <= 80 ? 5 : D <= 96 ? 6
            : D <= 128 ? 7 : 8) {
      case 0: err = launch_bf16<16>(which, a, B, st, ws, splits); break;
      case 1: err = launch_bf16<32>(which, a, B, st, ws, splits); break;
      case 2: err = launch_bf16<40>(which, a, B, st, ws, splits); break;
      case 3: err = launch_bf16<48>(which, a, B, st, ws, splits); break;
      case 4: err = launch_bf16<64>(which, a, B, st, ws, splits); break;
      case 5: err = launch_bf16<80>(which, a, B, st, ws, splits); break;
      case 6: err = launch_bf16<96>(which, a, B, st, ws, splits); break;
      case 7: err = launch_bf16<128>(which, a, B, st, ws, splits); break;
      default: err = launch_bf16<160>(which, a, B, st, ws, splits); break;
    }
  } else {
    switch (D <= 48 ? D / 8 : D <= 64 ? 7 : D <= 80 ? 8 : D <= 96 ? 9 : D <= 128 ? 10 : 11) {
      case 1: err = launch_f32<8>(which, a, B, st, ws, splits); break;
      case 2: err = launch_f32<16>(which, a, B, st, ws, splits); break;
      case 3: err = launch_f32<24>(which, a, B, st, ws, splits); break;
      case 4: err = launch_f32<32>(which, a, B, st, ws, splits); break;
      case 5: err = launch_f32<40>(which, a, B, st, ws, splits); break;
      case 6: err = launch_f32<48>(which, a, B, st, ws, splits); break;
      case 7: err = launch_f32<64>(which, a, B, st, ws, splits); break;
      case 8: err = launch_f32<80>(which, a, B, st, ws, splits); break;
      case 9: err = launch_f32<96>(which, a, B, st, ws, splits); break;
      case 10: err = launch_f32<128>(which, a, B, st, ws, splits); break;
      default: err = launch_f32<160>(which, a, B, st, ws, splits); break;
    }
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
