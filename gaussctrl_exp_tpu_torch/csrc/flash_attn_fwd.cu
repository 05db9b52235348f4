// Kernel B3: flash-attention forward for Hopper (sm_90a).
//
// Replaces gaussctrl_exp_tpu/diffusion/attention.py:37 `_flash_sdpa`, which
// runs the library TPU flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention) with head_dim padded to
// the TPU's 128 lanes. It computes, for (B, H, S, D) queries and (B, H, T, D)
// keys and values, the non-causal O = softmax(Q·Kᵀ·D^-½)·V with an fp32
// softmax; the scale uses the true D. Every `_sdpa` call of the port on a CUDA
// tensor comes here: the UNet's and the ControlNet's self-attention
// (S = T = 64², 32², 16², 8² latents), their cross-attention to the 77 text
// tokens, and the four reference-view calls of the cross-view processor.
//
// What bounds it. At the edit path's main shape, (18, 8, 4096, 4096, 40) in
// bf16, the two products are 4·B·H·S·T·D = 3.87e11 operations, 0.391 ms at
// the tensor cores' 989 TFLOP/s, on only 0.056 ms of bytes. But the online
// softmax takes one exponential per score, B·H·S·T = 2.42e9, and the
// special-function unit does 16 `ex2` per SM per clock: 0.625 ms at 132 SMs
// and 1.83 GHz. At D = 40 the exponentials, not the tensor cores, set the
// pace (at D = 80 the products do: 0.049 ms against 0.039 ms at 32²). So the
// design spends one `ex2` and one fused multiply-add per score and nothing
// else on the special-function unit, and halves the L2 → SM traffic of K and
// V against 64-row CTAs.
//
// Design, bf16 (mma.sync.m16n8k16 on the tensor cores, fp32 accumulators):
//  * Tiles: 4 warps a CTA. At D ≤ 80 each warp owns 32 query rows (two
//    16-row mma blocks, 128 rows a CTA), so that each K and V fragment read
//    from shared memory feeds two products and each K/V tile feeds 128 rows
//    (half the L2 → SM traffic of 64-row CTAs); above 80, 16 rows (64 a CTA),
//    as the registers allow. Widths are rounded up to 16, 32, 40, 48, 64, 80,
//    96, 128 or 160; columns past D are zero-filled.
//  * Q: the 128-row CTAs copy their Q rows into shared memory once and read
//    its A fragments by `ldmatrix` at every key step. Held in registers for
//    the whole loop, Q costs D/2 registers a thread at 32 rows a warp (40 at
//    D = 80), which capped D = 80 at 2 CTAs an SM; read from shared memory,
//    D = 80 fits 3, and D = 40 has room for 64-key tiles. The 64-row CTAs
//    (D ≥ 96) keep Q in registers.
//  * K and V go through a ring of 2 shared-memory stages of 64 keys (D ≤ 40)
//    or 32, filled by `cp.async.cg` 16 bytes a thread (zero-fill past T and
//    past D): tile j + 1's copy is in flight while tile j is computed, one
//    barrier a tile. Rows are stored as they arrive, V too, with a pitch of an
//    odd number of 16-byte chunks (D, or D + 8 where D/8 is even), so the
//    eight row addresses of each `ldmatrix` phase fall in distinct bank
//    groups.
//  * Fragments: Q's by `ldmatrix.x4` (16 rows × 16 dims; `.x2` for a last
//    8), K's by `ldmatrix.x4` (two 8-key n-tiles × 16 dims), V's by
//    `ldmatrix.x4.trans` (16 keys × two 8-dim n-tiles; `.x2` for an odd last
//    one). Q·Kᵀ runs m16n8k16 over the 16-wide steps of D and m16n8k8 over a
//    last 8, so D = 40 is 16 + 16 + 8 with no padding to 48; P·V runs
//    m16n8k16 over 8-dim n-tiles (5 at D = 40). The C fragments of Q·Kᵀ are
//    packed in registers as the A fragments of P·V.
//  * Softmax: the running max m is kept in raw-score units and moves only
//    where a row's max grew by more than 8 in log2 units (a factor 2^8) since
//    it was set, in a warp-uniform branch. Each probability is
//    p = ex2(fma(s, scale·log2 e, −m·scale·log2 e)) ≤ 2^8: one FFMA and one
//    `ex2.approx.ftz.f32` (inline PTX) per score; l and the output are
//    rescaled (one more ex2 per row) only on the rare tile where m moves.
//    Keys past T are set to −inf only in the last, ragged tile, on a path of
//    its own. Max and sum stay in registers (a quad of lanes per row); P is
//    rounded to bf16 for P·V as the reference rounds its probabilities, and l
//    sums the fp32 p.
//  * Registers a thread (ptxas -v for sm_90a; no template spills), by width:
//    16: 128, 32: 160, 40: 168, 48: 128, 64: 156, 80: 168, 96: 128,
//    128: 166, 160: 244. At 168 a 128-thread CTA fits 3 times an SM.
//
// Design, fp32 (the depth generator's forward, and the card's check against
// the CPU): both products as 3×TF32 on mma.sync.m16n8k8 (tf32_mma.cuh: each
// operand split into TF32 hi and lo, a·b = a_lo·b_hi + a_hi·b_lo + a_hi·b_hi).
// At the generator's main shape, (4, 8, 4096, 4096, 40), 4·B·H·S·T·D =
// 8.59e10 operations take 0.521 ms at a third of the TF32 peak (494.7
// TFLOP/s at 1.83 GHz), 1.282 ms at the fp32 FMA peak; the exponentials
// 0.139 ms, the bytes 0.006 ms. So the products, three mma a product, set
// the pace, with the shared-memory reads that feed them.
//  * Tiles: 4 warps a CTA. At D ≤ 48 each warp owns 32 query rows (two
//    16-row mma blocks, 128 a CTA), so that each K and V fragment read from
//    shared memory feeds two products; above, 16 (64 a CTA). The CTA's Q
//    rows are copied into shared memory and split into hi and lo once.
//  * K and V go through a ring of 2 stages of 32 keys (D ≤ 48), 16 (D ≤ 96)
//    or 8, copied by `cp.async` 16 bytes a thread (zero-fill past T and past
//    D), row-major with a pitch of D + 4 floats. Each thread splits the
//    chunks it copied in place (hi, and lo after the tile) once they have
//    landed, so one barrier a tile publishes tile j while tile j + 1's copy
//    is in flight.
//  * Softmax: the bf16 path's, on m16n8k8's C fragments: the running max in
//    raw-score units moved only on 2^8 growth, one FFMA and one
//    `ex2.approx.ftz` a score, max and sum in a quad of lanes, keys past T
//    set to −inf only in the ragged last tile.
//  * P·V: P is split into hi and lo in registers; its k-slots are relabelled
//    (slot tq is key 2·tq, slot tq + 4 key 2·tq + 1), so the C fragments of
//    Q·Kᵀ are P·V's A fragments and V's B fragments are read row-major with
//    the same labels (B5's dS·K). Each ring tile's P·V is summed in a fresh
//    accumulator and added to the output on the FP32 pipe: the tensor cores
//    truncate their fp32 sums.
//  * Registers a thread (ptxas -v for sm_90a, as chip_smoke.py printed them
//    on an NVIDIA H100 80GB HBM3, 700 W; no spills), by width: 8: 100, 16:
//    123, 24: 150, 32: 166, 40: 206, 48: 220, 64: 139, 80: 170, 96: 178,
//    128: 197, 160: 236. CTAs an SM by registers and shared memory (24-123
//    KB a CTA): 4 at D ≤ 16, 3 at 24, 32 and 64, 2 at 40, 48, 80, 96 and
//    128, 1 at 160.
// Queries past S are computed on zeros and not stored. Strides are given for
// batch, head and sequence (D contiguous); rows start on 16-byte boundaries
// (the wrapper checks, and copies what does not), so the head split's
// transpose needs no copy, and the output can be written straight into the
// (B, S, H, D) layout.
//
// When the caller passes an `lse` buffer (fp32, (B, H, S) contiguous), each
// stored query row also gets the log-sum-exp of its scaled scores,
// m·scale + ln(l) in natural-log units: the backward kernels B4 and B5
// (flash_attn_bwd.cu) recompute P = exp(S - lse) from it. The output does not
// depend on whether it is written, and no launch depends on another's order:
// two runs give the same bits.
//
// Kernel B3a: AttnAlign's self-attention in one launch. It replaces no TPU
// kernel: the JAX package's cross-view processor
// (gaussctrl_exp_tpu/diffusion/attention.py `make_cross_view_processor`)
// makes five `_sdpa` calls (the view's own keys, then reference views 0..3
// of its CFG group, broadcast to every view) and combines them,
// coeff·self + (1 − coeff)·mean(refs), in XLA. On the card that was five B3
// launches, eight copies of the references' K and V to every batch entry
// (the broadcast cannot be a view), a stack, a mean and three scalings, each
// rounding to bf16: ~36 outputs' bytes a call outside B3. B3a computes, for
// batch entry b = group·V + view,
//   O = w_self·attn(Q, K_b, V_b) + Σ_r w_ref·attn(Q, K_{group·V + r}, V_{…})
// with one CTA per (query tile, head, batch entry) as B3: Q is staged once
// and read by every pass; each pass runs B3's ring loop (`attend`) over its
// source's K and V read in place through their strides; after each pass
// the CTA adds w·acc/l into an fp32 sum and stores the total once, rounded
// to the input's type, in B3's (B, S, H, D) layout. A reference view's pass
// over its own keys repeats its self pass bit for bit, so it is left out and
// its weight, (1 − coeff)/n_ref, joins the self pass's: per CFG group of 9
// views and 4 references, 41 passes where the composition made 45.
// What bounds it: B3's per pass. At the edit path's main shape, (18, 8, 4096,
// 4096, 40), 82 passes of B·H·S·T/18 exponentials each, 4.5 times B3's, so
// 2.85 ms at 132 SMs and 1.83 GHz; the products 1.78 ms; the bytes of q and
// o once and K, V per pass (they stay in L2) 0.16 ms.
// Design: B3's tiles, per-tile code and arithmetic (bf16 on mma.sync, fp32 as
// 3×TF32), and as many CTAs an SM as B3 at each width. The fp32 sum of the
// passes is each thread's own fragments, kept in dynamic shared memory as
// [element][thread] (conflict-free, no barrier): BQ·D·4 bytes, 20 KB at D =
// 40; the registers are B3's. At D = 80 the sum, Q and a 32-key ring would
// not fit three CTAs an SM, so B3a takes 16-key ring stages there. One
// barrier between passes frees the ring. Coefficient 1 gives B3's output
// bits where the tiles are B3's (every width but bf16 D = 80): the reference
// passes still run, with weight 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int MAX_D = 160;
constexpr float LN2 = 0.6931471805599453f;
constexpr float RESCALE = 8.f;  // log2 growth of a row's max that moves the running max

struct Strides {
  long long b, h, s;
};

// the bf16 tiling for head width DT (D ≤ DT, both multiples of 8), with BKEYS
// keys a ring stage
template <int DT, int BKEYS = (DT <= 40 ? 64 : 32)>
struct Tile {
  static constexpr int WARPS = 4;
  static constexpr int MT = DT <= 80 ? 2 : 1;            // 16-row mma blocks per warp
  static constexpr int BQ = WARPS * 16 * MT;             // query rows per CTA
  static constexpr int BK = BKEYS;                       // keys per ring stage
  static constexpr int STAGES = 2;
  static constexpr bool QS = MT == 2;                    // Q in shared memory, not registers
  static constexpr int PITCH = (DT / 8) % 2 ? DT : DT + 8;  // smem row pitch (elements)
  static constexpr int K16 = DT / 16;                    // 16-wide steps of Q·Kᵀ over D
  static constexpr bool K8 = DT % 16 != 0;               // and a last 8-wide one
  static constexpr int NT = DT / 8;                      // 8-wide n-tiles of P·V over D, 16-byte chunks a row
};

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

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbouring bf16 of row r, columns c and c + 1 (c even, D a multiple of 8)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, long long row_stride, int r,
                                              int c, int rows, int D) {
  if (r >= rows || c >= D) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (long long)r * row_stride + c);
}

template <class P>
using QFrag = uint32_t[P::MT][P::K16][4];  // Q's A fragments
template <class P>
using SFrag = float[P::MT][P::BK / 8][4];  // a tile's scores (C fragments)
template <class P>
using PFrag = uint32_t[P::MT][P::BK / 16][4];  // its probabilities (A fragments)
template <class P>
using OFrag = float[P::MT][P::NT][4];  // the output accumulators

// s = Q·Kᵀ of this warp's MT·16 query rows against the BK keys of tile Ks
template <class P>
__device__ __forceinline__ void scores(const uint16_t* __restrict__ Ks, int lane, const QFrag<P>& q_regs,
                                       const uint16_t* __restrict__ qrow, SFrag<P>& s) {
  constexpr int MT = P::MT, BK = P::BK, PITCH = P::PITCH;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[i][nt][0] = s[i][nt][1] = s[i][nt][2] = s[i][nt][3] = 0.f;
  // ldmatrix.x4 block b = lane / 8 holds keys + (b / 2)·8, dims + (b % 2)·8
  const uint16_t* krow = Ks + ((lane >> 4) * 8 + (lane & 7)) * PITCH + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < P::K16; ++kk) {
    uint32_t qa[MT][4];  // Q's A fragments for this step: kept in registers, or read from Qs
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if constexpr (P::QS) {
        ldsm_x4(qa[i], qrow + 16 * i * PITCH + kk * 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[i][e] = q_regs[i][kk][e];
      }
    }
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, krow + np * 16 * PITCH + kk * 16);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma16(s[i][2 * np], qa[i], b[0], b[1]);
        mma16(s[i][2 * np + 1], qa[i], b[2], b[3]);
      }
    }
  }
  if constexpr (P::K8) {  // the last 8 dims (D = 40: Q in shared memory): block b holds keys + b·8
    static_assert(P::QS, "the 8-wide step reads Q's fragments from shared memory");
    const uint16_t* ktail = Ks + ((lane >> 3) * 8 + (lane & 7)) * PITCH + P::K16 * 16;
#pragma unroll
    for (int nq = 0; nq < BK / 32; ++nq) {
      uint32_t b[4];
      ldsm_x4(b, ktail + nq * 32 * PITCH);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[2];  // lanes 0-15 give rows 0-15 at the last 8 columns
        ldsm_x2(a, qrow - (lane >> 4) * 8 + 16 * i * PITCH + P::K16 * 16);
#pragma unroll
        for (int t = 0; t < 4; ++t) mma8(s[i][4 * nq + t], a, b[t]);
      }
    }
  }
}

// The online-softmax update for one tile of scores s (keys k0 .. k0 + BK):
// the new running max m (raw-score units), the rescale of l and acc, and the
// probabilities as P·V's A fragments. MASK: the tile holds keys past T (the
// last, ragged one).
template <class P, bool MASK>
__device__ __forceinline__ void softmax(SFrag<P>& s, int k0, int T, int lane, float sl2, OFrag<P>& acc,
                                        float (&m)[P::MT][2], float (&l)[P::MT][2], PFrag<P>& pa) {
  constexpr int MT = P::MT, BK = P::BK, NT = P::NT;
  if constexpr (MASK) {
    const int tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (k0 + nt * 8 + tq * 2 + j >= T)
#pragma unroll
          for (int i = 0; i < MT; ++i) s[i][nt][j] = s[i][nt][2 + j] = -INFINITY;
  }
  // the tile's row maxima; the running max m moves only where a row's max
  // grew by more than RESCALE (log2 units) since m was set: below that every
  // probability ex2(s·scale·log2 e − m·scale·log2 e) stays under 2^RESCALE,
  // and l and acc, taken against the same m, give the same softmax
  float mx[MT][2];
  bool grow = false;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(s[i][0][2 * r], s[i][0][2 * r + 1]);
#pragma unroll
      for (int nt = 1; nt < BK / 8; ++nt) x = fmaxf(x, fmaxf(s[i][nt][2 * r], s[i][nt][2 * r + 1]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      mx[i][r] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      grow |= (mx[i][r] - m[i][r]) * sl2 > RESCALE;  // the first tile: m = −inf
    }
  }
  if (__any_sync(0xffffffffu, grow)) {  // warp-uniform: rescale every row of the warp to its max
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // key k0 < T lies in every tile, so the new max is finite; the first
        // tile's rescale is ex2(−inf) = 0 of l = acc = 0
        const float mn = fmaxf(m[i][r], mx[i][r]), c = ex2((m[i][r] - mn) * sl2);
        m[i][r] = mn;
        l[i][r] *= c;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[i][nt][2 * r] *= c;
          acc[i][nt][2 * r + 1] *= c;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float n0 = -m[i][0] * sl2, n1 = -m[i][1] * sl2;
    // the C fragments of Q·Kᵀ are the A fragments of P·V
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p00 = ex2(fmaf(s[i][nt][0], sl2, n0)), p01 = ex2(fmaf(s[i][nt][1], sl2, n0));
      const float p10 = ex2(fmaf(s[i][nt][2], sl2, n1)), p11 = ex2(fmaf(s[i][nt][3], sl2, n1));
      l[i][0] += p00 + p01;
      l[i][1] += p10 + p11;
      pa[i][nt >> 1][(nt & 1) * 2] = pack_bf16(p00, p01);
      pa[i][nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
  }
}

// acc += P·V over the BK keys of tile Vs
template <class P>
__device__ __forceinline__ void accumulate(const uint16_t* __restrict__ Vs, int lane, const PFrag<P>& pa,
                                           OFrag<P>& acc) {
  constexpr int MT = P::MT, BK = P::BK, PITCH = P::PITCH, NT = P::NT;
  // ldmatrix.x4.trans block b holds keys + (b % 2)·8, dims + (b / 2)·8
  const uint16_t* vrow = Vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * PITCH + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, vrow + kk * 16 * PITCH + dp * 16);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma16(acc[i][2 * dp], pa[i][kk], b[0], b[1]);
        mma16(acc[i][2 * dp + 1], pa[i][kk], b[2], b[3]);
      }
    }
    if constexpr (NT % 2) {
      uint32_t b[2];
      ldsm_x2_t(b, vrow - (lane >> 4) * 8 + kk * 16 * PITCH + (NT - 1) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma16(acc[i][NT - 1], pa[i][kk], b[0], b[1]);
    }
  }
}

// The CTA's Q rows, where the tiling keeps Q: their copies into Qs issued
// and not committed (they land with the first ring tile), or this warp's A
// fragments in qa. r0: the warp's first row.
template <class P>
__device__ __forceinline__ void stage_q(const __nv_bfloat16* __restrict__ qb, long long q_ss, int S, int D,
                                        int r0, int lane, uint16_t* Qs, QFrag<P>& qa) {
  constexpr int MT = P::MT, PITCH = P::PITCH, THREADS = P::WARPS * 32, CHUNKS = P::NT;
  const int g = lane >> 2, tq = lane & 3;
  if constexpr (P::QS) {  // the CTA's Q rows into Qs
#pragma unroll
    for (int e0 = 0; e0 < P::BQ * CHUNKS; e0 += THREADS) {
      const int e = e0 + threadIdx.x;
      if (P::BQ * CHUNKS % THREADS == 0 || e < P::BQ * CHUNKS) {
        const int r = e / CHUNKS, c = (e % CHUNKS) * 8, row = blockIdx.x * P::BQ + r;
        const bool ok = row < S && c < D;
        cp_async16(&Qs[r * PITCH + c], ok ? qb + row * q_ss + c : qb, ok);
      }
    }
  } else {  // as A fragments in registers
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int ra = r0 + 16 * i + g, rb = ra + 8;
#pragma unroll
      for (int kk = 0; kk < P::K16; ++kk) {
        const int c0 = kk * 16 + tq * 2, c1 = c0 + 8;
        qa[i][kk][0] = load_pair(qb, q_ss, ra, c0, S, D);
        qa[i][kk][1] = load_pair(qb, q_ss, rb, c0, S, D);
        qa[i][kk][2] = load_pair(qb, q_ss, ra, c1, S, D);
        qa[i][kk][3] = load_pair(qb, q_ss, rb, c1, S, D);
      }
    }
  }
}

// One pass of the K/V ring over the T keys at kb and vb: the output
// accumulators, running max and sums of this warp's rows against them,
// from zero. Q is staged (stage_q) before the first pass.
template <class P>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ kb, const __nv_bfloat16* __restrict__ vb,
                                       long long k_ss, long long v_ss, int T, int D, float sl2, int lane,
                                       uint16_t (&Ks)[P::STAGES][P::BK * P::PITCH],
                                       uint16_t (&Vs)[P::STAGES][P::BK * P::PITCH], const QFrag<P>& qa,
                                       const uint16_t* qrow, OFrag<P>& acc, float (&m)[P::MT][2],
                                       float (&l)[P::MT][2]) {
  constexpr int MT = P::MT, BK = P::BK, PITCH = P::PITCH, NT = P::NT, STAGES = P::STAGES;
  constexpr int THREADS = P::WARPS * 32, CHUNKS = P::NT;
  static_assert(BK % (P::K8 ? 32 : 16) == 0, "Q·Kᵀ takes keys 16 at a time, its last 8 dims 32 at a time");
  const int n_tiles = (T + BK - 1) / BK;
  auto load_tile = [&](int tile) {  // one commit group per tile, empty past the last
    if (tile < n_tiles) {
      const int k0 = tile * BK, st = tile % STAGES;
#pragma unroll
      for (int e0 = 0; e0 < BK * CHUNKS; e0 += THREADS) {
        const int e = e0 + threadIdx.x;
        if (BK * CHUNKS % THREADS == 0 || e < BK * CHUNKS) {
          const int r = e / CHUNKS, c = (e % CHUNKS) * 8, key = k0 + r;
          const bool ok = key < T && c < D;
          cp_async16(&Ks[st][r * PITCH + c], ok ? kb + key * k_ss + c : kb, ok);
          cp_async16(&Vs[st][r * PITCH + c], ok ? vb + key * v_ss + c : vb, ok);
        }
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] = 0.f;
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
  }

  // Tile j + 1's copy is in flight while tile j is computed. Every tile before
  // the last is full; the last may be ragged and is finished after the loop.
  SFrag<P> s;
  PFrag<P> pa;
  for (int j = 0; j + 1 < n_tiles; ++j) {
    cp_wait<STAGES - 2>();  // tile j has landed for this thread ...
    __syncthreads();        // ... and for all; every warp is done with tile j − 1
    load_tile(j + STAGES - 1);
    scores<P>(Ks[j % STAGES], lane, qa, qrow, s);
    softmax<P, false>(s, j * BK, T, lane, sl2, acc, m, l, pa);
    accumulate<P>(Vs[j % STAGES], lane, pa, acc);
  }
  cp_wait<0>();
  __syncthreads();
  scores<P>(Ks[(n_tiles - 1) % STAGES], lane, qa, qrow, s);
  const int last = n_tiles - 1;
  if (T % BK)
    softmax<P, true>(s, last * BK, T, lane, sl2, acc, m, l, pa);
  else
    softmax<P, false>(s, last * BK, T, lane, sl2, acc, m, l, pa);
  accumulate<P>(Vs[last % STAGES], lane, pa, acc);
}

// the sum of a row's share of l over the quad of lanes that holds the row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DT>
__global__ void __launch_bounds__(Tile<DT>::WARPS * 32)
    gctorch_attn_fwd_b3_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, int H, int S, int T, int D, Strides qs, Strides ks,
                             Strides vs, Strides os, float sl2) {
  using P = Tile<DT>;
  constexpr int MT = P::MT, BK = P::BK, PITCH = P::PITCH, NT = P::NT, STAGES = P::STAGES;
  __shared__ __align__(128) uint16_t Ks[STAGES][BK * PITCH];
  __shared__ __align__(128) uint16_t Vs[STAGES][BK * PITCH];
  __shared__ __align__(128) uint16_t Qs[P::QS ? P::BQ * PITCH : 8];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row group and column pair
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  // this warp's query rows: block i covers rows r0 + 16·i + {g, g + 8}
  const int r0 = blockIdx.x * P::BQ + warp * 16 * MT;
  QFrag<P> qa;
  stage_q<P>(qb, qs.s, S, D, r0, lane, Qs, qa);
  // ldmatrix.x4 of Q: lanes 0-15 give rows 0-15 at column 0, lanes 16-31 at column 8
  const uint16_t* qrow = Qs + (warp * 16 * MT + (lane & 15)) * PITCH + (lane >> 4) * 8;

  OFrag<P> acc;
  float m[MT][2], l[MT][2];  // running max (raw scores) and this thread's share of the sums
  attend<P>(k + b * ks.b + h * ks.h, v + b * vs.b + h * vs.h, ks.s, vs.s, T, D, sl2, lane, Ks, Vs, qa, qrow, acc,
            m, l);

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float l0 = quad_sum(l[i][0]), l1 = quad_sum(l[i][1]);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int ra = r0 + 16 * i + g, rb = ra + 8;
    if (lse != nullptr && tq == 0) {  // m·scale + ln l = (m·scale·log2 e + log2 l)·ln 2
      if (ra < S) lse[(long long)blockIdx.y * S + ra] = (m[i][0] * sl2 + log2f(l0)) * LN2;
      if (rb < S) lse[(long long)blockIdx.y * S + rb] = (m[i][1] * sl2 + log2f(l1)) * LN2;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + tq * 2;
      if (c >= D) continue;
      if (ra < S)
        *reinterpret_cast<uint32_t*>(ob + (long long)ra * os.s + c) =
            pack_bf16(acc[i][nt][0] * inv0, acc[i][nt][1] * inv0);
      if (rb < S)
        *reinterpret_cast<uint32_t*>(ob + (long long)rb * os.s + c) =
            pack_bf16(acc[i][nt][2] * inv1, acc[i][nt][3] * inv1);
    }
  }
}

// ------------------------------------------------------- B3a, AttnAlign

// AttnAlign's weights, fp32: the view's own pass (coeff), its own pass where
// the view is a reference too (coeff + (1 − coeff)/n_ref, the duplicate
// reference pass folded in), and each other reference's ((1 − coeff)/n_ref)
struct Weights {
  float self, dup, ref;
};

// B3a's sources: pass 0 is the view itself; pass p > 0 is reference view
// r of its group, the references 0 .. n_ref − 1 in order but the view's own
__device__ __forceinline__ int align_source(int p, int b, int V, int view) {
  const int r = p - 1 + (p - 1 >= view);
  return p == 0 ? b : (b - view) + r;
}

// The weighted sum of a CTA's passes in fp32, each thread's own elements:
// x, a pass's acc·w/l, is added to the sum of the passes before it, kept in
// osum as [element][thread] (each warp's accesses in 32 banks), and the sum
// is stored there, or, after the last pass, left in x.
template <int THREADS, int M, int N>
__device__ __forceinline__ void combine(float (&x)[M][N][4], float* __restrict__ osum, bool first, bool last) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* slot = osum + ((i * N + n) * 4 + e) * THREADS + threadIdx.x;
        if (!first) x[i][n][e] = *slot + x[i][n][e];
        if (!last) *slot = x[i][n][e];
      }
}

// B3a's bf16 tiling: B3's, but for D = 80 with 16-key ring stages, so that
// the fp32 sum (BQ·D·4 bytes of dynamic shared memory) fits as many CTAs an
// SM as B3 has: CTAS, by B3's registers (ptxas; the head comment)
template <int DT>
struct AlignTile : Tile<DT, DT == 80 ? 16 : (DT <= 40 ? 64 : 32)> {
  static constexpr int CTAS = DT == 160 ? 2 : (DT == 16 || DT == 48 || DT == 96) ? 4 : 3;
  static constexpr int SUM_BYTES = Tile<DT>::BQ * DT * 4;
};

template <int DT>
__global__ void __launch_bounds__(Tile<DT>::WARPS * 32, AlignTile<DT>::CTAS)
    gctorch_attn_fwd_b3a_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H, int S,
                              int D, int V, int n_ref, Strides qs, Strides ks, Strides vs, Strides os, float sl2,
                              Weights w) {
  using P = AlignTile<DT>;
  constexpr int MT = P::MT, BK = P::BK, PITCH = P::PITCH, NT = P::NT, STAGES = P::STAGES;
  __shared__ __align__(128) uint16_t Ks[STAGES][BK * PITCH];
  __shared__ __align__(128) uint16_t Vs[STAGES][BK * PITCH];
  __shared__ __align__(128) uint16_t Qs[P::QS ? P::BQ * PITCH : 8];
  extern __shared__ __align__(16) float osum[];  // the passes' weighted sum, [MT·NT·4][threads]

  const int b = blockIdx.y / H, h = blockIdx.y % H, view = b % V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  const int r0 = blockIdx.x * P::BQ + warp * 16 * MT;
  QFrag<P> qa;
  stage_q<P>(q + b * qs.b + h * qs.h, qs.s, S, D, r0, lane, Qs, qa);
  const uint16_t* qrow = Qs + (warp * 16 * MT + (lane & 15)) * PITCH + (lane >> 4) * 8;

  OFrag<P> acc;
  float m[MT][2], l[MT][2];
  const int passes = 1 + n_ref - (view < n_ref);
  for (int p = 0; p < passes; ++p) {
    const int src = align_source(p, b, V, view);
    attend<P>(k + src * ks.b + h * ks.h, v + src * vs.b + h * vs.h, ks.s, vs.s, S, D, sl2, lane, Ks, Vs, qa,
              qrow, acc, m, l);
    const float wp = p > 0 ? w.ref : view < n_ref ? w.dup : w.self;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float w0 = wp * (1.f / quad_sum(l[i][0])), w1 = wp * (1.f / quad_sum(l[i][1]));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[i][nt][0] *= w0;
        acc[i][nt][1] *= w0;
        acc[i][nt][2] *= w1;
        acc[i][nt][3] *= w1;
      }
    }
    combine<P::WARPS * 32>(acc, osum, p == 0, p + 1 == passes);
    if (p + 1 < passes) __syncthreads();  // every warp is done with the ring before the next pass fills it
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int ra = r0 + 16 * i + g, rb = ra + 8;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + tq * 2;
      if (c >= D) continue;
      if (ra < S)
        *reinterpret_cast<uint32_t*>(ob + (long long)ra * os.s + c) = pack_bf16(acc[i][nt][0], acc[i][nt][1]);
      if (rb < S)
        *reinterpret_cast<uint32_t*>(ob + (long long)rb * os.s + c) = pack_bf16(acc[i][nt][2], acc[i][nt][3]);
    }
  }
}

// ---------------------------------------------------------------- fp32

// the fp32 tiling for head width DT (D ≤ DT, both multiples of 8): 4 warps
// of MT 16-row mma blocks, and a two-stage ring of K and V tiles
template <int DT>
struct F32Tile {
  static constexpr int WARPS = 4, THREADS = WARPS * 32;
  // 16-row mma blocks a warp: two at D ≤ 48 (128 query rows a CTA), so that
  // each K and V fragment read from shared memory feeds two products
  static constexpr int MT = DT <= 48 ? 2 : 1;
  static constexpr int ROWS = WARPS * 16 * MT;  // query rows a CTA
  static constexpr int BN = f32_ring_rows(DT);   // keys a ring tile
  // row pitch in floats: DT + 4 is 4 × an odd number mod 32, so the reads
  // (row g, column tq) of Q and K and (row 2·tq, column g) of V hit 32 banks
  static constexpr int PITCH = DT + 4;
  static constexpr int CHUNKS = DT / 4;  // 16-byte copies a row
  static constexpr int KD = DT / 8;      // k-steps of Q·Kᵀ over D, n-tiles of P·V
  static constexpr int NB = BN / 8;      // n-tiles of the scores, k-steps of P·V
  // Q is split into TF32 hi and lo once, its lo parts after its hi parts
  static constexpr bool PRESPLIT = true;
  static constexpr int OWN_LO = ROWS * PITCH;
  static constexpr int FIXED = 2 * ROWS * PITCH;
  // a ring stage: K's and V's tiles, split in place into hi when they have
  // landed, their lo parts LO floats on
  static constexpr int LO = 2 * BN * PITCH;
  static constexpr int STAGE = 2 * LO;
  static constexpr size_t BYTES = (FIXED + 2 * STAGE) * sizeof(float);
  // CTAs an SM by shared memory (227 KB, 1 KB a CTA reserved), at most 3:
  // the registers a thread are capped to match
  static constexpr int SMEM_CTAS = 232448 / (BYTES + 1024);
  static constexpr int CTAS = SMEM_CTAS < 3 ? SMEM_CTAS : 3;
};

// this thread's own 16-byte copies of stage_f32<P, N>(dst, ...), landed,
// split into TF32 hi in place and lo `lo` floats on
template <class P, int N>
__device__ __forceinline__ void split_own(float* dst, int lo) {
#pragma unroll
  for (int e0 = 0; e0 < N * P::CHUNKS; e0 += P::THREADS) {
    const int e = e0 + threadIdx.x;
    if (N * P::CHUNKS % P::THREADS == 0 || e < N * P::CHUNKS) {
      float* x = dst + (e / P::CHUNKS) * P::PITCH + (e % P::CHUNKS) * 4;
      const float4 a = *reinterpret_cast<const float4*>(x);
      const float4 hi = make_float4(__uint_as_float(tf32(a.x)), __uint_as_float(tf32(a.y)),
                                    __uint_as_float(tf32(a.z)), __uint_as_float(tf32(a.w)));
      *reinterpret_cast<float4*>(x) = hi;
      *reinterpret_cast<float4*>(x + lo) =
          make_float4(__uint_as_float(tf32(a.x - hi.x)), __uint_as_float(tf32(a.y - hi.y)),
                      __uint_as_float(tf32(a.z - hi.z)), __uint_as_float(tf32(a.w - hi.w)));
    }
  }
}

template <class P>
using F32Acc = float[P::MT][P::KD][4];  // the output accumulators
template <class P>
using F32Scores = float[P::MT][P::NB][4];  // a tile's scores, then probabilities (C fragments)

// B3's online softmax on one ring tile of scores s (keys k0 .. k0 + BN; C
// fragments: rows g and g + 8 of each of the warp's 16-row blocks), replaced
// in place by the probabilities; as the bf16 path's `softmax`: the running
// max m in raw-score units moves only where a row's max grew by more than
// RESCALE, and then l and acc are rescaled. MASK: the tile holds keys past T
// (the last, ragged one).
template <class P, bool MASK>
__device__ __forceinline__ void softmax_f32(F32Scores<P>& s, int k0, int T, int tq, float sl2, F32Acc<P>& acc,
                                            float (&m)[P::MT][2], float (&l)[P::MT][2]) {
  constexpr int MT = P::MT, NB = P::NB;
  if constexpr (MASK) {
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (k0 + nt * 8 + tq * 2 + j >= T)
#pragma unroll
          for (int i = 0; i < MT; ++i) s[i][nt][j] = s[i][nt][2 + j] = -INFINITY;
  }
  float mx[MT][2];
  bool grow = false;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(s[i][0][2 * r], s[i][0][2 * r + 1]);
#pragma unroll
      for (int nt = 1; nt < NB; ++nt) x = fmaxf(x, fmaxf(s[i][nt][2 * r], s[i][nt][2 * r + 1]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      mx[i][r] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      grow |= (mx[i][r] - m[i][r]) * sl2 > RESCALE;  // the first tile: m = −inf
    }
  if (__any_sync(0xffffffffu, grow)) {  // warp-uniform
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // key k0 < T lies in every tile, so the new max is finite; the first
        // tile's rescale is ex2(−inf) = 0 of l = acc = 0
        const float mn = fmaxf(m[i][r], mx[i][r]), c = ex2((m[i][r] - mn) * sl2);
        m[i][r] = mn;
        l[i][r] *= c;
#pragma unroll
        for (int nd = 0; nd < P::KD; ++nd) {
          acc[i][nd][2 * r] *= c;
          acc[i][nd][2 * r + 1] *= c;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float n0 = -m[i][0] * sl2, n1 = -m[i][1] * sl2;
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][nt][j] = ex2(fmaf(s[i][nt][j], sl2, n0));
        s[i][nt][2 + j] = ex2(fmaf(s[i][nt][2 + j], sl2, n1));
        l[i][0] += s[i][nt][j];
        l[i][1] += s[i][nt][2 + j];
      }
  }
}

// One pass of the fp32 ring over the T keys at kb and vb: the output
// accumulators, running max and sums of this warp's rows against them, from
// zero. r0: the warp's first row in the CTA's plus its fragment row g (block
// i covers rows r0 + 16·i and r0 + 16·i + 8; rows past S run on zeros and
// store nothing). Q's copies into Qs (stage_f32, uncommitted: they land with
// tile 0) are split at tile 0 where split_q, in the first pass.
template <class P>
__device__ __forceinline__ void attend_f32(const float* __restrict__ kb, const float* __restrict__ vb,
                                           long long k_ss, long long v_ss, int T, int D, float sl2, int r0,
                                           int lane, float* Qs, float* ring, bool split_q, F32Acc<P>& acc,
                                           float (&m)[P::MT][2], float (&l)[P::MT][2]) {
  constexpr int MT = P::MT, BN = P::BN, PITCH = P::PITCH, KD = P::KD, NB = P::NB;
  const int g = lane >> 2, tq = lane & 3;
  const int n_k = (T + BN - 1) / BN;
  auto load_tile = [&](int t) {  // one commit group a tile, empty past the last
    if (t < n_k) {
      float* st = ring + (t & 1) * P::STAGE;
      stage_f32<P, BN>(st, kb, k_ss, t * BN, T, D);
      stage_f32<P, BN>(st + BN * PITCH, vb, v_ss, t * BN, T, D);
    }
    cp_commit();
  };
  load_tile(0);  // Q lands with the first tile

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) acc[i][nd][0] = acc[i][nd][1] = acc[i][nd][2] = acc[i][nd][3] = 0.f;
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
  }

  // Tile t + 1's copy is in flight while tile t is computed. Each thread
  // splits the chunks it copied itself (visible to it after its wait), so
  // one barrier a tile makes the split tile visible to all and frees the
  // other stage.
  for (int t = 0; t < n_k; ++t) {
    cp_wait_all();
    float* Kt = ring + (t & 1) * P::STAGE;
    split_own<P, BN>(Kt, P::LO);
    split_own<P, BN>(Kt + BN * PITCH, P::LO);
    if (split_q && t == 0) split_own<P, P::ROWS>(Qs, P::OWN_LO);
    __syncthreads();  // tile t is split for all; every warp is done with tile t − 1
    load_tile(t + 1);
    const float* Vt = Kt + BN * PITCH;

    // S = Q·Kᵀ for the warp's MT·16 queries × BN keys: each K fragment read
    // feeds MT products
    F32Scores<P> s;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) s[i][nt][0] = s[i][nt][1] = s[i][nt][2] = s[i][nt][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = kd * 8 + tq;
      FragA qa[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) load_a<P>(qa[i], Qs, r0 + 16 * i, c);
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        const FragB kf = load_b(Kt + (nt * 8 + g) * PITCH + c, 4, P::LO);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma3(s[i][nt], qa[i], kf);
      }
    }
    if (t * BN + BN > T)
      softmax_f32<P, true>(s, t * BN, T, tq, sl2, acc, m, l);
    else
      softmax_f32<P, false>(s, t * BN, T, tq, sl2, acc, m, l);

    // acc += P·V over the tile's keys, 8 at a time, with B5's relabelled
    // k-slots (slot tq is key 2·tq, slot tq + 4 key 2·tq + 1): V row-major,
    // each V fragment read feeding MT products, each n-tile of D summed over
    // the tile in a fresh accumulator and added on the FP32 pipe
    FragA pa[MT][NB];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int kq = 0; kq < NB; ++kq) split_a(pa[i][kq], s[i][kq][0], s[i][kq][2], s[i][kq][1], s[i][kq][3]);
    const float* vrow = Vt + 2 * tq * PITCH + g;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      float u[MT][4] = {};
#pragma unroll
      for (int kq = 0; kq < NB; ++kq) {
        const FragB vf = load_b(vrow + kq * 8 * PITCH + nd * 8, PITCH, P::LO);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma3(u[i], pa[i][kq], vf);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][nd][j] += u[i][j];
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(F32Tile<DT>::THREADS, F32Tile<DT>::CTAS)
    gctorch_attn_fwd_b3_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse, int H, int S, int T, int D,
                            Strides qs, Strides ks, Strides vs, Strides os, float sl2) {
  using P = F32Tile<DT>;
  constexpr int MT = P::MT, KD = P::KD;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                // the CTA's Q rows [ROWS][PITCH] (hi, then lo)
  float* ring = fsm + P::FIXED;  // a stage: K, V [BN][PITCH] (hi, then lo)

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * P::ROWS;
  stage_f32<P, P::ROWS>(Qs, q + b * qs.b + h * qs.h, qs.s, row0, S, D);
  const int r0 = warp * 16 * MT + g;  // this warp's rows: r0 + 16·i and r0 + 16·i + 8 of the CTA's
  F32Acc<P> acc;
  float m[MT][2], l[MT][2];  // running max (raw scores) and this thread's share of the sums
  attend_f32<P>(k + b * ks.b + h * ks.h, v + b * vs.b + h * vs.h, ks.s, vs.s, T, D, sl2, r0, lane, Qs, ring,
                true, acc, m, l);

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float l0 = quad_sum(l[i][0]), l1 = quad_sum(l[i][1]);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int ra = row0 + r0 + 16 * i, rb = ra + 8;
    if (lse != nullptr && tq == 0) {  // m·scale + ln l = (m·scale·log2 e + log2 l)·ln 2
      if (ra < S) lse[(long long)blockIdx.y * S + ra] = (m[i][0] * sl2 + log2f(l0)) * LN2;
      if (rb < S) lse[(long long)blockIdx.y * S + rb] = (m[i][1] * sl2 + log2f(l1)) * LN2;
    }
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      const int c = nd * 8 + tq * 2;
      if (c >= D) continue;
      if (ra < S)
        *reinterpret_cast<float2*>(ob + (long long)ra * os.s + c) =
            make_float2(acc[i][nd][0] * inv0, acc[i][nd][1] * inv0);
      if (rb < S)
        *reinterpret_cast<float2*>(ob + (long long)rb * os.s + c) =
            make_float2(acc[i][nd][2] * inv1, acc[i][nd][3] * inv1);
    }
  }
}

// B3a's fp32 layout: B3's, with the passes' fp32 sum after the ring
// (ROWS·DT·4 bytes); CTAs an SM by shared memory, at most 3
template <int DT>
struct F32AlignTile : F32Tile<DT> {
  static constexpr size_t SUM_BYTES = F32Tile<DT>::ROWS * DT * sizeof(float);
  static constexpr size_t BYTES = F32Tile<DT>::BYTES + SUM_BYTES;
  static constexpr int SMEM_CTAS = 232448 / (BYTES + 1024);
  static constexpr int CTAS = SMEM_CTAS < 3 ? SMEM_CTAS : 3;
};

template <int DT>
__global__ void __launch_bounds__(F32Tile<DT>::THREADS, F32AlignTile<DT>::CTAS)
    gctorch_attn_fwd_b3a_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             float* __restrict__ o, int H, int S, int D, int V, int n_ref, Strides qs, Strides ks,
                             Strides vs, Strides os, float sl2, Weights w) {
  using P = F32Tile<DT>;
  constexpr int MT = P::MT, KD = P::KD;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* ring = fsm + P::FIXED;
  float* osum = ring + 2 * P::STAGE;  // the passes' weighted sum, [MT·KD·4][threads]

  const int b = blockIdx.y / H, h = blockIdx.y % H, view = b % V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * P::ROWS;
  stage_f32<P, P::ROWS>(Qs, q + b * qs.b + h * qs.h, qs.s, row0, S, D);
  const int r0 = warp * 16 * MT + g;
  F32Acc<P> acc;
  float m[MT][2], l[MT][2];
  const int passes = 1 + n_ref - (view < n_ref);
  for (int p = 0; p < passes; ++p) {
    const int src = align_source(p, b, V, view);
    attend_f32<P>(k + src * ks.b + h * ks.h, v + src * vs.b + h * vs.h, ks.s, vs.s, S, D, sl2, r0, lane, Qs,
                  ring, p == 0, acc, m, l);
    const float wp = p > 0 ? w.ref : view < n_ref ? w.dup : w.self;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float w0 = wp * (1.f / quad_sum(l[i][0])), w1 = wp * (1.f / quad_sum(l[i][1]));
#pragma unroll
      for (int nd = 0; nd < KD; ++nd) {
        acc[i][nd][0] *= w0;
        acc[i][nd][1] *= w0;
        acc[i][nd][2] *= w1;
        acc[i][nd][3] *= w1;
      }
    }
    combine<P::THREADS>(acc, osum, p == 0, p + 1 == passes);
    if (p + 1 < passes) __syncthreads();  // every warp is done with the ring before the next pass fills it
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int ra = row0 + r0 + 16 * i, rb = ra + 8;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      const int c = nd * 8 + tq * 2;
      if (c >= D) continue;
      if (ra < S) *reinterpret_cast<float2*>(ob + (long long)ra * os.s + c) = make_float2(acc[i][nd][0], acc[i][nd][1]);
      if (rb < S) *reinterpret_cast<float2*>(ob + (long long)rb * os.s + c) = make_float2(acc[i][nd][2], acc[i][nd][3]);
    }
  }
}

// f(std::integral_constant<int, DT>{}) for the tile width DT that head width
// D rounds up to: bf16 and fp32 have their own widths
template <class F>
cudaError_t bf16_width(int D, F&& f) {
  if (D <= 16) return f(std::integral_constant<int, 16>{});
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  if (D <= 40) return f(std::integral_constant<int, 40>{});
  if (D <= 48) return f(std::integral_constant<int, 48>{});
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  if (D <= 80) return f(std::integral_constant<int, 80>{});
  if (D <= 96) return f(std::integral_constant<int, 96>{});
  if (D <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 160>{});
}

template <class F>
cudaError_t f32_width(int D, F&& f) {
  switch (D <= 48 ? D / 8 : D <= 64 ? 7 : D <= 80 ? 8 : D <= 96 ? 9 : D <= 128 ? 10 : 11) {
    case 1: return f(std::integral_constant<int, 8>{});
    case 2: return f(std::integral_constant<int, 16>{});
    case 3: return f(std::integral_constant<int, 24>{});
    case 4: return f(std::integral_constant<int, 32>{});
    case 5: return f(std::integral_constant<int, 40>{});
    case 6: return f(std::integral_constant<int, 48>{});
    case 7: return f(std::integral_constant<int, 64>{});
    case 8: return f(std::integral_constant<int, 80>{});
    case 9: return f(std::integral_constant<int, 96>{});
    case 10: return f(std::integral_constant<int, 128>{});
    default: return f(std::integral_constant<int, 160>{});
  }
}

// B3a's launch set-up: its dynamic shared memory (the fp32 sum, and for fp32
// the whole layout) allowed past 48 KB, and the carveout set to shared
// memory, so that CTAS of them fit an SM
template <class K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  return e;
}

}  // namespace

// q (B, H, S, D), k and v (B, H, T, D), o (B, H, S, D), each given by its
// pointer and its batch, head and sequence strides in elements (D
// contiguous; bf16 rows 16-byte aligned); lse: null, or fp32 (B, H, S) contiguous for the log-sum-exp.
// is_bf16: 1 for bf16, 0 for fp32. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int gctorch_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse_out, int B,
                                      int H, int S, int T, int D, int is_bf16, long long q_sb,
                                      long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                                      long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                                      long long o_sb, long long o_sh, long long o_ss, float scale,
                                      void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0 || D <= 0 || D % 8 != 0 || D > MAX_D || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const float sl2 = scale * 1.4426950408889634f;  // softmax in base 2: exp(x) = 2^(x·log2 e)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (is_bf16)
    return static_cast<int>(bf16_width(D, [&](auto w) {
      using P = Tile<decltype(w)::value>;
      gctorch_attn_fwd_b3_bf16<decltype(w)::value><<<dim3((S + P::BQ - 1) / P::BQ, B * H), P::WARPS * 32, 0, st>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, S, T, D, qs, ks, vs, os,
          sl2);
      return cudaGetLastError();
    }));
  return static_cast<int>(f32_width(D, [&](auto w) {
    constexpr int DT = decltype(w)::value;
    using P = F32Tile<DT>;
    const int bytes = static_cast<int>(P::BYTES);
    const cudaError_t e =
        cudaFuncSetAttribute(gctorch_attn_fwd_b3_f32<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    gctorch_attn_fwd_b3_f32<DT><<<dim3((S + P::ROWS - 1) / P::ROWS, B * H), P::THREADS, bytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, H, S, T, D, qs, ks, vs, os, sl2);
    return cudaGetLastError();
  }));
}

// Kernel B3a: AttnAlign's self-attention of q, k, v (B, H, S, D) into o, the
// batch laid out as B / V CFG groups of V views whose first n_ref are the
// references; strides and types as gctorch_flash_attn_fwd's. The weights:
// w_self for a view's own pass, w_dup for it where the view is a reference,
// w_ref for each other reference's. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int gctorch_flash_attn_align(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
                                        int D, int V, int n_ref, int is_bf16, long long q_sb, long long q_sh,
                                        long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                                        long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                                        long long o_sh, long long o_ss, float scale, float w_self, float w_dup,
                                        float w_ref, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D % 8 != 0 || D > MAX_D || B * H > 65535 || V <= 0 || B % V != 0 ||
      n_ref < 1 || n_ref > V)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const float sl2 = scale * 1.4426950408889634f;
  const Weights w{w_self, w_dup, w_ref};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(bf16_width(D, [&](auto wd) {
      constexpr int DT = decltype(wd)::value;
      using P = AlignTile<DT>;
      const cudaError_t e = allow_shared(gctorch_attn_fwd_b3a_bf16<DT>, P::SUM_BYTES);
      if (e != cudaSuccess) return e;
      gctorch_attn_fwd_b3a_bf16<DT><<<dim3((S + P::BQ - 1) / P::BQ, B * H), P::WARPS * 32, P::SUM_BYTES, st>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, S, D, V, n_ref, qs, ks, vs, os,
          sl2, w);
      return cudaGetLastError();
    }));
  return static_cast<int>(f32_width(D, [&](auto wd) {
    constexpr int DT = decltype(wd)::value;
    using P = F32AlignTile<DT>;
    const cudaError_t e = allow_shared(gctorch_attn_fwd_b3a_f32<DT>, P::BYTES);
    if (e != cudaSuccess) return e;
    gctorch_attn_fwd_b3a_f32<DT><<<dim3((S + P::ROWS - 1) / P::ROWS, B * H), P::THREADS, P::BYTES, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), H, S, D, V, n_ref, qs, ks, vs, os, sl2, w);
    return cudaGetLastError();
  }));
}

// CTAs of B3 (align 0) or B3a (align 1) resident on an SM at head width D,
// by cudaOccupancyMaxActiveBlocksPerMultiprocessor with each launch's shared
// memory and attributes; -1 where the query fails
extern "C" int gctorch_flash_attn_ctas(int D, int is_bf16, int align) {
  int n = -1;
  cudaError_t e;
  if (is_bf16)
    e = bf16_width(D, [&](auto wd) {
      constexpr int DT = decltype(wd)::value;
      if (!align) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gctorch_attn_fwd_b3_bf16<DT>, 128, 0);
      const cudaError_t a = allow_shared(gctorch_attn_fwd_b3a_bf16<DT>, AlignTile<DT>::SUM_BYTES);
      return a != cudaSuccess ? a
                              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gctorch_attn_fwd_b3a_bf16<DT>, 128,
                                                                              AlignTile<DT>::SUM_BYTES);
    });
  else
    e = f32_width(D, [&](auto wd) {
      constexpr int DT = decltype(wd)::value;
      if (!align) {
        const cudaError_t a = cudaFuncSetAttribute(gctorch_attn_fwd_b3_f32<DT>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(F32Tile<DT>::BYTES));
        return a != cudaSuccess ? a
                                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gctorch_attn_fwd_b3_f32<DT>, 128,
                                                                                F32Tile<DT>::BYTES);
      }
      const cudaError_t a = allow_shared(gctorch_attn_fwd_b3a_f32<DT>, F32AlignTile<DT>::BYTES);
      return a != cudaSuccess ? a
                              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gctorch_attn_fwd_b3a_f32<DT>, 128,
                                                                              F32AlignTile<DT>::BYTES);
    });
  return e == cudaSuccess ? n : -1;
}
