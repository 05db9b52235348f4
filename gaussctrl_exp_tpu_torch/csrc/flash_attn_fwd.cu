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
//  * fp32: the same tiling as before with scalar fp32 FMAs, 4 threads per
//    query row, each owning a quarter of D, 32 keys per shared-memory tile; it
//    exists so that the card can be held to the CPU in fp32, and it is the
//    depth generator's forward.
// Queries past S are computed on zeros and not stored. Strides are given for
// batch, head and sequence (D contiguous); bf16 rows start on 16-byte
// boundaries (the wrapper checks, and copies what does not), so the head
// split's transpose needs no copy, and the output can be written straight
// into the (B, S, H, D) layout.
//
// When the caller passes an `lse` buffer (fp32, (B, H, S) contiguous), each
// stored query row also gets the log-sum-exp of its scaled scores,
// m·scale + ln(l) in natural-log units: the backward kernels B4 and B5
// (flash_attn_bwd.cu) recompute P = exp(S - lse) from it. The output does not
// depend on whether it is written, and no launch depends on another's order:
// two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // queries per CTA (fp32)
constexpr int BKF = 32;        // keys per shared-memory tile (fp32)
constexpr int QUAD = 4;        // threads per query row (fp32)
constexpr int MAX_D = 160;
constexpr float LN2 = 0.6931471805599453f;
constexpr float RESCALE = 8.f;  // log2 growth of a row's max that moves the running max

struct Strides {
  long long b, h, s;
};

// the bf16 tiling for head width DT (D ≤ DT, both multiples of 8)
template <int DT>
struct Tile {
  static constexpr int WARPS = 4;
  static constexpr int MT = DT <= 80 ? 2 : 1;            // 16-row mma blocks per warp
  static constexpr int BQ = WARPS * 16 * MT;             // query rows per CTA
  static constexpr int BK = DT <= 40 ? 64 : 32;          // keys per ring stage
  static constexpr int STAGES = 2;
  static constexpr bool QS = MT == 2;                    // Q in shared memory, not registers
  static constexpr int PITCH = (DT / 8) % 2 ? DT : DT + 8;  // smem row pitch (elements)
  static constexpr int K16 = DT / 16;                    // 16-wide steps of Q·Kᵀ over D
  static constexpr bool K8 = DT % 16 != 0;               // and a last 8-wide one
  static constexpr int NT = DT / 8;                      // 8-wide n-tiles of P·V over D
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

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

template <int DT>
using QFrag = uint32_t[Tile<DT>::MT][Tile<DT>::K16][4];  // Q's A fragments
template <int DT>
using SFrag = float[Tile<DT>::MT][Tile<DT>::BK / 8][4];  // a tile's scores (C fragments)
template <int DT>
using PFrag = uint32_t[Tile<DT>::MT][Tile<DT>::BK / 16][4];  // its probabilities (A fragments)
template <int DT>
using OFrag = float[Tile<DT>::MT][Tile<DT>::NT][4];  // the output accumulators

// s = Q·Kᵀ of this warp's MT·16 query rows against the BK keys of tile Ks
template <int DT>
__device__ __forceinline__ void scores(const uint16_t* __restrict__ Ks, int lane, const QFrag<DT>& q_regs,
                                       const uint16_t* __restrict__ qrow, SFrag<DT>& s) {
  using P = Tile<DT>;
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
template <int DT, bool MASK>
__device__ __forceinline__ void softmax(SFrag<DT>& s, int k0, int T, int lane, float sl2, OFrag<DT>& acc,
                                        float (&m)[Tile<DT>::MT][2], float (&l)[Tile<DT>::MT][2], PFrag<DT>& pa) {
  using P = Tile<DT>;
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
template <int DT>
__device__ __forceinline__ void accumulate(const uint16_t* __restrict__ Vs, int lane, const PFrag<DT>& pa,
                                           OFrag<DT>& acc) {
  using P = Tile<DT>;
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

template <int DT>
__global__ void __launch_bounds__(Tile<DT>::WARPS * 32)
    gctorch_attn_fwd_b3_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, int H, int S, int T, int D, Strides qs, Strides ks,
                             Strides vs, Strides os, float sl2) {
  using P = Tile<DT>;
  constexpr int MT = P::MT, BK = P::BK, PITCH = P::PITCH, NT = P::NT, STAGES = P::STAGES;
  constexpr int THREADS = P::WARPS * 32, CHUNKS = DT / 8;  // 16-byte chunks per row
  static_assert(BK % (P::K8 ? 32 : 16) == 0, "Q·Kᵀ takes keys 16 at a time, its last 8 dims 32 at a time");
  __shared__ __align__(128) uint16_t Ks[STAGES][BK * PITCH];
  __shared__ __align__(128) uint16_t Vs[STAGES][BK * PITCH];
  __shared__ __align__(128) uint16_t Qs[P::QS ? P::BQ * PITCH : 8];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row group and column pair
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

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
          cp_async16(&Ks[st][r * PITCH + c], ok ? kb + key * ks.s + c : kb, ok);
          cp_async16(&Vs[st][r * PITCH + c], ok ? vb + key * vs.s + c : vb, ok);
        }
      }
    }
    cp_commit();
  };
  // this warp's query rows: block i covers rows r0 + 16·i + {g, g + 8}
  const int r0 = blockIdx.x * P::BQ + warp * 16 * MT;
  QFrag<DT> qa;
  if constexpr (P::QS) {  // the CTA's Q rows into Qs, in tile 0's copy group
#pragma unroll
    for (int e0 = 0; e0 < P::BQ * CHUNKS; e0 += THREADS) {
      const int e = e0 + threadIdx.x;
      if (P::BQ * CHUNKS % THREADS == 0 || e < P::BQ * CHUNKS) {
        const int r = e / CHUNKS, c = (e % CHUNKS) * 8, row = blockIdx.x * P::BQ + r;
        const bool ok = row < S && c < D;
        cp_async16(&Qs[r * PITCH + c], ok ? qb + row * qs.s + c : qb, ok);
      }
    }
  } else {  // as A fragments in registers
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int ra = r0 + 16 * i + g, rb = ra + 8;
#pragma unroll
      for (int kk = 0; kk < P::K16; ++kk) {
        const int c0 = kk * 16 + tq * 2, c1 = c0 + 8;
        qa[i][kk][0] = load_pair(qb, qs.s, ra, c0, S, D);
        qa[i][kk][1] = load_pair(qb, qs.s, rb, c0, S, D);
        qa[i][kk][2] = load_pair(qb, qs.s, ra, c1, S, D);
        qa[i][kk][3] = load_pair(qb, qs.s, rb, c1, S, D);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);
  // ldmatrix.x4 of Q: lanes 0-15 give rows 0-15 at column 0, lanes 16-31 at column 8
  const uint16_t* qrow = Qs + (warp * 16 * MT + (lane & 15)) * PITCH + (lane >> 4) * 8;

  OFrag<DT> acc;
  float m[MT][2], l[MT][2];  // running max (raw scores) and this thread's share of the sums
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] = 0.f;
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
  }

  // Tile j + 1's copy is in flight while tile j is computed. Every tile before
  // the last is full; the last may be ragged and is finished after the loop.
  SFrag<DT> s;
  PFrag<DT> pa;
  for (int j = 0; j + 1 < n_tiles; ++j) {
    cp_wait<STAGES - 2>();  // tile j has landed for this thread ...
    __syncthreads();        // ... and for all; every warp is done with tile j − 1
    load_tile(j + STAGES - 1);
    scores<DT>(Ks[j % STAGES], lane, qa, qrow, s);
    softmax<DT, false>(s, j * BK, T, lane, sl2, acc, m, l, pa);
    accumulate<DT>(Vs[j % STAGES], lane, pa, acc);
  }
  cp_wait<0>();
  __syncthreads();
  scores<DT>(Ks[(n_tiles - 1) % STAGES], lane, qa, qrow, s);
  const int last = n_tiles - 1;
  if (T % BK)
    softmax<DT, true>(s, last * BK, T, lane, sl2, acc, m, l, pa);
  else
    softmax<DT, false>(s, last * BK, T, lane, sl2, acc, m, l, pa);
  accumulate<DT>(Vs[last % STAGES], lane, pa, acc);

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float l0 = l[i][0], l1 = l[i][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
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

template <int MAXC>  // the most dims a thread owns: D / 4 ≤ MAXC
__global__ void __launch_bounds__(BQ * QUAD)
    gctorch_attn_fwd_b3_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse, int H, int S, int T, int D,
                            Strides qs, Strides ks, Strides vs, Strides os, float scale_log2) {
  __shared__ float Ks[BKF][MAX_D];
  __shared__ float Vs[BKF][MAX_D];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row = blockIdx.x * BQ + threadIdx.x / QUAD;
  const int dch = D / QUAD, d0 = (threadIdx.x % QUAD) * dch;  // this thread's dims
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  float qr[MAXC], acc[MAXC];
  const float* qrow = q + b * qs.b + h * qs.h + (long long)row * qs.s + d0;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    qr[i] = (i < dch && row < S) ? qrow[i] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < T; k0 += BKF) {
    __syncthreads();
    for (int e = threadIdx.x; e < BKF * D; e += BQ * QUAD) {
      const int r = e / D, c = e % D, key = k0 + r;
      Ks[r][c] = key < T ? kb[(long long)key * ks.s + c] : 0.f;
      Vs[r][c] = key < T ? vb[(long long)key * vs.s + c] : 0.f;
    }
    __syncthreads();

    float s[BKF];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKF; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < MAXC; ++i)
        if (i < dch) p = fmaf(qr[i], Ks[j][d0 + i], p);
      // the four threads of a row are neighbouring lanes
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      s[j] = k0 + j < T ? p * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx), c = exp2f(m - mn);
    m = mn;
    l *= c;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) acc[i] *= c;
#pragma unroll
    for (int j = 0; j < BKF; ++j) {
      const float p = exp2f(s[j] - mn);
      l += p;
#pragma unroll
      for (int i = 0; i < MAXC; ++i)
        if (i < dch) acc[i] = fmaf(p, Vs[j][d0 + i], acc[i]);
    }
  }

  if (row >= S) return;
  if (lse != nullptr && threadIdx.x % QUAD == 0) lse[(long long)blockIdx.y * S + row] = (m + log2f(l)) * LN2;
  float* orow = o + b * os.b + h * os.h + (long long)row * os.s + d0;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < MAXC; ++i)
    if (i < dch) orow[i] = acc[i] * inv;
}

template <int DT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                        int S, int T, int D, Strides qs, Strides ks, Strides vs, Strides os, float sl2,
                        cudaStream_t st) {
  using P = Tile<DT>;
  const dim3 grid((S + P::BQ - 1) / P::BQ, B * H);
  gctorch_attn_fwd_b3_bf16<DT><<<grid, P::WARPS * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, S, T, D, qs, ks,
      vs, os, sl2);
  return cudaGetLastError();
}

template <int MAXC>
void launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int S, int T, int D, Strides qs, Strides ks, Strides vs, Strides os, float sl2,
                cudaStream_t st) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  gctorch_attn_fwd_b3_f32<MAXC><<<grid, BQ * QUAD, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, S, T, D, qs, ks, vs, os, sl2);
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
  if (is_bf16) {
    if (D <= 16) return launch_bf16<16>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    if (D <= 32) return launch_bf16<32>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    if (D <= 40) return launch_bf16<40>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    if (D <= 48) return launch_bf16<48>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    if (D <= 64) return launch_bf16<64>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    if (D <= 80) return launch_bf16<80>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    if (D <= 96) return launch_bf16<96>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    if (D <= 128) return launch_bf16<128>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    return launch_bf16<160>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
  } else {
    const int dch = D / QUAD;
    if (dch <= 8) launch_f32<8>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    else if (dch <= 16) launch_f32<16>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    else if (dch <= 24) launch_f32<24>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    else launch_f32<40>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
  }
  return static_cast<int>(cudaGetLastError());
}
