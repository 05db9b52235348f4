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
// that is 1.7e11 and 1.3e11 operations on ~10 MB: bound by the fp32 FMA rate
// (67 TFLOP/s) by a factor of ~300, as long as the S×T scores never reach
// device memory. In bf16 the tensor cores' 989 TFLOP/s bound them.
//
// Design (simple first; ldmatrix, cp.async, wgmma and TMA are later work):
//  * B4 works on the transposed problem, so that no product needs a
//    transposed register fragment: each warp owns 16 key rows and computes
//    Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ directly, whose C fragments are (packed to
//    bf16) the A fragments of Pᵀ·dO and dSᵀ·Q, exactly as B3 turns its score
//    fragments into the A fragments of P·V. One CTA of 4 warps per 64 keys;
//    K and V stay in shared memory, and query tiles of Q and dO are staged
//    there row-major (B operands of the score products) and transposed (B
//    operands of the gradient products). dK and dV accumulate in fp32
//    registers and are written once.
//  * B5 is B3's layout: each warp owns 16 query rows, Q and dO in registers
//    as A fragments; key tiles of K and V are staged row-major and K
//    transposed; the dS fragments feed dS·K.
//  * bf16 runs on mma.sync.m16n8k16 with fp32 accumulators; P and dS are
//    rounded to bf16 before their products, as the forward rounds P. fp32
//    runs on scalar FMAs, TPR threads per row each owning D / TPR dims, with
//    two shuffle reductions per (query, key) pair.
//  * Keys past T get P = 0 and queries past S carry lse = +inf (so P = 0),
//    dO = 0 and delta = 0, and store nothing; D is zero-padded to a multiple
//    of 16 in registers and shared memory only. Strides are taken for batch,
//    head and sequence (D contiguous), and the outputs are written in the
//    (B, L, H, D) layout the wrapper allocates.
//  * Two kernels and no atomics: the result is the same bit for bit on
//    every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int PAD = 8;          // row padding of the bf16 shared tiles, against bank conflicts
constexpr int BKEY = WARPS * 16;  // keys per B4 CTA (bf16) and queries per B5 CTA (bf16)
constexpr int ROWS_F32 = 64;    // key rows per B4 CTA and query rows per B5 CTA (fp32)
constexpr int TILE_F32 = 32;    // query (B4) or key (B5) rows per shared tile (fp32)
constexpr int MAX_D = 160;
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// two neighbouring bf16 of row r, columns c and c + 1 (c even, D a multiple of 8)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, long long row_stride, int r,
                                              int c, int rows, int D) {
  if (r >= rows || c >= D) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (long long)r * row_stride + c);
}

// rows [r0, r0 + n) of a (rows, D) bf16 matrix into a row-major tile
// (n, DP + PAD) and, if `tr` is given, its transpose (DP, n + PAD); zeros past
// `rows` and past D
template <int DP>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* base, long long row_stride, int r0, int n,
                                           int rows, int D, uint16_t* rm, uint16_t* tr) {
  for (int e = threadIdx.x; e < n * (DP / 2); e += WARPS * 32) {
    const int r = e / (DP / 2), c = (e % (DP / 2)) * 2;
    const uint32_t x = load_pair(base, row_stride, r0 + r, c, rows, D);
    *reinterpret_cast<uint32_t*>(rm + r * (DP + PAD) + c) = x;
    if (tr != nullptr) {
      tr[c * (n + PAD) + r] = static_cast<uint16_t>(x & 0xffffu);  // column c is the low half
      tr[(c + 1) * (n + PAD) + r] = static_cast<uint16_t>(x >> 16);
    }
  }
}

// ---------------------------------------------------------------- B4, bf16

template <int DP>
struct DkvTile {
  static constexpr int BQ = DP <= 64 ? 64 : 32;  // queries per staged tile
  static constexpr int K_OFF = 0;                                   // K  [BKEY][DP + PAD]
  static constexpr int V_OFF = K_OFF + BKEY * (DP + PAD);           // V  [BKEY][DP + PAD]
  static constexpr int Q_OFF = V_OFF + BKEY * (DP + PAD);           // Q  [BQ][DP + PAD]
  static constexpr int DO_OFF = Q_OFF + BQ * (DP + PAD);            // dO [BQ][DP + PAD]
  static constexpr int QT_OFF = DO_OFF + BQ * (DP + PAD);           // Qᵀ  [DP][BQ + PAD]
  static constexpr int DOT_OFF = QT_OFF + DP * (BQ + PAD);          // dOᵀ [DP][BQ + PAD]
  static constexpr int END = DOT_OFF + DP * (BQ + PAD);
  static constexpr size_t BYTES = END * 2 + 2 * BQ * sizeof(float);  // + lse2, delta
};

template <int DP>
__global__ void __launch_bounds__(WARPS * 32) gctorch_attn_bwd_b4_dkv_bf16(Args a) {
  using L = DkvTile<DP>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Ks = smem + L::K_OFF;
  uint16_t* Vs = smem + L::V_OFF;
  uint16_t* Qs = smem + L::Q_OFF;
  uint16_t* dOs = smem + L::DO_OFF;
  uint16_t* Qt = smem + L::QT_OFF;
  uint16_t* dOt = smem + L::DOT_OFF;
  float* lse2_s = reinterpret_cast<float*>(smem + L::END);
  float* delta_s = lse2_s + BQ;

  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int key0 = blockIdx.x * BKEY;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const float* lse = a.lse + (long long)blockIdx.y * a.S;
  const float* delta = a.delta + (long long)blockIdx.y * a.S;

  stage_bf16<DP>(kb, a.ks.s, key0, BKEY, a.T, a.D, Ks, nullptr);
  stage_bf16<DP>(vb, a.vs.s, key0, BKEY, a.T, a.D, Vs, nullptr);

  // this warp's key rows kr0 (fragment row g) and kr1 = kr0 + 8
  const int kl0 = warp * 16 + g, kl1 = kl0 + 8;
  const bool ok0 = key0 + kl0 < a.T, ok1 = key0 + kl1 < a.T;

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[nt][j] = dv[nt][j] = 0.f;

  for (int q0 = 0; q0 < a.S; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous tile
    stage_bf16<DP>(qb, a.qs.s, q0, BQ, a.S, a.D, Qs, Qt);
    stage_bf16<DP>(dob, a.dos.s, q0, BQ, a.S, a.D, dOs, dOt);
    for (int r = threadIdx.x; r < BQ; r += WARPS * 32) {
      const bool in = q0 + r < a.S;
      lse2_s[r] = in ? lse[q0 + r] * LOG2E : INFINITY;  // P = 0 for queries past S
      delta_s[r] = in ? delta[q0 + r] : 0.f;
    }
    __syncthreads();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys × BQ queries
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c0 = kk * 16 + tq * 2;
      uint32_t ka[4], va[4];
      ka[0] = ld32(Ks + kl0 * (DP + PAD) + c0);
      ka[1] = ld32(Ks + kl1 * (DP + PAD) + c0);
      ka[2] = ld32(Ks + kl0 * (DP + PAD) + c0 + 8);
      ka[3] = ld32(Ks + kl1 * (DP + PAD) + c0 + 8);
      va[0] = ld32(Vs + kl0 * (DP + PAD) + c0);
      va[1] = ld32(Vs + kl1 * (DP + PAD) + c0);
      va[2] = ld32(Vs + kl0 * (DP + PAD) + c0 + 8);
      va[3] = ld32(Vs + kl1 * (DP + PAD) + c0 + 8);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const uint16_t* qr = Qs + (nt * 8 + g) * (DP + PAD) + c0;
        mma_bf16(s[nt], ka, ld32(qr), ld32(qr + 8));
        const uint16_t* dr = dOs + (nt * 8 + g) * (DP + PAD) + c0;
        mma_bf16(dp[nt], va, ld32(dr), ld32(dr + 8));
      }
    }

    // Pᵀ and dSᵀ; their C fragments packed to bf16 are the A fragments of
    // the products over queries
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = nt * 8 + tq * 2 + (j & 1);
        const bool ok = j < 2 ? ok0 : ok1;
        p[j] = ok ? exp2f(s[nt][j] * a.scale_log2 - lse2_s[qc]) : 0.f;
        ds[j] = p[j] * (dp[nt][j] - delta_s[qc]);
      }
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[nt >> 1][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q, contracting over the tile's queries
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      const int c0 = kq * 16 + tq * 2;
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        const uint16_t* dr = dOt + (nt * 8 + g) * (BQ + PAD) + c0;
        mma_bf16(dv[nt], pa[kq], ld32(dr), ld32(dr + 8));
        const uint16_t* qr = Qt + (nt * 8 + g) * (BQ + PAD) + c0;
        mma_bf16(dk[nt], dsa[kq], ld32(qr), ld32(qr + 8));
      }
    }
  }

  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(a.dk) + b * a.dks.b + h * a.dks.h;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(a.dv) + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const int c = nt * 8 + tq * 2;
    if (c >= a.D) continue;
    if (ok0) {
      const long long r = key0 + kl0;
      *reinterpret_cast<uint32_t*>(dkb + r * a.dks.s + c) = pack_bf16(dk[nt][0] * a.scale, dk[nt][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + r * a.dvs.s + c) = pack_bf16(dv[nt][0], dv[nt][1]);
    }
    if (ok1) {
      const long long r = key0 + kl1;
      *reinterpret_cast<uint32_t*>(dkb + r * a.dks.s + c) = pack_bf16(dk[nt][2] * a.scale, dk[nt][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + r * a.dvs.s + c) = pack_bf16(dv[nt][2], dv[nt][3]);
    }
  }
}

// ---------------------------------------------------------------- B5, bf16

template <int DP>
struct DqTile {
  static constexpr int BK = DP <= 64 ? 64 : 32;  // keys per staged tile
};

template <int DP>
__global__ void __launch_bounds__(WARPS * 32) gctorch_attn_bwd_b5_dq_bf16(Args a) {
  constexpr int BK = DqTile<DP>::BK;
  __shared__ __align__(16) uint16_t Ks[BK * (DP + PAD)];
  __shared__ __align__(16) uint16_t Vs[BK * (DP + PAD)];
  __shared__ __align__(16) uint16_t Kt[DP * (BK + PAD)];

  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(a.dout) + b * a.dos.b + h * a.dos.h;

  // this warp's 16 query rows as A fragments of Q and dO: rows r0 and r0 + 8
  const int r0 = blockIdx.x * BKEY + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[DP / 16][4], da[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c0 = kk * 16 + tq * 2, c1 = c0 + 8;
    qa[kk][0] = load_pair(qb, a.qs.s, r0, c0, a.S, a.D);
    qa[kk][1] = load_pair(qb, a.qs.s, r1, c0, a.S, a.D);
    qa[kk][2] = load_pair(qb, a.qs.s, r0, c1, a.S, a.D);
    qa[kk][3] = load_pair(qb, a.qs.s, r1, c1, a.S, a.D);
    da[kk][0] = load_pair(dob, a.dos.s, r0, c0, a.S, a.D);
    da[kk][1] = load_pair(dob, a.dos.s, r1, c0, a.S, a.D);
    da[kk][2] = load_pair(dob, a.dos.s, r0, c1, a.S, a.D);
    da[kk][3] = load_pair(dob, a.dos.s, r1, c1, a.S, a.D);
  }
  const float* lse = a.lse + (long long)blockIdx.y * a.S;
  const float* delta = a.delta + (long long)blockIdx.y * a.S;
  const float lse0 = r0 < a.S ? lse[r0] * LOG2E : INFINITY, lse1 = r1 < a.S ? lse[r1] * LOG2E : INFINITY;
  const float del0 = r0 < a.S ? delta[r0] : 0.f, del1 = r1 < a.S ? delta[r1] : 0.f;

  float dq[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;

  for (int k0 = 0; k0 < a.T; k0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * (DP / 2); e += WARPS * 32) {
      const int r = e / (DP / 2), c = (e % (DP / 2)) * 2;
      const uint32_t kx = load_pair(kb, a.ks.s, k0 + r, c, a.T, a.D);
      *reinterpret_cast<uint32_t*>(Ks + r * (DP + PAD) + c) = kx;
      *reinterpret_cast<uint32_t*>(Vs + r * (DP + PAD) + c) = load_pair(vb, a.vs.s, k0 + r, c, a.T, a.D);
      Kt[c * (BK + PAD) + r] = static_cast<uint16_t>(kx & 0xffffu);
      Kt[(c + 1) * (BK + PAD) + r] = static_cast<uint16_t>(kx >> 16);
    }
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const uint16_t* kr = Ks + (nt * 8 + g) * (DP + PAD) + kk * 16 + tq * 2;
        mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
        const uint16_t* vr = Vs + (nt * 8 + g) * (DP + PAD) + kk * 16 + tq * 2;
        mma_bf16(dp[nt], da[kk], ld32(vr), ld32(vr + 8));
      }
    }

    uint32_t dsa[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k0 + nt * 8 + tq * 2 + (j & 1) < a.T;
        const float p = ok ? exp2f(s[nt][j] * a.scale_log2 - (j < 2 ? lse0 : lse1)) : 0.f;
        ds[j] = p * (dp[nt][j] - (j < 2 ? del0 : del1));
      }
      dsa[nt >> 1][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        const uint16_t* kr = Kt + (nt * 8 + g) * (BK + PAD) + kk * 16 + tq * 2;
        mma_bf16(dq[nt], dsa[kk], ld32(kr), ld32(kr + 8));
      }
    }
  }

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const int c = nt * 8 + tq * 2;
    if (c >= a.D) continue;
    if (r0 < a.S)
      *reinterpret_cast<uint32_t*>(dqb + (long long)r0 * a.dqs.s + c) =
          pack_bf16(dq[nt][0] * a.scale, dq[nt][1] * a.scale);
    if (r1 < a.S)
      *reinterpret_cast<uint32_t*>(dqb + (long long)r1 * a.dqs.s + c) =
          pack_bf16(dq[nt][2] * a.scale, dq[nt][3] * a.scale);
  }
}

// ---------------------------------------------------------------- fp32

// the sum of x over the TPR neighbouring lanes that own one row
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// B4 in fp32: TPR threads per key row, each owning D / TPR dims (≤ MAXC)
template <int MAXC, int TPR>
__global__ void __launch_bounds__(ROWS_F32 * TPR) gctorch_attn_bwd_b4_dkv_f32(Args a) {
  __shared__ float Qs[TILE_F32][MAX_D];
  __shared__ float dOs[TILE_F32][MAX_D];
  __shared__ float lse2_s[TILE_F32], delta_s[TILE_F32];

  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int key = blockIdx.x * ROWS_F32 + threadIdx.x / TPR;
  const int dch = a.D / TPR, d0 = (threadIdx.x % TPR) * dch;
  const bool kok = key < a.T;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* dob = static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const float* krow = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h + (long long)key * a.ks.s + d0;
  const float* vrow = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h + (long long)key * a.vs.s + d0;
  const float* lse = a.lse + (long long)blockIdx.y * a.S;
  const float* delta = a.delta + (long long)blockIdx.y * a.S;

  float kr[MAXC], vr[MAXC], dk[MAXC], dv[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    kr[i] = (i < dch && kok) ? krow[i] : 0.f;
    vr[i] = (i < dch && kok) ? vrow[i] : 0.f;
    dk[i] = dv[i] = 0.f;
  }

  for (int q0 = 0; q0 < a.S; q0 += TILE_F32) {
    __syncthreads();
    for (int e = threadIdx.x; e < TILE_F32 * a.D; e += ROWS_F32 * TPR) {
      const int r = e / a.D, c = e % a.D, qi = q0 + r;
      Qs[r][c] = qi < a.S ? qb[(long long)qi * a.qs.s + c] : 0.f;
      dOs[r][c] = qi < a.S ? dob[(long long)qi * a.dos.s + c] : 0.f;
    }
    for (int r = threadIdx.x; r < TILE_F32; r += ROWS_F32 * TPR) {
      const bool in = q0 + r < a.S;
      lse2_s[r] = in ? lse[q0 + r] * LOG2E : INFINITY;
      delta_s[r] = in ? delta[q0 + r] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < TILE_F32; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < MAXC; ++i)
        if (i < dch) {
          s = fmaf(kr[i], Qs[j][d0 + i], s);
          dp = fmaf(vr[i], dOs[j][d0 + i], dp);
        }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const float p = kok ? exp2f(s * a.scale_log2 - lse2_s[j]) : 0.f;
      const float ds = p * (dp - delta_s[j]);
#pragma unroll
      for (int i = 0; i < MAXC; ++i)
        if (i < dch) {
          dv[i] = fmaf(p, dOs[j][d0 + i], dv[i]);
          dk[i] = fmaf(ds, Qs[j][d0 + i], dk[i]);
        }
    }
  }

  if (!kok) return;
  float* dkrow = static_cast<float*>(a.dk) + b * a.dks.b + h * a.dks.h + (long long)key * a.dks.s + d0;
  float* dvrow = static_cast<float*>(a.dv) + b * a.dvs.b + h * a.dvs.h + (long long)key * a.dvs.s + d0;
#pragma unroll
  for (int i = 0; i < MAXC; ++i)
    if (i < dch) {
      dkrow[i] = dk[i] * a.scale;
      dvrow[i] = dv[i];
    }
}

// B5 in fp32: TPR threads per query row
template <int MAXC, int TPR>
__global__ void __launch_bounds__(ROWS_F32 * TPR) gctorch_attn_bwd_b5_dq_f32(Args a) {
  __shared__ float Ks[TILE_F32][MAX_D];
  __shared__ float Vs[TILE_F32][MAX_D];

  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int row = blockIdx.x * ROWS_F32 + threadIdx.x / TPR;
  const int dch = a.D / TPR, d0 = (threadIdx.x % TPR) * dch;
  const bool in = row < a.S;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* qrow = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h + (long long)row * a.qs.s + d0;
  const float* dorow =
      static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h + (long long)row * a.dos.s + d0;
  const float lse2 = in ? a.lse[(long long)blockIdx.y * a.S + row] * LOG2E : INFINITY;
  const float del = in ? a.delta[(long long)blockIdx.y * a.S + row] : 0.f;

  float qr[MAXC], dr[MAXC], dq[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    qr[i] = (i < dch && in) ? qrow[i] : 0.f;
    dr[i] = (i < dch && in) ? dorow[i] : 0.f;
    dq[i] = 0.f;
  }

  for (int k0 = 0; k0 < a.T; k0 += TILE_F32) {
    __syncthreads();
    for (int e = threadIdx.x; e < TILE_F32 * a.D; e += ROWS_F32 * TPR) {
      const int r = e / a.D, c = e % a.D, ki = k0 + r;
      Ks[r][c] = ki < a.T ? kb[(long long)ki * a.ks.s + c] : 0.f;
      Vs[r][c] = ki < a.T ? vb[(long long)ki * a.vs.s + c] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < TILE_F32; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < MAXC; ++i)
        if (i < dch) {
          s = fmaf(qr[i], Ks[j][d0 + i], s);
          dp = fmaf(dr[i], Vs[j][d0 + i], dp);
        }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const float p = k0 + j < a.T ? exp2f(s * a.scale_log2 - lse2) : 0.f;
      const float ds = p * (dp - del);
#pragma unroll
      for (int i = 0; i < MAXC; ++i)
        if (i < dch) dq[i] = fmaf(ds, Ks[j][d0 + i], dq[i]);
    }
  }

  if (!in) return;
  float* dqrow = static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h + (long long)row * a.dqs.s + d0;
#pragma unroll
  for (int i = 0; i < MAXC; ++i)
    if (i < dch) dqrow[i] = dq[i] * a.scale;
}

template <int DP>
int launch_bf16(int which, const Args& a, int B, cudaStream_t st) {
  if (which == 0) {
    const size_t bytes = DkvTile<DP>::BYTES;
    cudaError_t e = cudaFuncSetAttribute(gctorch_attn_bwd_b4_dkv_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    gctorch_attn_bwd_b4_dkv_bf16<DP><<<dim3((a.T + BKEY - 1) / BKEY, B * a.H), WARPS * 32, bytes, st>>>(a);
  } else {
    gctorch_attn_bwd_b5_dq_bf16<DP><<<dim3((a.S + BKEY - 1) / BKEY, B * a.H), WARPS * 32, 0, st>>>(a);
  }
  return 0;
}

template <int MAXC, int TPR>
void launch_f32(int which, const Args& a, int B, cudaStream_t st) {
  if (which == 0)
    gctorch_attn_bwd_b4_dkv_f32<MAXC, TPR><<<dim3((a.T + ROWS_F32 - 1) / ROWS_F32, B * a.H), ROWS_F32 * TPR, 0, st>>>(a);
  else
    gctorch_attn_bwd_b5_dq_f32<MAXC, TPR><<<dim3((a.S + ROWS_F32 - 1) / ROWS_F32, B * a.H), ROWS_F32 * TPR, 0, st>>>(a);
}

}  // namespace

// which: 0 launches B4 (writes dk, dv), 1 launches B5 (writes dq).
// q, dout, dq (B, H, S, D); k, v, dk, dv (B, H, T, D): each given by its
// pointer and its batch, head and sequence strides in elements (D
// contiguous). lse and delta: fp32 (B, H, S) contiguous. is_bf16: 1 for bf16,
// 0 for fp32. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int gctorch_flash_attn_bwd(int which, const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta, void* dq,
                                      void* dk, void* dv, int B, int H, int S, int T, int D, int is_bf16,
                                      long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                                      long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                      long long v_ss, long long do_sb, long long do_sh, long long do_ss,
                                      long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
                                      long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
                                      long long dv_ss, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0 || D <= 0 || D % 8 != 0 || D > MAX_D || B * H > 65535 ||
      (which != 0 && which != 1))
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
  int err = 0;
  if (is_bf16) {
    switch ((D + 15) / 16) {
      case 1: err = launch_bf16<16>(which, a, B, st); break;
      case 2: err = launch_bf16<32>(which, a, B, st); break;
      case 3: err = launch_bf16<48>(which, a, B, st); break;
      case 4: err = launch_bf16<64>(which, a, B, st); break;
      case 5: err = launch_bf16<80>(which, a, B, st); break;
      case 6: err = launch_bf16<96>(which, a, B, st); break;
      case 7: err = launch_bf16<112>(which, a, B, st); break;
      case 8: err = launch_bf16<128>(which, a, B, st); break;
      case 9: err = launch_bf16<144>(which, a, B, st); break;
      default: err = launch_bf16<160>(which, a, B, st); break;
    }
  } else if (D <= 32) {
    launch_f32<8, 4>(which, a, B, st);
  } else if (D <= 64) {
    launch_f32<16, 4>(which, a, B, st);
  } else if (D <= 128) {
    launch_f32<16, 8>(which, a, B, st);
  } else {
    launch_f32<20, 8>(which, a, B, st);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
