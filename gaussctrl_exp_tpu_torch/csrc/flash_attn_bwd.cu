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
//    transposed register fragment: each warp owns 16 key rows and computes
//    Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ directly, whose C fragments become the A
//    fragments of Pᵀ·dO and dSᵀ·Q in registers. One CTA of 4 warps per 64
//    keys; dK and dV accumulate in fp32 registers and are written once.
//  * B5 is B3's layout: each warp owns 16 query rows with Q and dO as A
//    fragments; its dS fragments feed dS·K.
//  * bf16 (mma.sync.m16n8k16): K and V stay in shared memory; query tiles of
//    Q and dO (B4) or key tiles of K and V (B5) are staged row-major for the
//    score products and transposed for the gradient products. P and dS are
//    rounded to bf16 before their products, as the forward rounds P.
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
//  * Keys past T get P = 0; queries past S run on zero rows (so dO = 0,
//    delta = 0 and P·dO = dS = 0) and store nothing; D is zero-padded in
//    registers and shared memory only. Strides are taken for batch, head and
//    sequence (D contiguous), and the outputs are written in the (B, L, H, D)
//    layout the wrapper allocates.
//  * No atomics: the result is the same bit for bit on every run.
//
// Registers a thread, fp32 B4 / B5, by width (ptxas -v for sm_90a, as
// chip_smoke.py printed them on an NVIDIA H100 80GB HBM3, 700 W): 8: 102 /
// 101, 16: 128 / 109, 24: 166 / 144, 32: 171 / 154, 40: 217 / 168, 48: 239
// / 170, 64: 210 / 141, 80: 252 / 167, 96: 255 / 178, 128: 255 / 194, 160:
// 255 / 226. B4 spills 4 bytes at 96 and 12 at 160 (dK and dV alone hold D
// registers); B5 spills nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int PAD = 8;          // row padding of the bf16 shared tiles, against bank conflicts
constexpr int BKEY = WARPS * 16;  // keys per B4 CTA and queries per B5 CTA (bf16)
constexpr int MAX_D = 160;
constexpr float LOG2E = 1.4426950408889634f;
// fp32 B4 splits a key block's queries over more CTAs until the card has
// this many CTAs an SM
constexpr int DKV_CTAS_PER_SM = 2;
long long sum_launches = 0;  // launches of gctorch_attn_bwd_b4_dkv_f32_sum

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

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

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
// then dV's, each (B·H, T, D)) for gctorch_attn_bwd_b4_dkv_f32_sum.
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

// B4's second pass when the queries were split: dK and dV as the sums of
// the splits' partials, taken in split order (no atomics: the same bits on
// every run), dK scaled, written in the output layout
__global__ void __launch_bounds__(256) gctorch_attn_bwd_b4_dkv_f32_sum(Args a, const float* ws, int splits,
                                                                      int BH) {
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
  static_cast<float*>(a.dk)[b * a.dks.b + h * a.dks.h + t * a.dks.s + d] = sk * a.scale;
  static_cast<float*>(a.dv)[b * a.dvs.b + h * a.dvs.h + t * a.dvs.s + d] = sv;
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
    if (splits > 1) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      const long long n = (long long)B * a.H * a.T * a.D;
      gctorch_attn_bwd_b4_dkv_f32_sum<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(a, ws, splits,
                                                                                               B * a.H);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      ++sum_launches;
    }
  } else {
    e = cudaFuncSetAttribute(gctorch_attn_bwd_b5_dq_f32<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    gctorch_attn_bwd_b5_dq_f32<DT><<<dim3((a.S + P::ROWS - 1) / P::ROWS, B * a.H), WARPS * 32, bytes, st>>>(a);
  }
  return 0;
}

}  // namespace

// Over how many CTAs fp32 B4 splits each key block's queries, for a card of
// `sms` SMs: 1 where its ceil(T / 64) · B · H CTAs already give two an SM
// (and always in bf16), else enough to reach that, at most one split per 64
// queries, and no more than leaves each split a ring tile. The caller sizes
// the workspace of gctorch_flash_attn_bwd from it.
extern "C" int gctorch_flash_attn_bwd_dkv_splits(int B, int H, int S, int T, int D, int is_bf16, int sms) {
  const long long ctas = (long long)((T + F32_ROWS - 1) / F32_ROWS) * B * H;
  const long long want = (long long)DKV_CTAS_PER_SM * sms;
  if (is_bf16 || B <= 0 || H <= 0 || S <= 0 || T <= 0 || D <= 0 || ctas >= want) return 1;
  const long long most = (S + F32_ROWS - 1) / F32_ROWS;
  const int splits = static_cast<int>((want + ctas - 1) / ctas < most ? (want + ctas - 1) / ctas : most);
  const int n_q = (S + f32_ring_rows(D) - 1) / f32_ring_rows(D);
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
      (splits > 1 && (is_bf16 || which != 0 || workspace == nullptr)))
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
