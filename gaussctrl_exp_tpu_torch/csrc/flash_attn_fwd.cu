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
// What bounds it: at the edit path's main shape, (18, 8, 4096, 40) in bf16,
// it does 4·S·T·D = 2.7e9 operations per (batch, head) on 4·S·D·2 = 1.3 MB,
// about 2,000 operations per byte, far above the H100's ~295 for bf16: it is
// bound by the tensor cores' operations (989 TFLOP/s dense bf16), as long as
// the S×T scores never reach device memory.
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
//  * bf16: one CTA of 4 warps per (batch·head, 64-query block); each warp owns
//    16 query rows, held in registers as mma.sync A fragments. K and V go
//    through shared memory 64 keys at a time (V transposed, so that both
//    operands of P·V are read as 32-bit pairs), with D padded by zeros to a
//    multiple of 16. Q·Kᵀ and P·V run on the tensor cores as
//    mma.sync.m16n8k16 bf16 with fp32 accumulators; the online softmax
//    (running max and sum per row) is fp32 in registers, and P is rounded to
//    bf16 for P·V as the reference rounds its probabilities to the input type.
//  * fp32: the same tiling with scalar fp32 FMAs, 4 threads per query row,
//    each owning a quarter of D, 32 keys per shared-memory tile; it exists so
//    that the card can be held to the CPU in fp32.
// Keys past T are masked to -inf in the ragged last tile; queries past S are
// computed on zeros and not stored. Strides are given for batch, head and
// sequence (D contiguous), so the head split's transpose needs no copy, and
// the output can be written straight into the (B, S, H, D) layout.
//
// When the caller passes an `lse` buffer (fp32, (B, H, S) contiguous), each
// stored query row also gets the log-sum-exp of its scaled scores, m + log(l)
// of the online softmax in natural-log units: the backward kernels B4 and B5
// (flash_attn_bwd.cu) recompute P = exp(S - lse) from it. The output does not
// depend on whether it is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // queries per CTA
constexpr int BK = 64;         // keys per shared-memory tile (bf16)
constexpr int WARPS = 4;       // 16 query rows per warp
constexpr int KPAD = 8;        // row padding of the K tile, against bank conflicts
constexpr int VPAD = 8;        // row padding of the transposed V tile
constexpr int BKF = 32;        // keys per shared-memory tile (fp32)
constexpr int QUAD = 4;        // threads per query row (fp32)
constexpr int MAX_D = 160;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, h, s;
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

// two neighbouring bf16 of row r, columns c and c + 1 (c even, D a multiple of 8)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, long long row_stride, int r,
                                              int c, int rows, int D) {
  if (r >= rows || c >= D) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (long long)r * row_stride + c);
}

template <int DP>  // D rounded up to a multiple of 16
__global__ void __launch_bounds__(WARPS * 32)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int H, int S, int T, int D, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale_log2) {
  // raw bf16 bits: K rows, and V transposed (Vt[d][key])
  __shared__ __align__(16) uint16_t Ks[BK][DP + KPAD];
  __shared__ __align__(16) uint16_t Vt[DP][BK + VPAD];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row group and column pair
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  // this warp's 16 query rows as A fragments: rows r0 and r0 + 8
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c0 = kk * 16 + tq * 2, c1 = c0 + 8;
    qa[kk][0] = load_pair(qb, qs.s, r0, c0, S, D);
    qa[kk][1] = load_pair(qb, qs.s, r1, c0, S, D);
    qa[kk][2] = load_pair(qb, qs.s, r0, c1, S, D);
    qa[kk][3] = load_pair(qb, qs.s, r1, c1, S, D);
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1 (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int e = threadIdx.x; e < BK * (DP / 2); e += WARPS * 32) {
      const int r = e / (DP / 2), c = (e % (DP / 2)) * 2, key = k0 + r;
      uint32_t kv = 0u, vv = 0u;
      if (key < T && c < D) {
        kv = *reinterpret_cast<const uint32_t*>(kb + (long long)key * ks.s + c);
        vv = *reinterpret_cast<const uint32_t*>(vb + (long long)key * vs.s + c);
      }
      *reinterpret_cast<uint32_t*>(&Ks[r][c]) = kv;
      Vt[c][r] = static_cast<uint16_t>(vv & 0xffffu);  // column c is the low half
      Vt[c + 1][r] = static_cast<uint16_t>(vv >> 16);
    }
    __syncthreads();

    // scores of rows r0, r1 against the tile's 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const uint16_t* kr = &Ks[nt * 8 + g][kk * 16 + tq * 2];
        mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + nt * 8 + tq * 2 + j < T;
        s[nt][j] = ok ? s[nt][j] * scale_log2 : -INFINITY;
        s[nt][2 + j] = ok ? s[nt][2 + j] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key k0 < T lies in every tile, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      acc[nt][0] *= c0;
      acc[nt][1] *= c0;
      acc[nt][2] *= c1;
      acc[nt][3] *= c1;
    }

    // probabilities: the C fragments of Q·Kᵀ are the A fragments of P·V
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p00 = exp2f(s[nt][0] - mn0), p01 = exp2f(s[nt][1] - mn0);
      const float p10 = exp2f(s[nt][2] - mn1), p11 = exp2f(s[nt][3] - mn1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p00, p01);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        const uint16_t* vr = &Vt[nt * 8 + g][kk * 16 + tq * 2];
        mma_bf16(acc[nt], pa[kk], *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (lse != nullptr && tq == 0) {  // m is in log2 units of the scaled scores
    if (r0 < S) lse[(long long)blockIdx.y * S + r0] = (m0 + log2f(l0)) * LN2;
    if (r1 < S) lse[(long long)blockIdx.y * S + r1] = (m1 + log2f(l1)) * LN2;
  }
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const int c = nt * 8 + tq * 2;
    if (c >= D) continue;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * os.s + c) =
          pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * os.s + c) =
          pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

template <int MAXC>  // the most dims a thread owns: D / 4 ≤ MAXC
__global__ void __launch_bounds__(BQ * QUAD)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
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

template <int DP>
void launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                 int S, int T, int D, Strides qs, Strides ks, Strides vs, Strides os, float sl2,
                 cudaStream_t st) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_bf16<DP><<<grid, WARPS * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, S, T, D, qs, ks,
      vs, os, sl2);
}

template <int MAXC>
void launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int S, int T, int D, Strides qs, Strides ks, Strides vs, Strides os, float sl2,
                cudaStream_t st) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_f32<MAXC><<<grid, BQ * QUAD, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, S, T, D, qs, ks, vs, os, sl2);
}

}  // namespace

// q (B, H, S, D), k and v (B, H, T, D), o (B, H, S, D), each given by its
// pointer and its batch, head and sequence strides in elements (D
// contiguous); lse: null, or fp32 (B, H, S) contiguous for the log-sum-exp.
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
    switch ((D + 15) / 16) {
      case 1: launch_bf16<16>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st); break;
      case 2: launch_bf16<32>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st); break;
      case 3: launch_bf16<48>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st); break;
      case 4: launch_bf16<64>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st); break;
      case 5: launch_bf16<80>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st); break;
      case 6: launch_bf16<96>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st); break;
      case 7: launch_bf16<112>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st); break;
      case 8: launch_bf16<128>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st); break;
      case 9: launch_bf16<144>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st); break;
      default: launch_bf16<160>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st); break;
    }
  } else {
    const int dch = D / QUAD;
    if (dch <= 8) launch_f32<8>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    else if (dch <= 16) launch_f32<16>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    else if (dch <= 24) launch_f32<24>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
    else launch_f32<40>(q, k, v, o, lse, B, H, S, T, D, qs, ks, vs, os, sl2, st);
  }
  return static_cast<int>(cudaGetLastError());
}
