// What kernels B1 (blend_fwd.cu), B2 (blend_bwd.cu) and B1v
// (blend_variants.cu) share: the staged gaussian, the box of its footprint
// that a warp tests before it evaluates the gaussian, the pair's alpha and the
// transmittance step.
//
// B2 re-walks exactly the (pixel, gaussian) pairs that B1 composited, and both
// take exactly the pairs of the plain PyTorch version (ops/blend.py): sigma,
// alpha and T * (1 - alpha) are written with the _rn intrinsics, which the
// compiler never contracts into fused multiply-adds, in the plain version's
// order of operations, and the exponential is expf (not __expf). The rest of
// the arithmetic (compositing, gradients) may contract.

#pragma once

#include <cuda_runtime.h>

namespace gctorch_blend {

constexpr int kBlock = 16;
constexpr int kTilePix = kBlock * kBlock;  // pixels of a tile
constexpr int kBatch = 256;                // gaussians staged in shared memory at a time
constexpr int kLanes = 32;
// CTAs of kTilePix threads an SM that B1, B2 and B1v ask ptxas to fit (the
// registers this leaves, 32 at 8, may spill a little): 8 hold a 512² frame's
// 1,024 tiles in one wave on the H100's 132 SMs
template <int C>
constexpr int kMinBlocks = C <= 4 ? 8 : 6;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaClamp = 0.999f;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
// A pair with sigma > log(255 * opacity) + kSkipMargin has
// alpha < exp(-kSkipMargin) / 255 before rounding, 1% under 1/255, and still
// under it after, so it is skipped without its exponential; every other pair
// takes the exact test. The margin dwarfs the rounding of logf, expf and the
// product. B1v's "notrans" ablation takes alpha = opacity / (1 + sigma) in
// place of opacity * exp(-sigma) (kRecip below): alpha < 1/255 iff
// sigma > 255 * opacity - 1, and past 255 * opacity * (1 + kSkipMargin) - 1
// alpha is under 1/255 by 1% before rounding and under it after.
constexpr float kSkipMargin = 1e-2f;

// The level of sigma past which no pair of a gaussian of opacity o passes the
// alpha test (see kSkipMargin); -inf at opacity 0 (-1 with kRecip): every
// pair skipped.
template <bool kRecip>
__device__ __forceinline__ float skip_level(float o) {
  return kRecip ? 255.0f * o * (1.0f + kSkipMargin) - 1.0f : logf(255.0f * o) + kSkipMargin;
}

// A staged gaussian is kPacks<C> float4s in shared memory: the box of its
// footprint, which a warp reads to pass over the gaussians that none of its
// pixels can take (candidates below), then 2 to evaluate a pair and the rest
// only when the pair is composited:
//   [0] x, y, conic a, conic b     [1] conic c, opacity, skip, colour 0
//   [2] colours 1..4               [3] colours 5..7       [kBox] the box
template <int C>
constexpr int kPacks = 3 + (C + 2) / 4;
template <int C>
constexpr int kBox = kPacks<C> - 1;

template <int C>
using Staged = float4[kPacks<C>][kBatch];

// The footprint's box (x0, x1, y0, y1): every pixel outside it has
// sigma > skip, so no pixel there takes the gaussian. sigma's rounding
// (dx, dy and its six operations) is bounded by 6 ulp * (1 + rho) / (1 - rho)
// of it, rho = |b| / sqrt(a c); boxes are drawn only where
// det = a c - b^2 >= kBoxDet * a c (1 - rho >= 5e-4, the rounding under
// 1.5e-3), around the level kBoxLevelScale * skip + kBoxLevelPad of the exact
// quadratic form, and widened by kBoxWiden of a side and kBoxPad px. Elsewhere
// the box is everything, or nothing where skip < 0 (every pair is skipped).
// ops/blend.footprint_box is its plain mirror, which counts the pairs B1 and
// B2 evaluate.
constexpr float kBoxDet = 1e-3f;
constexpr float kBoxLevelScale = 1.01f;
constexpr float kBoxLevelPad = 1e-2f;
constexpr float kBoxWiden = 1.001f;
constexpr float kBoxPad = 1e-3f;

__device__ __forceinline__ float4 footprint_box(float x, float y, float a, float b, float c,
                                                float skip) {
  const float inf = __int_as_float(0x7f800000);
  if (!(skip >= 0.0f)) return skip < 0.0f ? make_float4(inf, -inf, inf, -inf)  // nothing
                                          : make_float4(-inf, inf, -inf, inf);  // NaN: everything
  const float det = a * c - b * b;
  if (!(a > 0.0f && c > 0.0f && det >= kBoxDet * a * c)) return make_float4(-inf, inf, -inf, inf);
  const float level = 2.0f * (kBoxLevelScale * skip + kBoxLevelPad);
  const float ex = sqrtf(level * c / det) * kBoxWiden + kBoxPad;
  const float ey = sqrtf(level * a / det) * kBoxWiden + kBoxPad;
  return make_float4(x - ex, x + ex, y - ey, y + ey);
}

// The pixels of a warp: the rectangle [x0, x0 + kBlock - 1] x [y0, y1].
struct Strip {
  float x0, y0, y1;
};

// The gaussians of staged slots [k32, k32 + 32) whose footprint's box meets
// the warp's strip, as a bit mask (bit l: slot k32 + l) that every lane gets;
// lane l tests slot k32 + l.
template <int C>
__device__ __forceinline__ unsigned candidates(const Staged<C>& s, int k32, int lane, const Strip& w) {
  const float4 box = s[kBox<C>][k32 + lane];
  const bool meets = !(box.y < w.x0 || box.x > w.x0 + (kBlock - 1) || box.w < w.y0 || box.z > w.y1);
  return __ballot_sync(kFull, meets);
}

// Takes the first slot of a non-empty candidate mask off it.
__device__ __forceinline__ int take_first(unsigned& mask, int k32) {
  const int k = k32 + __ffs(mask) - 1;
  mask &= mask - 1;
  return k;
}

// Stage gaussian g (or, for g < 0, one that no pixel takes) into slot i, with
// the skip level and the box of alpha = opacity * exp(-sigma), or with kRecip
// of alpha = opacity / (1 + sigma).
template <int C, bool kRecip = false>
__device__ __forceinline__ void stage(Staged<C>& s, int i, int g, const float* __restrict__ xys,
                                      const float* __restrict__ conics,
                                      const float* __restrict__ colors,
                                      const float* __restrict__ opacs) {
  float f[4 * kBox<C>];
#pragma unroll
  for (int q = 0; q < 4 * kBox<C>; ++q) f[q] = 0.0f;
  if (g >= 0) {
    const float o = opacs[g];
    f[0] = xys[2 * g];
    f[1] = xys[2 * g + 1];
    f[2] = conics[3 * g];
    f[3] = conics[3 * g + 1];
    f[4] = conics[3 * g + 2];
    f[5] = o;
    f[6] = skip_level<kRecip>(o);
#pragma unroll
    for (int c = 0; c < C; ++c) f[7 + c] = colors[g * C + c];
  } else {
    f[6] = -__int_as_float(0x7f800000);  // -inf
  }
#pragma unroll
  for (int q = 0; q < kBox<C>; ++q) s[q][i] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
  s[kBox<C>][i] = footprint_box(f[0], f[1], f[2], f[3], f[4], f[6]);
}

// The colours of staged gaussian k, colour 0 taken from its pack 1.
template <int C>
__device__ __forceinline__ void colours(const Staged<C>& s, int k, const float4& p1, float (&col)[C]) {
  col[0] = p1.w;
#pragma unroll
  for (int q = 2; q < kBox<C>; ++q) {
    const float4 v = s[q][k];
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q - 7 + i < C) col[4 * q - 7 + i] = w[i];
  }
}

struct Pair {
  float alpha;      // 0 where the pair is skipped (sigma < 0 or alpha < 1/255 follows)
  float dx, dy;
  float e, oe;      // exp(-sigma) and opacity * exp(-sigma), set only where alpha is
};

// The pair's alpha as the plain version rounds it:
//   sigma = 0.5 * (a*dx*dx + c*dy*dy) + b*dx*dy, alpha = min(0.999, o * exp(-sigma)),
// or 0 where the pair is skipped. A pair is composited iff alpha >= 1/255.
// With kRecip (B1v's "notrans"), exp(-sigma) is 1 / (1 + sigma) and p1.z the
// skip level of stage<C, true>.
template <bool kRecip = false>
__device__ __forceinline__ Pair pair_alpha(const float4& p0, const float4& p1, float fpx, float fpy) {
  Pair r;
  r.dx = __fsub_rn(p0.x, fpx);
  r.dy = __fsub_rn(p0.y, fpy);
  const float aa = __fmul_rn(__fmul_rn(p0.z, r.dx), r.dx);
  const float cc = __fmul_rn(__fmul_rn(p1.x, r.dy), r.dy);
  const float bb = __fmul_rn(__fmul_rn(p0.w, r.dx), r.dy);
  const float sigma = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(aa, cc)), bb);
  r.alpha = r.e = r.oe = 0.0f;
  if (!(sigma < 0.0f || sigma > p1.z)) {
    r.e = kRecip ? __fdiv_rn(1.0f, __fadd_rn(1.0f, sigma)) : expf(-sigma);
    r.oe = __fmul_rn(p1.y, r.e);
    r.alpha = fminf(kAlphaClamp, r.oe);
  }
  return r;
}

// T * (1 - alpha), rounded the same way in B1 and B2.
__device__ __forceinline__ float next_transmittance(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

}  // namespace gctorch_blend
