// Kernel B2: tile blend backward for Hopper (sm_90a).
//
// Replaces gaussctrl_exp_tpu/ops/blend_pallas.py:_bwd_kernel and the
// slot-to-gaussian reduction of _blend_core_bwd that follows it. From the
// cotangents of the forward's outputs (g_img (H, W, C), g_T (H, W)) and its
// residuals (img, final_T), every pixel walks its tile's depth-sorted list
// front to back with the forward's exact tests (sigma >= 0, alpha >= 1/255,
// stop without compositing at T * (1 - alpha) <= 1e-4). For each composited
// pair j, with exclusive transmittance T_j:
//
//   w_j      = alpha_j * T_j                 cg_j = g_img . color_j
//   prefix_j = sum_{k<=j} w_k * cg_k         suffix_j = img . g_img - prefix_j
//   dalpha_j = T_j * cg_j - (suffix_j + g_T * final_T) / (1 - alpha_j)
//   dsigma   = -opacity * exp(-sigma) * dalpha   (not gated on the 0.999 clamp,
//                                                 as gsplat v0.1.2 and the TPU kernel)
//   dopacity = exp(-sigma) * dalpha
//   dxy      = dsigma * (a*dx + b*dy, b*dx + c*dy)
//   dconic   = dsigma * (dx*dx/2, dx*dy, dy*dy/2)
//   dcolor   = w_j * g_img
//
// and these are summed over every pixel of every tile into per-gaussian
// gradients (N, 6 + C) in original order, addressed by the gaussian id of the
// tile list: [dx, dy, da, db, dc, dopacity, dcolor[0..C)]. Pixels past H or W
// in edge tiles have no cotangent and add nothing.
//
// Bound: like B1 it is fp32 work per (pixel, gaussian) pair a pixel
// evaluates before it stops (alpha is recomputed), plus ~30 + 4C operations
// per composited pair and the sum over the tile's 256 pixels; the bytes
// (fields, residuals, cotangents in, (N, 6 + C) gradients out) are few, so on
// this card it is bound by operations.
//
// Design: one CTA per 16x16 tile, one thread per pixel carrying T, prefix
// and done, as the TPU kernel's state scratch did; the tile's gaussians are
// staged through shared memory 256 at a time and a warp walks only the
// gaussians whose footprint's box meets its two rows, as B1 does
// (blend_common.cuh), with the same sigma, alpha and T roundings, so B1, B2
// and the plain version take exactly the same pairs. The TPU grid ran in
// order and wrote race-free per-slot outputs; here the tiles run in
// parallel, so each warp sums over its pixels itself. For each gaussian that
// a lane of the warp composited, the F = 6 + C values are summed over the
// warp by a transposed butterfly (reduce-scatter): each shuffle step halves
// both the lanes a sum spans and the values a lane holds, so F values cost
// ceil(F/2) + ceil(F/4) + ... shuffles (12 at F = 9 or 10) where a tree per
// value costs 5F, and the F lanes that end up holding one field's total each
// add it into the global output in the same atomicAdd instruction, which the
// warp does not wait for. Summing by gaussian id, not by list position, keeps
// the TPU path's lost first slot when gaussian 0 is culled (ROADMAP C1) out
// of the port. The atomics make the order of the sum, and so the last bits,
// change from run to run.
//
// suffix_j = img . g - prefix_j is the TPU kernel's form; it loses digits
// against the plain version's reverse cumulative sum when the two terms are
// close, and 1/(1 - alpha) scales that loss by up to 1000 at the clamp.

#include "blend_common.cuh"

namespace {

using namespace gctorch_blend;

// 1 / x to about 1 ulp, one MUFU.RCP; x = 1 - alpha lies in [0.001, 1]
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The butterfly: while a lane holds N > 1 partial sums, the step over lane
// bit M sends the half it drops to the partner lane (lane ^ M) and adds the
// half it keeps to what the partner sent: the lanes with bit M clear keep
// values [0, H), the others [H, N), H = ceil(N/2). Once one value is left the
// remaining steps add the partners' values whole.
template <int N, int M>
__device__ __forceinline__ void scatter_sum(float (&v)[kLanes], int lane) {
  if constexpr (M > 0) {
    if constexpr (N == 1) {
      v[0] += __shfl_xor_sync(kFull, v[0], M);
      scatter_sum<1, M / 2>(v, lane);
    } else {
      constexpr int H = (N + 1) / 2;
      const bool upper = lane & M;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float lo = v[i];
        const float hi = i + H < N ? v[i + H] : 0.0f;
        v[i] = (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, M);
      }
      scatter_sum<H, M / 2>(v, lane);
    }
  }
}

// The value whose total scatter_sum<N, M> leaves on this lane, or -1 where
// the lane holds none or a copy another lane adds.
template <int N, int M>
__device__ __forceinline__ int scatter_field(int lane) {
  if constexpr (M == 0) {
    return N == 1 ? 0 : -1;
  } else if constexpr (N == 1) {
    return (lane & M) ? -1 : scatter_field<1, M / 2>(lane);
  } else {
    constexpr int H = (N + 1) / 2;
    if (lane & M) {
      const int f = scatter_field<H, M / 2>(lane);
      return f < 0 || H + f >= N ? -1 : H + f;
    }
    return scatter_field<H, M / 2>(lane);
  }
}

template <int C>
__global__ void __launch_bounds__(kTilePix, kMinBlocks<C>)
blend_bwd_kernel(const float* __restrict__ xys,      // (N, 2)
                 const float* __restrict__ conics,   // (N, 3)
                 const float* __restrict__ colors,   // (N, C)
                 const float* __restrict__ opacs,    // (N,)
                 const int* __restrict__ gid,        // (n_isects,) tile-sorted
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_cnt,
                 const float* __restrict__ img,      // (H, W, C) forward residual
                 const float* __restrict__ final_T,  // (H, W) forward residual
                 const float* __restrict__ g_img,    // (H, W, C) cotangent
                 const float* __restrict__ g_T,      // (H, W) cotangent
                 float* __restrict__ grads,          // (N, 6 + C), zeroed by the caller
                 int H, int W, int tiles_x) {
  constexpr int F = 6 + C;
  static_assert(F <= kLanes, "the butterfly leaves at most one value a lane");
  __shared__ Staged<C> s;
  __shared__ int s_g[kBatch];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & (kLanes - 1);
  int field = scatter_field<F, kLanes / 2>(lane);  // the sum this lane adds, or -1
  asm volatile("" : "+r"(field));  // kept in a register: not recomputed in the pair loop
  const int px = (tile % tiles_x) * kBlock + t % kBlock;
  const int py = (tile / tiles_x) * kBlock + t / kBlock;
  const float fpx = static_cast<float>(px);
  const float fpy = static_cast<float>(py);
  const int start = tile_start[tile];
  const int cnt = tile_cnt[tile];
  const Strip strip{static_cast<float>(px - t % kBlock),  // the warp's two rows of the tile
                    static_cast<float>(py - t / kBlock % 2), static_cast<float>(py - t / kBlock % 2 + 1)};

  // the pixel's cotangents (zero past the image edge) and
  // K = img . g_img + g_T * final_T
  float gi[C], K = 0.0f;
  bool done = !(px < W && py < H);
#pragma unroll
  for (int c = 0; c < C; ++c) gi[c] = 0.0f;
  if (!done) {
    const int p = py * W + px;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gi[c] = g_img[p * C + c];
      K += img[p * C + c] * gi[c];
    }
    K += g_T[p] * final_T[p];
  }
  float T = 1.0f, prefix = 0.0f;

  for (int b0 = 0; b0 < cnt; b0 += kBatch) {
    // Barrier: the previous batch is consumed before it is overwritten.
    if (__syncthreads_count(done) == kTilePix) break;
    const int j = b0 + t;
    s_g[t] = j < cnt ? gid[start + j] : -1;
    stage<C>(s, t, s_g[t], xys, conics, colors, opacs);
    __syncthreads();

    // slots past the list hold gaussians whose box is empty
    const int nb = min(kBatch, cnt - b0);
    for (int k32 = 0; k32 < nb && !__all_sync(kFull, done); k32 += kLanes) {
      unsigned cand = candidates<C>(s, k32, lane, strip);
      while (cand && !__all_sync(kFull, done)) {
        const int k = take_first(cand, k32);
        const float4 p0 = s[0][k], p1 = s[1][k];
        // a composited pair's dsigma, exp(-sigma) * dalpha and weight; 0 elsewhere
        float ds = 0.0f, de = 0.0f, w = 0.0f, dx = 0.0f, dy = 0.0f;
        bool hit = false;
        const Pair pr = pair_alpha(p0, p1, fpx, fpy);
        if (!done && pr.alpha >= kMinAlpha) {
          const float next_T = next_transmittance(T, pr.alpha);
          if (next_T <= kTEps) {
            done = true;
          } else {
            float col[C];
            colours<C>(s, k, p1, col);
            float cg = 0.0f;
#pragma unroll
            for (int c = 0; c < C; ++c) cg += gi[c] * col[c];
            w = pr.alpha * T;
            prefix += w * cg;
            // dalpha = T cg - (suffix + g_T final_T) / (1 - alpha), suffix = img . g_img - prefix
            const float dalpha = T * cg - (K - prefix) * rcp_approx(1.0f - pr.alpha);
            ds = -pr.oe * dalpha;
            de = pr.e * dalpha;
            dx = pr.dx;
            dy = pr.dy;
            T = next_T;
            hit = true;
          }
        }
        if (__any_sync(kFull, hit)) {
          // [dx, dy, da, db, dc, dopacity, dcolor] of the pair, 0 where not composited
          const float sx = ds * dx, sy = ds * dy;
          float v[kLanes] = {p0.z * sx + p0.w * sy, p0.w * sx + p1.x * sy, 0.5f * sx * dx, sx * dy,
                             0.5f * sy * dy, de};
#pragma unroll
          for (int c = 0; c < C; ++c) v[6 + c] = w * gi[c];
          scatter_sum<F, kLanes / 2>(v, lane);
          if (field >= 0 && v[0] != 0.0f) atomicAdd(grads + static_cast<long long>(s_g[k]) * F + field, v[0]);
        }
      }
    }
  }
}

template <int C>
void launch(const float* xys, const float* conics, const float* colors, const float* opacs,
            const int* gid, const int* tile_start, const int* tile_cnt, const float* img,
            const float* final_T, const float* g_img, const float* g_T, float* grads, int H,
            int W, int tiles_x, int tiles_y, cudaStream_t stream) {
  blend_bwd_kernel<C><<<tiles_x * tiles_y, kTilePix, 0, stream>>>(
      xys, conics, colors, opacs, gid, tile_start, tile_cnt, img, final_T, g_img, g_T, grads, H,
      W, tiles_x);
}

}  // namespace

// Plain C entry point for ctypes. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for C outside 1..8).
extern "C" int gctorch_blend_bwd(const float* xys, const float* conics, const float* colors,
                                 const float* opacs, const int* gid, const int* tile_start,
                                 const int* tile_cnt, const float* img, const float* final_T,
                                 const float* g_img, const float* g_T, float* grads, int H, int W,
                                 int tiles_x, int tiles_y, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GCT_CASE(n)                                                                            \
  case n:                                                                                      \
    launch<n>(xys, conics, colors, opacs, gid, tile_start, tile_cnt, img, final_T, g_img, g_T, \
              grads, H, W, tiles_x, tiles_y, s);                                               \
    break;
  switch (C) {
    GCT_CASE(1)
    GCT_CASE(2)
    GCT_CASE(3)
    GCT_CASE(4)
    GCT_CASE(5)
    GCT_CASE(6)
    GCT_CASE(7)
    GCT_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GCT_CASE
  return static_cast<int>(cudaGetLastError());
}
