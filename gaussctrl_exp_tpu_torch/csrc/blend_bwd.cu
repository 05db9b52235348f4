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
// Design (simple and right, the shape of B1): one CTA per 16x16 tile, one
// thread per pixel carrying T, prefix and done, as the TPU kernel's state
// scratch did; the tile's gaussians are staged through shared memory 256 at a
// time. The TPU grid ran in order and wrote race-free per-slot outputs; here
// the tiles run in parallel, so the CTA reduces across its pixels itself:
// for each gaussian of the batch the 6 + C values are summed over the warp
// with __shfl_down_sync (skipped when __any_sync says no lane composited
// it), lane 0 adds the warp's sums into a (6 + C, 256) shared buffer with
// shared atomics, and after the batch one thread per gaussian adds the
// buffer's non-zero entries into the global output with atomicAdd. Summing by
// gaussian id, not by list position, keeps the TPU path's lost first slot
// when gaussian 0 is culled (ROADMAP C1) out of the port. The atomics make
// the order of the sum, and so the last bits, change from run to run.
//
// suffix_j = img . g - prefix_j is the TPU kernel's form; it loses digits
// against the plain version's reverse cumulative sum when the two terms are
// close, and 1/(1 - alpha) scales that loss by up to 1000 at the clamp.
//
// Compiled with -fmad=false like B1, so sigma and alpha round as in B1 and the
// plain PyTorch version, and all three keep exactly the same pairs.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;  // threads per CTA, one per pixel
constexpr int kBatch = kPix;           // gaussians staged per batch, one per thread
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaClamp = 0.999f;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

template <int C>
__global__ void __launch_bounds__(kPix)
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
  __shared__ int s_g[kBatch];
  __shared__ float s_x[kBatch], s_y[kBatch];
  __shared__ float s_a[kBatch], s_b[kBatch], s_c[kBatch], s_o[kBatch];
  __shared__ float s_col[C][kBatch];
  __shared__ float s_grad[F][kBatch];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int px = (tile % tiles_x) * kBlock + t % kBlock;
  const int py = (tile / tiles_x) * kBlock + t / kBlock;
  const float fpx = static_cast<float>(px);
  const float fpy = static_cast<float>(py);
  const int start = tile_start[tile];
  const int cnt = tile_cnt[tile];

  // per-pixel cotangents and residuals; zero past the image edge
  float gi[C];
  float img_dot_g = 0.0f, gT_Tf = 0.0f;
  const bool inside = px < W && py < H;
  if (inside) {
    const int p = py * W + px;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gi[c] = g_img[p * C + c];
      img_dot_g += img[p * C + c] * gi[c];
    }
    gT_Tf = g_T[p] * final_T[p];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) gi[c] = 0.0f;
  }

  float T = 1.0f;
  float prefix = 0.0f;
  int done = inside ? 0 : 1;

  for (int b0 = 0; b0 < cnt; b0 += kBatch) {
    // Barrier: the previous batch is consumed before it is overwritten.
    if (__syncthreads_count(done) == kPix) break;
    const int j = b0 + t;
    if (j < cnt) {
      const int g = gid[start + j];
      s_g[t] = g;
      s_x[t] = xys[2 * g];
      s_y[t] = xys[2 * g + 1];
      s_a[t] = conics[3 * g];
      s_b[t] = conics[3 * g + 1];
      s_c[t] = conics[3 * g + 2];
      s_o[t] = opacs[g];
#pragma unroll
      for (int c = 0; c < C; ++c) s_col[c][t] = colors[g * C + c];
    }
#pragma unroll
    for (int f = 0; f < F; ++f) s_grad[f][t] = 0.0f;
    __syncthreads();

    const int nb = min(kBatch, cnt - b0);
    // a warp whose 32 pixels have all stopped adds nothing to this batch
    if (!__all_sync(kFull, done)) {
      for (int k = 0; k < nb; ++k) {
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = 0.0f;
        bool hit = false;
        if (!done) {
          const float dx = s_x[k] - fpx;
          const float dy = s_y[k] - fpy;
          const float sigma = 0.5f * (s_a[k] * dx * dx + s_c[k] * dy * dy) + s_b[k] * dx * dy;
          if (sigma >= 0.0f) {
            const float e = expf(-sigma);
            const float alpha = fminf(kAlphaClamp, s_o[k] * e);
            if (alpha >= kMinAlpha) {
              const float one_m = 1.0f - alpha;
              const float next_T = T * one_m;
              if (next_T <= kTEps) {
                done = 1;
              } else {
                const float w = alpha * T;
                float cg = 0.0f;
#pragma unroll
                for (int c = 0; c < C; ++c) cg += gi[c] * s_col[c][k];
                prefix += w * cg;
                const float suffix = img_dot_g - prefix;
                const float dalpha = T * cg - (suffix + gT_Tf) / one_m;
                const float dsigma = -s_o[k] * e * dalpha;
                v[0] = dsigma * (s_a[k] * dx + s_b[k] * dy);
                v[1] = dsigma * (s_b[k] * dx + s_c[k] * dy);
                v[2] = dsigma * 0.5f * dx * dx;
                v[3] = dsigma * dx * dy;
                v[4] = dsigma * 0.5f * dy * dy;
                v[5] = e * dalpha;
#pragma unroll
                for (int c = 0; c < C; ++c) v[6 + c] = w * gi[c];
                T = next_T;
                hit = true;
              }
            }
          }
        }
        if (__any_sync(kFull, hit)) {
#pragma unroll
          for (int f = 0; f < F; ++f) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v[f] += __shfl_down_sync(kFull, v[f], off);
          }
          if (lane == 0) {
#pragma unroll
            for (int f = 0; f < F; ++f) atomicAdd(&s_grad[f][k], v[f]);
          }
        }
      }
    }
    __syncthreads();
    if (j < cnt) {
      float* out = grads + static_cast<long long>(s_g[t]) * F;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float val = s_grad[f][t];
        if (val != 0.0f) atomicAdd(out + f, val);
      }
    }
  }
}

template <int C>
void launch(const float* xys, const float* conics, const float* colors, const float* opacs,
            const int* gid, const int* tile_start, const int* tile_cnt, const float* img,
            const float* final_T, const float* g_img, const float* g_T, float* grads, int H,
            int W, int tiles_x, int tiles_y, cudaStream_t stream) {
  blend_bwd_kernel<C><<<tiles_x * tiles_y, kPix, 0, stream>>>(
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
