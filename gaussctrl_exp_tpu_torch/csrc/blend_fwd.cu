// Kernel B1: tile blend forward for Hopper (sm_90a).
//
// Replaces gaussctrl_exp_tpu/ops/blend_pallas.py:_fwd_kernel, the Pallas TPU
// kernel that composites each 16x16 tile front to back over its depth-sorted
// gaussians. For each pixel (integer coordinates, no +0.5), over the tile's
// list in depth order:
//
//   sigma  = 0.5 * (a*dx*dx + c*dy*dy) + b*dx*dy;   skip if sigma < 0
//   alpha  = min(0.999, o * exp(-sigma));           skip if alpha < 1/255
//   next_T = T * (1 - alpha);                       stop, without compositing, if next_T <= 1e-4
//   img   += alpha * T * color[0..C);  T = next_T
//
// Outputs img (H, W, C) and final_T (H, W) in image layout. Tiles with no
// gaussians give img 0 and T 1; pixels past H or W in edge tiles compute but
// do not write.
//
// Bound: the work is ~(20 + 2C) fp32 operations per (pixel, gaussian) pair a
// pixel evaluates before it stops, against a few bytes per gaussian read and
// (C + 1) floats per pixel written, so on this card it is bound by operations,
// not bytes. The TPU kernel re-expressed the serial loop as matrix products;
// here the loop stays serial per pixel, which is what the card is good at.
//
// Design: one CTA per tile, 256 threads, one thread per pixel. The tile's
// gaussians are staged through shared memory 256 at a time as packed float4s
// (blend_common.cuh), so a pair costs two 16-byte broadcast loads to be
// evaluated and one or two more to be composited. A warp (two rows of the
// tile) takes 32 gaussians at a time: each lane tests one gaussian's
// footprint box against the warp's pixels, and a ballot leaves the ones that
// some pixel of the warp may take. A pair far outside a gaussian
// (sigma past log(255 * opacity) plus a margin) skips its exponential. A
// warp leaves the batch when its 32 pixels have stopped, the CTA the tile
// when all 256 have (__syncthreads_count). sigma, alpha and T round as in
// the plain PyTorch version (blend_common.cuh), so the two take the same
// pairs; the transmittance differs only as a serial product against a
// cumprod.

#include "blend_common.cuh"

namespace {

using namespace gctorch_blend;

template <int C>
__global__ void __launch_bounds__(kTilePix, kMinBlocks<C>)
blend_fwd_kernel(const float* __restrict__ xys,     // (N, 2)
                 const float* __restrict__ conics,  // (N, 3)
                 const float* __restrict__ colors,  // (N, C)
                 const float* __restrict__ opacs,   // (N,)
                 const int* __restrict__ gid,       // (n_isects,) tile-sorted
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_cnt,
                 float* __restrict__ img,      // (H, W, C)
                 float* __restrict__ final_T,  // (H, W)
                 int H, int W, int tiles_x) {
  __shared__ Staged<C> s;

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int px = (tile % tiles_x) * kBlock + t % kBlock;
  const int py = (tile / tiles_x) * kBlock + t / kBlock;
  const float fpx = static_cast<float>(px);
  const float fpy = static_cast<float>(py);
  const int lane = t & (kLanes - 1);
  const int start = tile_start[tile];
  const int cnt = tile_cnt[tile];
  const Strip strip{static_cast<float>(px - t % kBlock),  // the warp's two rows of the tile
                    static_cast<float>(py - t / kBlock % 2), static_cast<float>(py - t / kBlock % 2 + 1)};

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  int done = 0;

  for (int b0 = 0; b0 < cnt; b0 += kBatch) {
    // Barrier: the previous batch is consumed before it is overwritten.
    if (__syncthreads_count(done) == kTilePix) break;
    const int j = b0 + t;
    stage<C>(s, t, j < cnt ? gid[start + j] : -1, xys, conics, colors, opacs);
    __syncthreads();
    // slots past the list hold gaussians whose box is empty
    const int nb = min(kBatch, cnt - b0);
    for (int k32 = 0; k32 < nb && !__all_sync(kFull, done); k32 += kLanes) {
      unsigned cand = candidates<C>(s, k32, lane, strip);
      while (cand) {
        const int k = take_first(cand, k32);
        const float4 p1 = s[1][k];
        const float alpha = pair_alpha(s[0][k], p1, fpx, fpy).alpha;
        if (done || alpha < kMinAlpha) continue;
        const float next_T = next_transmittance(T, alpha);
        if (next_T <= kTEps) {
          done = 1;
          continue;
        }
        float col[C];
        colours<C>(s, k, p1, col);
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * col[c];
        T = next_T;
      }
    }
  }

  if (px < W && py < H) {
    const int p = py * W + px;
#pragma unroll
    for (int c = 0; c < C; ++c) img[p * C + c] = acc[c];
    final_T[p] = T;
  }
}

template <int C>
void launch(const float* xys, const float* conics, const float* colors, const float* opacs,
            const int* gid, const int* tile_start, const int* tile_cnt, float* img,
            float* final_T, int H, int W, int tiles_x, int tiles_y, cudaStream_t stream) {
  blend_fwd_kernel<C><<<tiles_x * tiles_y, kTilePix, 0, stream>>>(
      xys, conics, colors, opacs, gid, tile_start, tile_cnt, img, final_T, H, W, tiles_x);
}

}  // namespace

// Plain C entry point for ctypes. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for C outside 1..8).
extern "C" int gctorch_blend_fwd(const float* xys, const float* conics, const float* colors,
                                 const float* opacs, const int* gid, const int* tile_start,
                                 const int* tile_cnt, float* img, float* final_T, int H, int W,
                                 int tiles_x, int tiles_y, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GCT_CASE(n)                                                                         \
  case n:                                                                                   \
    launch<n>(xys, conics, colors, opacs, gid, tile_start, tile_cnt, img, final_T, H, W, \
              tiles_x, tiles_y, s);                                                         \
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
