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
// Design (simple and right): one CTA per tile, 256 threads, one thread per
// pixel. The tile's gaussians are staged through shared memory in batches of
// 256: each thread loads one gaussian's xy, conic, opacity and C <= 8
// channels by its id from the original-order arrays (14 floats, ~14 KB per
// batch), then every pixel walks the batch serially. The CTA leaves the tile
// as soon as all 256 pixels have stopped (__syncthreads_count).
//
// The file is compiled with -fmad=false, so sigma and alpha round exactly as
// the plain PyTorch version's separate elementwise operations do and the two
// agree bit for bit on which gaussians pass the alpha test. The remaining
// difference is the transmittance product: a serial product here, a cumprod
// there.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;  // threads per CTA, one per pixel
constexpr int kBatch = kPix;           // gaussians staged per batch, one per thread
constexpr float kAlphaClamp = 0.999f;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

template <int C>
__global__ void __launch_bounds__(kPix)
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
  __shared__ float s_x[kBatch], s_y[kBatch];
  __shared__ float s_a[kBatch], s_b[kBatch], s_c[kBatch], s_o[kBatch];
  __shared__ float s_col[C][kBatch];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int px = (tile % tiles_x) * kBlock + t % kBlock;
  const int py = (tile / tiles_x) * kBlock + t / kBlock;
  const float fpx = static_cast<float>(px);
  const float fpy = static_cast<float>(py);
  const int start = tile_start[tile];
  const int cnt = tile_cnt[tile];

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  int done = 0;

  for (int b0 = 0; b0 < cnt; b0 += kBatch) {
    // Barrier: the previous batch is consumed before it is overwritten.
    if (__syncthreads_count(done) == kPix) break;
    const int j = b0 + t;
    if (j < cnt) {
      const int g = gid[start + j];
      s_x[t] = xys[2 * g];
      s_y[t] = xys[2 * g + 1];
      s_a[t] = conics[3 * g];
      s_b[t] = conics[3 * g + 1];
      s_c[t] = conics[3 * g + 2];
      s_o[t] = opacs[g];
#pragma unroll
      for (int c = 0; c < C; ++c) s_col[c][t] = colors[g * C + c];
    }
    __syncthreads();
    if (done) continue;
    const int nb = min(kBatch, cnt - b0);
    for (int k = 0; k < nb; ++k) {
      const float dx = s_x[k] - fpx;
      const float dy = s_y[k] - fpy;
      const float sigma = 0.5f * (s_a[k] * dx * dx + s_c[k] * dy * dy) + s_b[k] * dx * dy;
      if (sigma < 0.0f) continue;
      const float alpha = fminf(kAlphaClamp, s_o[k] * expf(-sigma));
      if (alpha < kMinAlpha) continue;
      const float next_T = T * (1.0f - alpha);
      if (next_T <= kTEps) {
        done = 1;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * s_col[c][k];
      T = next_T;
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
  blend_fwd_kernel<C><<<tiles_x * tiles_y, kPix, 0, stream>>>(
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
