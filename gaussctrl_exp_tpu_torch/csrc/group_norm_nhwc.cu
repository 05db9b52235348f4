// Kernel N1: GroupNorm, and optionally SiLU after it, of bf16 activations
// stored channels-last (B, H, W, C), with float32 scale and bias.
//
// Replaces no TPU kernel: the JAX package leaves Flax's GroupNorm to XLA,
// which fuses the statistics and the affine into the surrounding ops. It was
// added because the port's UNet and ControlNet keep their activations NHWC on
// the card (cuDNN's Hopper bf16 convolutions are NHWC), and PyTorch's CUDA
// group_norm takes only NCHW-contiguous input: every one of the 88 norms of an
// ε step would otherwise copy its input to NCHW and its output back, beside
// the float32 cast, the norm, the cast back and the SiLU, each a pass of its
// own over the activation.
//
// What it computes, as the port's bf16 norm did (diffusion/layers.py):
// float32 statistics of each (sample, group) over H·W·C/G values, the biased
// variance, rstd = rsqrt(var + eps); y = x·a + b with a = rstd·scale and
// b = bias − a·mean in float32, rounded once to bf16 (Flax's order); with
// SiLU, silu of that bf16 value in float32, rounded again (F.silu on bf16).
// Only the summation order of the statistics differs from torch's.
//
// What bounds it. The bytes: one read of x for the statistics, one more for
// the affine (from L2 where the activation fits, as at B = 1: 2.6 MB at
// 64² × 320) and one write of y, 3 × B·H·W·C × 2 bytes against HBM's
// 3.35 TB/s. At B = 1 a call is a few µs and latency-bound; torch's
// statistics ran one CTA per (sample, group), 32 CTAs on 132 SMs.
//
// Design. Two launches, no atomics, so a call is deterministic and a CUDA
// graph replays it bit for bit.
//  * Both passes run a grid of (K chunks of P positions, B samples); the
//    wrapper (ops/groupnorm_cuda.py) picks K for about two CTAs an SM in one
//    wave, but at most one chunk an SM a sample: each CTA of pass 2 merges
//    its sample's K partials, and at B = 1 that merge, not the bytes, sets
//    the pace. A CTA has R rows of V = C/8 threads: thread (r, v) owns
//    channels 8v..8v+7 and walks positions r, r + R, ... of its chunk with
//    16-byte loads, four in flight, neighbouring threads on neighbouring
//    bytes. A vector may straddle two groups (C/G = 10, 30), so the
//    statistics are taken per channel first and merged into groups after.
//  * Statistics (pass 1): Welford per channel in registers (one reciprocal a
//    vector, shared by its 8 channels), then Chan's merge over the R rows in
//    shared memory, then each group of the chunk from its channels' equal
//    counts, a warp a group: mean of the means, M2 = ΣM2 + n·Σ(mean_c −
//    mean)², each sum over lanes and a butterfly. The chunk's (mean, M2)
//    per group go to a float32 workspace laid out [b][k][g].
//  * Apply (pass 2): every CTA first merges its sample's K partials: thread
//    (s, g) merges chunks s, s + S, ... of group g (S = threads / G slices,
//    neighbouring threads on neighbouring partials, four loads in flight),
//    then one thread a group merges the S slices, Chan's merge throughout. A
//    thread then forms a and b for its 8 channels once and streams its
//    positions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int VEC = 8;  // bf16 values in a 16-byte vector

// (n, mean, m2) ← the merge of itself and (nb, meanb, m2b): Chan et al.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float meanb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = meanb;
    m2 = m2b;
    return;
  }
  const float nn = n + nb;
  const float delta = meanb - mean;
  const float fb = nb / nn;
  mean = fmaf(delta, fb, mean);
  m2 = m2 + m2b + delta * delta * n * fb;
  n = nn;
}

__device__ __forceinline__ void unpack(const uint4& q, float f[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Positions of a chunk [p0, p0 + len) that row r of R walks.
__device__ __forceinline__ int row_count(int len, int r, int R) { return r < len ? (len - 1 - r) / R + 1 : 0; }

constexpr int UNROLL = 4;  // vectors a thread has in flight

__device__ __forceinline__ void welford(float& n, float mean[VEC], float m2[VEC], const uint4& q) {
  float f[VEC];
  unpack(q, f);
  n += 1.f;
  const float inv = 1.f / n;
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    const float d = f[c] - mean[c];
    mean[c] = fmaf(d, inv, mean[c]);
    m2[c] = fmaf(d, f[c] - mean[c], m2[c]);
  }
}

__global__ void __launch_bounds__(512) gctorch_gn_nhwc_stats(const uint4* __restrict__ x, float2* __restrict__ part,
                                                             int HW, int C, int G, int P) {
  extern __shared__ float smem[];
  const int V = C / VEC, R = blockDim.x / V;
  const int v = threadIdx.x % V, r = threadIdx.x / V;
  const int k = blockIdx.x, K = gridDim.x, b = blockIdx.y;
  const int p0 = k * P, len = min(P, HW - p0);
  float* s_mean = smem;        // [R][C]
  float* s_m2 = smem + R * C;  // [R][C]

  if (r < R) {
    float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) mean[c] = m2[c] = 0.f;
    const uint4* src = x + (static_cast<size_t>(b) * HW + p0) * V + v;
    int p = r;
    for (; p + (UNROLL - 1) * R < len; p += UNROLL * R) {
      uint4 q[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) q[u] = __ldg(src + static_cast<size_t>(p + u * R) * V);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) welford(n, mean, m2, q[u]);
    }
    for (; p < len; p += R) welford(n, mean, m2, __ldg(src + static_cast<size_t>(p) * V));
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      s_mean[r * C + VEC * v + c] = mean[c];
      s_m2[r * C + VEC * v + c] = m2[c];
    }
  }
  __syncthreads();

  // each channel over the rows, into row 0 (a channel is one thread's alone)
  for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int rr = 0; rr < R; ++rr)
      chan_merge(n, mean, m2, static_cast<float>(row_count(len, rr, R)), s_mean[rr * C + ch], s_m2[rr * C + ch]);
    s_mean[ch] = mean;
    s_m2[ch] = m2;
  }
  __syncthreads();

  // each group of the chunk from its channels, all of count len: a warp a
  // group, lanes over its channels, sums by a butterfly
  const int Cg = C / G, warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int g = warp; warp < warps && g < G; g += warps) {  // whole warps only: blockDim may end in a part warp
    float sum = 0.f;
    for (int c = lane; c < Cg; c += 32) sum += s_mean[g * Cg + c];
    const float gmean = warp_sum(sum) / static_cast<float>(Cg);
    float m2 = 0.f, dev = 0.f;
    for (int c = lane; c < Cg; c += 32) {
      const float d = s_mean[g * Cg + c] - gmean;
      m2 += s_m2[g * Cg + c];
      dev = fmaf(d, d, dev);
    }
    m2 = warp_sum(m2);
    dev = warp_sum(dev);
    if (lane == 0)
      part[(static_cast<size_t>(b) * K + k) * G + g] = make_float2(gmean, fmaf(static_cast<float>(len), dev, m2));
  }
}

__device__ __forceinline__ uint4 affine(const uint4& q, const float a[VEC], const float sh[VEC], int silu) {
  float f[VEC];
  unpack(q, f);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    __nv_bfloat16 lo = __float2bfloat16_rn(fmaf(f[2 * i], a[2 * i], sh[2 * i]));
    __nv_bfloat16 hi = __float2bfloat16_rn(fmaf(f[2 * i + 1], a[2 * i + 1], sh[2 * i + 1]));
    if (silu) {
      const float l = __bfloat162float(lo), h = __bfloat162float(hi);
      lo = __float2bfloat16_rn(l / (1.f + expf(-l)));
      hi = __float2bfloat16_rn(h / (1.f + expf(-h)));
    }
    o[i] = __halves2bfloat162(lo, hi);
  }
  return out;
}

__global__ void __launch_bounds__(512) gctorch_gn_nhwc_apply(const uint4* __restrict__ x, uint4* __restrict__ y,
                                                             const float2* __restrict__ part,
                                                             const float* __restrict__ scale,
                                                             const float* __restrict__ bias, int HW, int C, int G,
                                                             int P, float eps, int silu) {
  extern __shared__ float smem[];
  const int S = blockDim.x / G;  // slices of the chunks: thread (s, g) merges chunks s, s + S, ... of group g
  float* s_n = smem;                 // [S][G]
  float* s_mean = smem + S * G;      // [S][G], then the groups' means in [0, G)
  float* s_m2 = smem + 2 * S * G;    // [S][G], then the groups' rstd in [0, G)
  const int k = blockIdx.x, K = gridDim.x, b = blockIdx.y;
  const int Cg = C / G, t = threadIdx.x;

  // the sample's statistics from the K partials: loads of neighbouring threads
  // on neighbouring groups, UNROLL in flight a thread, then the slices merged
  if (t < S * G) {
    const int g = t % G, s = t / G;
    const float2* src = part + static_cast<size_t>(b) * K * G + g;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    int kk = s;
    for (; kk + (UNROLL - 1) * S < K; kk += UNROLL * S) {
      float2 pm[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) pm[u] = src[static_cast<size_t>(kk + u * S) * G];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        chan_merge(n, mean, m2, static_cast<float>(min(P, HW - (kk + u * S) * P) * Cg), pm[u].x, pm[u].y);
    }
    for (; kk < K; kk += S) {
      const float2 pm = src[static_cast<size_t>(kk) * G];
      chan_merge(n, mean, m2, static_cast<float>(min(P, HW - kk * P) * Cg), pm.x, pm.y);
    }
    s_n[t] = n;
    s_mean[t] = mean;
    s_m2[t] = m2;
  }
  __syncthreads();
  float gn = 0.f, gmean = 0.f, gm2 = 0.f;
  if (t < G) {  // thread t alone reads and writes column t
    for (int s = 0; s < S; ++s) chan_merge(gn, gmean, gm2, s_n[s * G + t], s_mean[s * G + t], s_m2[s * G + t]);
    s_mean[t] = gmean;
    s_m2[t] = rsqrtf(fmaxf(gm2 / gn, 0.f) + eps);
  }
  __syncthreads();

  const int V = C / VEC, R = blockDim.x / V;
  const int v = t % V, r = t / V;
  if (r >= R) return;
  float a[VEC], sh[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    const int ch = VEC * v + c, g = ch / Cg;
    a[c] = s_m2[g] * scale[ch];
    sh[c] = fmaf(-a[c], s_mean[g], bias[ch]);
  }
  const int p0 = k * P, len = min(P, HW - p0);
  const size_t base = (static_cast<size_t>(b) * HW + p0) * V + v;
  int p = r;
  for (; p + (UNROLL - 1) * R < len; p += UNROLL * R) {
    uint4 q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) q[u] = __ldg(x + base + static_cast<size_t>(p + u * R) * V);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) y[base + static_cast<size_t>(p + u * R) * V] = affine(q[u], a, sh, silu);
  }
  for (; p < len; p += R) {
    const size_t at = base + static_cast<size_t>(p) * V;
    y[at] = affine(__ldg(x + at), a, sh, silu);
  }
}

}  // namespace

// x and y: (B, HW, C) bf16, 16-byte aligned; scale, bias: (C,) float32;
// part: a float32 workspace of B·K·G float2; G ≤ 32. The wrapper chooses K
// chunks of P positions (K·P ≥ HW > (K − 1)·P) and R rows of C/8 threads.
extern "C" int gctorch_group_norm_nhwc(const void* x, void* y, const float* scale, const float* bias, void* part,
                                       int B, int HW, int C, int G, int K, int P, int R, float eps, int silu,
                                       void* stream) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % VEC != 0 || G <= 0 || C % G != 0 || K <= 0 || P <= 0 ||
      static_cast<long long>(K) * P < HW || static_cast<long long>(K - 1) * P >= HW || R <= 0 ||
      R * (C / VEC) > 512 || R * (C / VEC) < 32 || G > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(K, B), block(R * (C / VEC));
  gctorch_gn_nhwc_stats<<<grid, block, 2 * R * C * sizeof(float), st>>>(static_cast<const uint4*>(x),
                                                                         static_cast<float2*>(part), HW, C, G, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gctorch_gn_nhwc_apply<<<grid, block, 3 * (block.x / G) * G * sizeof(float), st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), static_cast<const float2*>(part), scale, bias, HW, C, G,
      P, eps, silu);
  return static_cast<int>(cudaGetLastError());
}
