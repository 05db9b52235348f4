// Kernel E1: the depth generator's epipolar cross-view term, one launch for
// each mixing self-attention (diffusion/correspondence.py,
// make_multires_epipolar_processor).
//
// Replaces no TPU kernel: the JAX package leaves the term to XLA (a gather
// of the 9 taps' keys and values, two einsums, the softmax, the mean over
// partners and the mix, per ordered view pair). The port composed it the
// same way, ~15 torch ops a pair on (H, S, 9, D) gathered copies, 24 pairs a
// layer: ~6,000 small ops a sampling step, most of them waiting on the host.
//
// What it computes, for every row bi = (g, a) of the CFG-doubled batch (g the
// group, a the view) and every query token s:
//   out[bi] = mix · os[bi] + (1 − mix) · x,  x = Σ_b pm[a, b] · epi_b / max(Σ_b pm[a, b], 1)
// over the partners b the pair mask keeps (x = os[bi] for a row with none),
// with epi_b, per head, the softmax of the 9 logits q · k_t · D^-½ +
// log(max(w_t, 1e-12)) over the taps t of table (a, b) at s, and the
// probability-weighted sum of the 9 value rows of view g·V + b. os is the
// self-attention (kernel B3's output). The dot products, the softmax and
// every sum run in float32 (FMA) for bf16 and float32 inputs alike; out is
// rounded once to the input's type. The epilogue's two products and their
// sum round as the plain version's three ops do (no FMA), so an isolated
// row gives its bits.
//
// What bounds it. Per attended pair the bytes: a's queries, b's keys and
// values, the pair's table and the output, 4·(4·S·C + 2·9·S) in float32
// (benchmark/counts/epipolar.py's floor, 1.34 ms a sampling step of 24 pairs
// a layer); the products (2 · 2 · 9 · C a token) are ~1 operation a byte.
// The kernel reads each tap's K and V rows where they lie, 18 rows of C
// channels a (token, partner), so its traffic is ~4.5× the floor's K/V reads
// at 64²; neighbouring queries share most taps, and a partner's K and V
// (10.5 MB at 64² in float32) stay in the 50 MB L2. It is bound by the L1/L2
// gathers and their latency, not by HBM.
//
// Design. A warp takes one query token of one row across all H heads: the H·D
// = C channels of a token are one contiguous row, so each tap's K or V row is
// one contiguous read whose 9 indices and log-weights serve every head. A
// head's channels lie on G = 32 / H' lanes (H' the power of two ≥ H), lane
// (h, i) holding 16-byte vectors i, i + G, ... of head h (VPL of them at
// most): a load instruction reads whole 32-byte sectors of each head, and a
// head's dot product is a butterfly over its G lanes. Per partner, lanes 0-8
// load the token's 9 indices and log-weights and broadcast them; the 9 K
// rows' partial dots are all issued before any reduction, so their loads
// are in flight together; then the 9 reductions, the softmax (every lane of
// a head holds its 9 logits) and the 9 V rows, weighted by pm[a, b] times
// the probability into one float32 accumulator. The epilogue divides by the
// row's divisor, mixes with os and writes out once. A CTA holds 8 warps on 8
// consecutive tokens of one row, so they meet the same taps in L1. The tables
// (int32 indices, float32 log-weights) and the partner plan are made once
// when the processor is built (ops/epipolar_cuda.py); the host does no work
// per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 9;
constexpr int WARPS = 8;  // query tokens a CTA: one warp a token
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, h, s;  // elements between batches, heads and tokens; channels contiguous
};

// 16 bytes of T as floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load(const float* p, float f[E]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float f[E]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float f[E]) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float f[E]) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < E / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = x;
  }
};

// partners: per view a, [n, b_0, ..., b_{n-1}, ...] (V + 1 ints); weights:
// [divisor max(Σ_b pm[a, b], 1), pm[a, b_0], ...] (V + 1 floats)
template <typename T, int VPL>
__global__ void __launch_bounds__(WARPS * 32)
    gctorch_epipolar_e1(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ os, T* __restrict__ out, const int* __restrict__ idx,
                        const float* __restrict__ logw, const int* __restrict__ partners,
                        const float* __restrict__ weights, int H, int S, int D, int V, int G, Strides qs, Strides ks,
                        Strides vs, Strides oss, Strides outs, float scale, float mix, float rest) {
  constexpr int E = Vec<T>::E;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= S) return;  // the whole warp
  const int bi = blockIdx.y, g = bi / V, a = bi - g * V;
  const int h = lane / G, i = lane - h * G, NV = D / E;
  const bool head = h < H;

  float qf[VPL][E], acc[VPL][E];
  const T* qr = q + bi * qs.b + h * qs.h + s * qs.s;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
#pragma unroll
    for (int e = 0; e < E; ++e) qf[j][e] = acc[j][e] = 0.f;
    const int vi = i + j * G;
    if (head && vi < NV) Vec<T>::load(qr + vi * E, qf[j]);
  }

  const int n = __ldg(partners + a * (V + 1));
  for (int p = 0; p < n; ++p) {
    const int b = __ldg(partners + a * (V + 1) + 1 + p);
    const float w = __ldg(weights + a * (V + 1) + 1 + p);
    const int kb = g * V + b;
    const long long tab = (static_cast<long long>(a * V + b) * S + s) * TAPS;
    int my_row = 0;
    float my_lw = 0.f;
    if (lane < TAPS) {
      my_row = min(max(__ldg(idx + tab + lane), 0), S - 1);
      my_lw = __ldg(logw + tab + lane);
    }
    const T* kr = k + kb * ks.b + h * ks.h;
    const T* vr = v + kb * vs.b + h * vs.h;
    int row[TAPS];
    float l[TAPS];
#pragma unroll
    for (int t = 0; t < TAPS; ++t) row[t] = __shfl_sync(FULL, my_row, t);
    // the 9 partial dots, every load issued before the first reduction
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int vi = i + j * G;
        if (head && vi < NV) {
          float kf[E];
          Vec<T>::load(kr + row[t] * ks.s + vi * E, kf);
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qf[j][e], kf[e], dot);
        }
      }
      l[t] = dot;
    }
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      for (int off = G >> 1; off > 0; off >>= 1) l[t] += __shfl_xor_sync(FULL, l[t], off);
      l[t] = l[t] * scale + __shfl_sync(FULL, my_lw, t);
    }
    float m = l[0];
#pragma unroll
    for (int t = 1; t < TAPS; ++t) m = fmaxf(m, l[t]);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      l[t] = expf(l[t] - m);
      sum += l[t];
    }
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const float pw = w * (l[t] / sum);
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int vi = i + j * G;
        if (head && vi < NV) {
          float vf[E];
          Vec<T>::load(vr + row[t] * vs.s + vi * E, vf);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] = fmaf(pw, vf[e], acc[j][e]);
        }
      }
    }
  }

  if (!head) return;
  const float div = __ldg(weights + a * (V + 1));
  const T* osr = os + bi * oss.b + h * oss.h + s * oss.s;
  T* outr = out + bi * outs.b + h * outs.h + s * outs.s;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int vi = i + j * G;
    if (vi >= NV) continue;
    float o[E], y[E];
    Vec<T>::load(osr + vi * E, o);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float x = n ? acc[j][e] / div : o[e];
      y[e] = __fadd_rn(__fmul_rn(mix, o[e]), __fmul_rn(rest, x));
    }
    Vec<T>::store(outr + vi * E, y);
  }
}

// VPL rounded up to an instantiated width
template <typename T, typename F>
cudaError_t with_vpl(int vpl, F&& launch) {
  if (vpl <= 1) return launch(gctorch_epipolar_e1<T, 1>);
  if (vpl <= 2) return launch(gctorch_epipolar_e1<T, 2>);
  if (vpl <= 3) return launch(gctorch_epipolar_e1<T, 3>);
  if (vpl <= 5) return launch(gctorch_epipolar_e1<T, 5>);
  if (vpl <= 10) return launch(gctorch_epipolar_e1<T, 10>);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_e1(const void* q, const void* k, const void* v, const void* os, void* out, const int* idx,
                      const float* logw, const int* partners, const float* weights, int B, int H, int S, int D, int V,
                      int G, int vpl, Strides qs, Strides ks, Strides vs, Strides oss, Strides outs, float scale,
                      float mix, float rest, cudaStream_t st) {
  return with_vpl<T>(vpl, [&](auto kernel) {
    kernel<<<dim3((S + WARPS - 1) / WARPS, B), WARPS * 32, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(os),
        static_cast<T*>(out), idx, logw, partners, weights, H, S, D, V, G, qs, ks, vs, oss, outs, scale, mix, rest);
    return cudaGetLastError();
  });
}

}  // namespace

// q, k, v, os, out: (B, H, S, D) with the given element strides (batch, head,
// token), channels contiguous, every row on a 16-byte boundary; bf16 or
// float32 alike. idx (int32), logw (float32): (V, V, S, 9) contiguous;
// partners (int32), weights (float32): (V, V + 1) as above. B a multiple of V;
// G lanes a head (a power of two, G·H ≤ 32); vpl the 16-byte vectors a lane
// holds of a head (≤ 10). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int gctorch_epipolar_attn(const void* q, const void* k, const void* v, const void* os, void* out,
                                     const void* idx, const void* logw, const void* partners, const void* weights,
                                     int B, int H, int S, int D, int V, int G, int vpl, int is_bf16, long long q_sb,
                                     long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                                     long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                                     long long o_ss, long long out_sb, long long out_sh, long long out_ss,
                                     float scale, float mix, float rest, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || S <= 0 || D <= 0 || D % 8 != 0 || V <= 0 || B % V != 0 || G <= 0 ||
      (G & (G - 1)) != 0 || G * H > 32 || vpl <= 0 || vpl > 10)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss}, oss{o_sb, o_sh, o_ss},
      outs{out_sb, out_sh, out_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* lw = static_cast<const float*>(logw);
  const int* pp = static_cast<const int*>(partners);
  const float* wp = static_cast<const float*>(weights);
  const cudaError_t e =
      is_bf16 ? launch_e1<__nv_bfloat16>(q, k, v, os, out, ip, lw, pp, wp, B, H, S, D, V, G, vpl, qs, ks, vs, oss,
                                         outs, scale, mix, rest, st)
              : launch_e1<float>(q, k, v, os, out, ip, lw, pp, wp, B, H, S, D, V, G, vpl, qs, ks, vs, oss, outs,
                                 scale, mix, rest, st);
  return static_cast<int>(e);
}
