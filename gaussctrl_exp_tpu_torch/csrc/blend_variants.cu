// Kernel B1v: the blend-forward ablations of the variant benchmark, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/bench_blend_variants.py,
// make_fwd_kernel(mode) and make_pair_kernel(): copies of kernel B1
// (blend_pallas.py:_fwd_kernel) that differ inside one chunk of 128 slots of
// a tile's depth-sorted list. Per pixel and slot of a chunk:
//
//   sigma = 0.5 * (a*dx*dx + c*dy*dy) + b*dx*dy
//   vis   = exp(-sigma)           (notrans: 1 / (1 + sigma))
//   alpha = min(0.999, o * vis);  aeff = alpha if sigma >= 0, alpha >= 1/255
//                                 and the slot is in the list, else 0
//   T_excl = T_carry * exp(sum of log1p(-aeff) over the earlier slots of
//            the chunk)           (notrans: of -aeff; scan: T_carry times the
//                                 product of (1 - aeff); nomatmul: T_carry)
//   T_after = T_excl * (1 - aeff)
//   composited if T_after > 1e-4, aeff > 0 and the pixel is not done:
//     img += aeff * T_excl * colour, T_new = min(T_new, T_after)
//   done |= some slot with aeff > 0 has T_after <= 1e-4
//
// T and the done flag carry from chunk to chunk (T_new starts at T_carry).
// "empty" writes the init (image 0, T 1, done 0) only. "pair" composites the
// chunks of its steps (two consecutive chunks of the JAX aligned layout per
// step) into the tile that owns the step's first chunk, each chunk with its
// own tile's pixel coordinates and gaussians; a tile whose first step does
// not start at base 0 is never initialised on the TPU, and gets the init here.
// Output: (num_tiles, 256, 16) floats, columns [0, C) image, 7 T, 8 done.
//
// Bound: every mode but "empty" does ~(30 + 2C) fp32 operations per
// (pixel, slot) pair of the chunks it evaluates, against 4(6 + C) bytes per
// slot read and 64 bytes per pixel written: bound by operations. "empty" is
// bound by the bytes it writes.
//
// Design (simple and right, as B1): one CTA of 256 threads per owner tile,
// one thread per pixel. A chunk's <= 128 gaussians are staged in shared
// memory by the first 128 threads, then each pixel walks the chunk serially
// with its running sum (or product) and its T_new and broke flags; T and done
// are updated at the chunk's end. The CTA skips the rest of its chunks once
// all 256 pixels are done (__syncthreads_count), as the TPU kernel skips
// them through its done flag in scalar memory; that changes no output. Every
// mode but "pair" walks the owner's own list 128 slots at a time; "pair" walks
// the chunk table from the owner's first step to its last, stopping at the
// owner's first padding chunk, after which every step is padding.
//
// Compiled with -fmad=false, like B1, so sigma and alpha round as the plain
// version's separate elementwise operations do.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;
constexpr int kPix = kBlock * kBlock;  // threads per CTA, one per pixel
constexpr int kChunk = 128;            // slots per chunk
constexpr int kCols = 16;              // floats per pixel of the output
constexpr int kColT = 7;
constexpr int kColDone = 8;
constexpr float kAlphaClamp = 0.999f;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

enum Mode : int { kBase = 0, kEmpty = 1, kNoTrans = 2, kNoMatmul = 3, kScan = 4, kPair = 5 };

struct Scene {
  const float* xys;     // (N, 2)
  const float* conics;  // (N, 3)
  const float* colors;  // (N, C)
  const float* opacs;   // (N,)
  const int* gid;       // (n_isects,) gaussian per slot, by (tile, depth)
  const int* tile_start;
  const int* tile_cnt;
};

template <int C>
struct Staged {
  float x[kChunk], y[kChunk], a[kChunk], b[kChunk], c[kChunk], o[kChunk];
  float col[C][kChunk];
};

// Composite slots [base, min(base + 128, cnt)) of tile src's list into this
// thread's pixel state. The caller has passed a barrier since the staged
// gaussians were last read.
template <int MODE, int C>
__device__ void composite_chunk(const Scene& s, Staged<C>& st, int src, int base, int cnt, int tiles_x,
                                float& T, int& done, float (&acc)[C]) {
  const int t = threadIdx.x;
  const int n = min(kChunk, cnt - base);
  if (t < n) {
    const int g = s.gid[s.tile_start[src] + base + t];
    st.x[t] = s.xys[2 * g];
    st.y[t] = s.xys[2 * g + 1];
    st.a[t] = s.conics[3 * g];
    st.b[t] = s.conics[3 * g + 1];
    st.c[t] = s.conics[3 * g + 2];
    st.o[t] = s.opacs[g];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) st.col[ch][t] = s.colors[g * C + ch];
  }
  __syncthreads();
  const float fpx = static_cast<float>((src % tiles_x) * kBlock + t % kBlock);
  const float fpy = static_cast<float>((src / tiles_x) * kBlock + t / kBlock);
  float run = (MODE == kScan) ? 1.0f : 0.0f;  // running product (scan) or sum of L
  float T_new = T;
  int broke = 0;
  for (int k = 0; k < n; ++k) {
    const float dx = st.x[k] - fpx;
    const float dy = st.y[k] - fpy;
    const float sigma = 0.5f * (st.a[k] * dx * dx + st.c[k] * dy * dy) + st.b[k] * dx * dy;
    const float vis = (MODE == kNoTrans) ? 1.0f / (1.0f + sigma) : expf(-sigma);
    const float alpha = fminf(kAlphaClamp, st.o[k] * vis);
    const float aeff = (sigma >= 0.0f && alpha >= kMinAlpha) ? alpha : 0.0f;
    const float one_minus = 1.0f - aeff;
    float T_excl;
    if (MODE == kNoMatmul) {
      T_excl = T;
    } else if (MODE == kScan) {
      T_excl = T * run;
    } else {
      T_excl = T * expf(run);
    }
    const float T_after = T_excl * one_minus;
    if (aeff > 0.0f) {
      if (T_after > kTEps) {
        if (!done) {
          const float w = aeff * T_excl;
#pragma unroll
          for (int ch = 0; ch < C; ++ch) acc[ch] += w * st.col[ch][k];
          T_new = fminf(T_new, T_after);
        }
      } else {
        broke = 1;
      }
    }
    if (MODE == kScan) {
      run *= one_minus;
    } else if (MODE == kNoTrans) {
      run += -aeff;
    } else if (MODE != kNoMatmul) {
      run += log1pf(-aeff);
    }
  }
  T = T_new;
  done |= broke;
}

// This thread's pixel row of tile ``tile``: C image values, T, done, zeros.
template <int C>
__device__ void write_pixel(float* out, int tile, float T, int done, const float (&acc)[C]) {
  float row[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) row[j] = j < C ? acc[j < C ? j : 0] : 0.0f;
  row[kColT] = T;
  row[kColDone] = done ? 1.0f : 0.0f;
  float4* dst = reinterpret_cast<float4*>(out + (static_cast<long long>(tile) * kPix + threadIdx.x) * kCols);
#pragma unroll
  for (int j = 0; j < kCols / 4; ++j) dst[j] = make_float4(row[4 * j], row[4 * j + 1], row[4 * j + 2], row[4 * j + 3]);
}

__global__ void __launch_bounds__(kPix) empty_kernel(float* __restrict__ out) {
  const float none[1] = {0.0f};
  write_pixel<1>(out, blockIdx.x, 1.0f, 0, none);
}

template <int MODE, int C>
__global__ void __launch_bounds__(kPix)
variant_kernel(Scene s, const int* __restrict__ chunk_tile, const int* __restrict__ chunk_base,
               const int* __restrict__ chunk_cnt, const int* __restrict__ pair_lo,
               const int* __restrict__ pair_hi, float* __restrict__ out, int tiles_x) {
  __shared__ Staged<C> st;
  const int owner = blockIdx.x;
  float T = 1.0f;
  int done = 0;
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;

  if (MODE == kPair) {
    const int lo = pair_lo[owner], hi = pair_hi[owner];
    if (lo < hi && chunk_base[2 * lo] == 0) {
      for (int c = 2 * lo; c < 2 * hi; ++c) {
        const int src = chunk_tile[c], base = chunk_base[c], cnt = chunk_cnt[c];
        if (base >= cnt) {
          if (src == owner) break;  // the owner's padding: every later step is padding
          continue;
        }
        // Barrier: the previous chunk's gaussians are consumed before they are overwritten.
        if (__syncthreads_count(done) == kPix) break;
        composite_chunk<kBase, C>(s, st, src, base, cnt, tiles_x, T, done, acc);
      }
    }
  } else {
    const int cnt = s.tile_cnt[owner];
    for (int base = 0; base < cnt; base += kChunk) {
      if (__syncthreads_count(done) == kPix) break;
      composite_chunk<MODE, C>(s, st, owner, base, cnt, tiles_x, T, done, acc);
    }
  }
  write_pixel<C>(out, owner, T, done, acc);
}

template <int C>
void launch(int mode, const Scene& s, const int* chunk_tile, const int* chunk_base, const int* chunk_cnt,
            const int* pair_lo, const int* pair_hi, float* out, int num_tiles, int tiles_x,
            cudaStream_t stream) {
#define GCT_MODE(m)                                                                                      \
  case m:                                                                                                \
    variant_kernel<m, C><<<num_tiles, kPix, 0, stream>>>(s, chunk_tile, chunk_base, chunk_cnt, pair_lo, \
                                                         pair_hi, out, tiles_x);                         \
    break;
  switch (mode) {
    GCT_MODE(kBase)
    GCT_MODE(kNoTrans)
    GCT_MODE(kNoMatmul)
    GCT_MODE(kScan)
    GCT_MODE(kPair)
    default:
      break;
  }
#undef GCT_MODE
}

}  // namespace

// Plain C entry point for ctypes. mode: 0 base, 1 empty, 2 notrans,
// 3 nomatmul, 4 scan, 5 pair; the chunk table and the pair ranges are read
// only by "pair" (null otherwise). Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a mode outside 0..5, C outside 1..8, or
// "pair" without its table).
extern "C" int gctorch_blend_variants(int mode, const float* xys, const float* conics, const float* colors,
                                      const float* opacs, const int* gid, const int* tile_start,
                                      const int* tile_cnt, const int* chunk_tile, const int* chunk_base,
                                      const int* chunk_cnt, const int* pair_lo, const int* pair_hi,
                                      float* out, int num_tiles, int tiles_x, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < kBase || mode > kPair || C < 1 || C > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kPair && !(chunk_tile && chunk_base && chunk_cnt && pair_lo && pair_hi)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == kEmpty) {
    empty_kernel<<<num_tiles, kPix, 0, st>>>(out);
    return static_cast<int>(cudaGetLastError());
  }
  const Scene s{xys, conics, colors, opacs, gid, tile_start, tile_cnt};
#define GCT_CASE(n)                                                                                     \
  case n:                                                                                               \
    launch<n>(mode, s, chunk_tile, chunk_base, chunk_cnt, pair_lo, pair_hi, out, num_tiles, tiles_x, st); \
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
  }
#undef GCT_CASE
  return static_cast<int>(cudaGetLastError());
}
