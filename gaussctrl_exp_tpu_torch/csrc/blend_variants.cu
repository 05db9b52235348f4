// Kernel B1v: the blend-forward ablations of the variant benchmark, for
// Hopper (sm_90a), on kernel B1's design (blend_fwd.cu, blend_common.cuh).
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
// Bound: every mode but "empty" does B1's 17 fp32 operations per (pixel,
// slot) pair it evaluates (pair_alpha and the alpha test), 3 to 8 more per
// live pair (aeff > 0: 1 - aeff, T_excl, T_after, its test and the
// cumulation, by mode) and 2 + 2C more per composited pair, against
// 4(6 + C) bytes per slot read and 64 bytes per pixel written: bound by
// operations (chip_smoke.py, variant_bound). "empty" is bound by the bytes it
// writes.
//
// Design (B1's): one CTA of 256 threads per owner tile, one thread per pixel.
// All 256 threads stage 256 slots at a time, two chunks, as B1's packed
// float4s with the footprint's box (stage<C>); "pair" stages one step, each of
// its chunks from its own tile. A batch is walked chunk by chunk, and at the
// chunk boundary (slot 128 of the batch) T and done take their new values,
// as on the TPU. In a chunk each warp (two rows of a tile) takes 32 slots at a
// time: each lane tests one slot's box against the warp's pixels, and a
// ballot leaves the candidates, which each pixel walks in order with its
// running sum (or product), T_new and broke flag. A warp whose 32 pixels were
// all done at the chunk's start leaves the chunk, and the CTA leaves the tile
// when all 256 pixels are done (__syncthreads_count), as the TPU kernel skips
// its chunks through its done flag: a done pixel's state never changes.
//
// Why skipping a non-candidate is exact. Outside every box of the warp a slot
// has sigma > skip level, so aeff = 0 (a slot past the list has an empty
// box). A slot with aeff = 0 changes no bit of any mode's output: it is not
// composited and cannot break; "base" and "pair" add log1pf(-0) = -0 to the
// running sum, which leaves every sum unchanged; "scan" multiplies its product
// by 1 - 0 = 1; "notrans" adds -0; "nomatmul" keeps no running value. The
// same holds for a candidate with aeff = 0, which is passed over as soon as
// its alpha is known. "notrans" has its own skip level and box
// (blend_common.cuh, kRecip): its alpha is o / (1 + sigma), which is under
// 1/255 past sigma = 255 * o - 1, not past log(255 * o).
//
// sigma, alpha, 1 - aeff, T_excl, T_after and the running sum or product are
// written with _rn intrinsics in the plain version's order of operations, so
// the compiler contracts none of them into a fused multiply-add; the
// compositing sums may contract.

#include "blend_common.cuh"

namespace {

using namespace gctorch_blend;

constexpr int kChunk = 128;  // slots per chunk; a batch of kBatch slots is two
constexpr int kCols = 16;    // floats per pixel of the output
constexpr int kColT = 7;
constexpr int kColDone = 8;

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

// One pixel's state: its coordinates and warp strip in the chunk's source
// tile, the carried T and done flag, and the image.
template <int C>
struct Pixel {
  float fpx, fpy;
  Strip strip;
  float T;
  int done;
  float acc[C];
};

// This thread's pixel of tile src: coordinates and the warp's two rows.
template <int C>
__device__ __forceinline__ void place(Pixel<C>& px, int src, int tiles_x) {
  const int t = threadIdx.x;
  const int x = (src % tiles_x) * kBlock + t % kBlock;
  const int y = (src / tiles_x) * kBlock + t / kBlock;
  px.fpx = static_cast<float>(x);
  px.fpy = static_cast<float>(y);
  px.strip = Strip{static_cast<float>(x - t % kBlock), static_cast<float>(y - t / kBlock % 2),
                   static_cast<float>(y - t / kBlock % 2 + 1)};
}

// Composite the staged chunk h (slots [h * kChunk, (h + 1) * kChunk)) into
// this thread's pixel. Warp-uniform; every lane of the warp takes part.
template <int MODE, int C>
__device__ __forceinline__ void composite_chunk(const Staged<C>& s, int h, Pixel<C>& px) {
  if (__all_sync(kFull, px.done)) return;  // the chunk changes none of the warp's pixels
  const int lane = threadIdx.x & (kLanes - 1);
  float run = (MODE == kScan) ? 1.0f : 0.0f;  // running product (scan) or sum over the chunk's earlier slots
  float T_new = px.T;
  int broke = 0;
  for (int k32 = h * kChunk; k32 < (h + 1) * kChunk; k32 += kLanes) {
    unsigned cand = candidates<C>(s, k32, lane, px.strip);
    while (cand) {
      const int k = take_first(cand, k32);
      if (px.done) continue;
      const float4 p1 = s[1][k];
      const float aeff = pair_alpha<MODE == kNoTrans>(s[0][k], p1, px.fpx, px.fpy).alpha;
      if (aeff < kMinAlpha) continue;  // aeff = 0: changes no bit (see the header)
      const float one_minus = __fsub_rn(1.0f, aeff);
      float T_excl;
      if (MODE == kNoMatmul) {
        T_excl = px.T;
      } else if (MODE == kScan) {
        T_excl = __fmul_rn(px.T, run);
      } else {
        T_excl = __fmul_rn(px.T, expf(run));
      }
      const float T_after = __fmul_rn(T_excl, one_minus);
      if (T_after > kTEps) {
        float col[C];
        colours<C>(s, k, p1, col);
        const float w = aeff * T_excl;
#pragma unroll
        for (int c = 0; c < C; ++c) px.acc[c] += w * col[c];
        T_new = fminf(T_new, T_after);
      } else {
        broke = 1;
      }
      if (MODE == kScan) {
        run = __fmul_rn(run, one_minus);
      } else if (MODE == kNoTrans) {
        run = __fsub_rn(run, aeff);
      } else if (MODE != kNoMatmul) {
        run = __fadd_rn(run, log1pf(-aeff));
      }
    }
  }
  px.T = T_new;
  px.done |= broke;
}

// This thread's pixel row of tile ``tile``: C image values, T, done, zeros.
template <int C>
__device__ void write_pixel(float* out, int tile, float T, int done, const float (&acc)[C]) {
  float row[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) row[j] = j < C ? acc[j < C ? j : 0] : 0.0f;
  row[kColT] = T;
  row[kColDone] = done ? 1.0f : 0.0f;
  float4* dst = reinterpret_cast<float4*>(out + (static_cast<long long>(tile) * kTilePix + threadIdx.x) * kCols);
#pragma unroll
  for (int j = 0; j < kCols / 4; ++j) dst[j] = make_float4(row[4 * j], row[4 * j + 1], row[4 * j + 2], row[4 * j + 3]);
}

__global__ void __launch_bounds__(kTilePix) empty_kernel(float* __restrict__ out) {
  const float none[1] = {0.0f};
  write_pixel<1>(out, blockIdx.x, 1.0f, 0, none);
}

template <int MODE, int C>
__global__ void __launch_bounds__(kTilePix, kMinBlocks<C>)
variant_kernel(Scene sc, const int* __restrict__ chunk_tile, const int* __restrict__ chunk_base,
               const int* __restrict__ chunk_cnt, const int* __restrict__ pair_lo,
               const int* __restrict__ pair_hi, float* __restrict__ out, int tiles_x) {
  constexpr bool kRecip = MODE == kNoTrans;
  __shared__ Staged<C> s;
  const int owner = blockIdx.x;
  const int t = threadIdx.x;
  Pixel<C> px;
  px.T = 1.0f;
  px.done = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) px.acc[c] = 0.0f;

  if (MODE == kPair) {
    const int lo = pair_lo[owner], hi = pair_hi[owner];
    if (lo < hi && chunk_base[2 * lo] == 0) {
      for (int step = lo; step < hi; ++step) {
        // Barrier: the previous step's gaussians are consumed before they are overwritten.
        if (__syncthreads_count(px.done) == kTilePix) break;
        const int c = 2 * step + t / kChunk, i = t % kChunk;  // this thread stages slot i of chunk c
        const int src = chunk_tile[c], j = chunk_base[c] + i;
        stage<C, kRecip>(s, t, j < chunk_cnt[c] ? sc.gid[sc.tile_start[src] + j] : -1, sc.xys, sc.conics,
                         sc.colors, sc.opacs);
        __syncthreads();
        bool stop = false;
        for (int h = 0; h < 2 && !stop; ++h) {
          const int ch = 2 * step + h, tile = chunk_tile[ch];
          if (chunk_base[ch] >= chunk_cnt[ch]) {
            stop = tile == owner;  // the owner's padding: every later step is padding
            continue;
          }
          place<C>(px, tile, tiles_x);
          composite_chunk<kBase, C>(s, h, px);
        }
        if (stop) break;
      }
    }
  } else {
    const int cnt = sc.tile_cnt[owner], start = sc.tile_start[owner];
    place<C>(px, owner, tiles_x);
    for (int b0 = 0; b0 < cnt; b0 += kBatch) {
      if (__syncthreads_count(px.done) == kTilePix) break;
      stage<C, kRecip>(s, t, b0 + t < cnt ? sc.gid[start + b0 + t] : -1, sc.xys, sc.conics, sc.colors, sc.opacs);
      __syncthreads();
      composite_chunk<MODE, C>(s, 0, px);
      if (b0 + kChunk < cnt) composite_chunk<MODE, C>(s, 1, px);
    }
  }
  write_pixel<C>(out, owner, px.T, px.done, px.acc);
}

template <int C>
void launch(int mode, const Scene& s, const int* chunk_tile, const int* chunk_base, const int* chunk_cnt,
            const int* pair_lo, const int* pair_hi, float* out, int num_tiles, int tiles_x,
            cudaStream_t stream) {
#define GCT_MODE(m)                                                                                          \
  case m:                                                                                                    \
    variant_kernel<m, C><<<num_tiles, kTilePix, 0, stream>>>(s, chunk_tile, chunk_base, chunk_cnt, pair_lo, \
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
    empty_kernel<<<num_tiles, kTilePix, 0, st>>>(out);
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
