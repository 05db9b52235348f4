// 3×TF32 on the tensor cores, shared by the fp32 attention kernels: B3's
// forward (flash_attn_fwd.cu) and B4, B5's backward (flash_attn_bwd.cu).
//
// fp32 runs on the tensor cores as 3×TF32: each operand x is split into
// hi = tf32(x) and lo = tf32(x − hi) (cvt.rna), and a product a·b is taken as
// a_lo·b_hi + a_hi·b_lo + a_hi·b_hi on mma.sync.m16n8k8 with fp32
// accumulators, the small terms first. The error is a few units of fp32's
// last place per product; one pass (a_hi·b_hi) would round the operands to
// 10 mantissa bits. The tensor cores truncate their fp32 sums, so a long sum
// is taken as short chains in fresh accumulators, added on the FP32 pipe.
//
// Tiles are row-major in shared memory with a pitch of D + 4 floats, copied
// by `cp.async` 16 bytes a thread. m16n8k8's C fragment holds columns 2·tq
// and 2·tq + 1, its A fragment columns tq and tq + 4: a product whose A
// operand is a C fragment relabels its k-slots (slot tq is column 2·tq, slot
// tq + 4 is 2·tq + 1) and reads its B fragments with the same labels, from
// the row-major tile, with no transposed copy.
//
// The layout class P of the functions below gives THREADS (threads a CTA),
// PITCH (floats a row), CHUNKS (16-byte copies a row), PRESPLIT (the CTA's
// own rows are split once) and OWN_LO (floats from those rows' hi parts to
// their lo parts).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {  // an m16n8k8 A fragment split into its hi and lo TF32 parts
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_a(FragA& f, float x0, float x1, float x2, float x3) {
  const float x[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32(x[i]);
    f.lo[i] = tf32(x[i] - __uint_as_float(f.hi[i]));
  }
}

struct FragB {  // an m16n8k8 B fragment's hi and lo TF32 parts
  uint32_t h0, h1, l0, l1;
};

// a B fragment whose hi parts lie at b[0] (k-slot tq) and b[step] (slot
// tq + 4), its lo parts `lo` floats on
__device__ __forceinline__ FragB load_b(const float* b, int step, int lo) {
  return {__float_as_uint(b[0]), __float_as_uint(b[step]), __float_as_uint(b[lo]), __float_as_uint(b[lo + step])};
}

// d += a·b in 3×TF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.h0, b.h1);
  mma_tf32(d, a.hi, b.l0, b.l1);
  mma_tf32(d, a.hi, b.h0, b.h1);
}

__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const float* b, int step, int lo) {
  mma3(d, a, load_b(b, step, lo));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// global → shared, asynchronously; zeros where !ok (nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// rows a ring tile of the fp32 kernels, for head width d: the same for D as
// for the width DT it is rounded up to
constexpr int f32_ring_rows(int d) { return d <= 48 ? 32 : d <= 96 ? 16 : 8; }

// rows [r0, r0 + N) of a (rows, D) fp32 matrix into a shared tile of pitch
// PITCH, 16 bytes a copy; zeros past `rows` and past D
template <class P, int N>
__device__ __forceinline__ void stage_f32(float* dst, const float* base, long long stride, int r0, int rows,
                                          int D) {
#pragma unroll
  for (int e0 = 0; e0 < N * P::CHUNKS; e0 += P::THREADS) {
    const int e = e0 + threadIdx.x;
    if (N * P::CHUNKS % P::THREADS == 0 || e < N * P::CHUNKS) {
      const int r = e / P::CHUNKS, c = (e % P::CHUNKS) * 4, row = r0 + r;
      const bool ok = row < rows && c < D;
      cp_async16(dst + r * P::PITCH + c, ok ? base + (long long)row * stride + c : base, ok);
    }
  }
}

// an A fragment of the CTA's own rows (row-major, pitch PITCH) at rows r0,
// r0 + 8 and columns c, c + 4: from the split copy, or split here
template <class P>
__device__ __forceinline__ void load_a(FragA& f, const float* rows, int r0, int c) {
  const int i[4] = {r0 * P::PITCH + c, (r0 + 8) * P::PITCH + c, r0 * P::PITCH + c + 4, (r0 + 8) * P::PITCH + c + 4};
  if constexpr (P::PRESPLIT) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f.hi[e] = __float_as_uint(rows[i[e]]);
      f.lo[e] = __float_as_uint(rows[P::OWN_LO + i[e]]);
    }
  } else {
    split_a(f, rows[i[0]], rows[i[1]], rows[i[2]], rows[i[3]]);
  }
}

}  // namespace
