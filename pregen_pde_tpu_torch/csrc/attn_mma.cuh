// 3xTF32 tensor-core helpers shared by K3 (swin_block.cu) and K4
// (window_attention.cu): the m16n8k8 product with each operand split into a
// TF32 high and low part (a_lo b_hi + a_hi b_lo + a_hi b_hi), and the tiles
// of the windowed attention built on it. A warp holds 16 rows; keys (or
// queries) come in chunks of KC = 32; a chunk's products go into fresh
// accumulators (S, dP) or a zeroed chunk sum added to the running one in
// float32 (o, dq, dk, dv).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- tensor cores: 3xTF32 m16n8k8 (the helpers of ns_projection_step.cu) ---

// cvt.rna.tf32.f32 on the integer pipe: add half of the 13 dropped bits to
// the magnitude and clear them (round to nearest, ties away from zero).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 8, row-major) of a warp tile split into hi and lo
struct FragA {
  uint32_t hi[4], lo[4];
};

// a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
__device__ __forceinline__ void frag_a(FragA& f, float a0, float a1, float a2, float a3) {
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
}

// d += a b in 3xTF32 for split b (hi h0, h1; lo l0, l1). The three products
// of one k step go into a zeroed accumulator (the small terms first) that is
// then added to d in float32: the tensor cores' own accumulation truncates,
// and across a long k loop that bias grows with k (a column sum over 512
// tokens read 78x the float32 error before); one k step at a time it stays
// at float32's.
__device__ __forceinline__ void mma3s(float d[4], const FragA& a, uint32_t h0, uint32_t h1,
                                      uint32_t l0, uint32_t l1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.lo, h0, h1);
  mma_tf32(t, a.hi, l0, l1);
  mma_tf32(t, a.hi, h0, h1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// the same with b0 = B[t][g], b1 = B[t+4][g] split here
__device__ __forceinline__ void mma3(float d[4], const FragA& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma3s(d, a, h0, h1, l0, l1);
}

// ---- the attention's tiles ---------------------------------------------------
//
// Rows of k, v, q and do sit in shared memory with a row stride of KSTR =
// HD + 4 (conflict-free B fragments read along HD), v in K3's forward VSTR
// (HD + 8 mod 32 in {8, 24}: read along keys). Each warp keeps its 16 x 32
// tile of P (or ds) in shared memory (stride PSTR) to turn the accumulator
// layout into the A layout.

constexpr int KC = 32;

template <int HD>
struct Attn {
  static constexpr int KSTR = HD + 4;
  static constexpr int VSTR = HD == 8 ? 8 : HD == 16 ? 24 : HD + 8;
  static constexpr int PSTR = KC + 4;
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// d += a b in 3xTF32 straight into d (a fresh accumulator)
__device__ __forceinline__ void mma3d(float d[4], const FragA& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

// a warp's 16 x KC tile x (accumulator layout) into its shared tile Pw
__device__ __forceinline__ void tile_to_smem(float* Pw, const float (&x)[KC / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int PS = KC + 4;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    Pw[g * PS + 8 * j + 2 * t] = x[j][0], Pw[g * PS + 8 * j + 2 * t + 1] = x[j][1];
    Pw[(g + 8) * PS + 8 * j + 2 * t] = x[j][2], Pw[(g + 8) * PS + 8 * j + 2 * t + 1] = x[j][3];
  }
}

// acc += Pw (16 x KC) B, B's row k at Bm + (r0 + k) str: the chunk's sum in
// a zeroed accumulator, added in float32; with EXACT each k step's three
// products are also summed apart and added to the chunk's sum in float32
template <int HD, bool EXACT = false>
__device__ __forceinline__ void tile_times(float (&acc)[HD / 8][4], const float* Pw,
                                           const float* Bm, int str, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int PS = KC + 4;
  float c[HD / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk) {
    FragA fp;
    frag_a(fp, Pw[g * PS + 8 * kk + t], Pw[(g + 8) * PS + 8 * kk + t], Pw[g * PS + 8 * kk + t + 4],
           Pw[(g + 8) * PS + 8 * kk + t + 4]);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const float* br = Bm + (r0 + 8 * kk + t) * str + 8 * d + g;
      if (EXACT) mma3(c[d], fp, br[0], br[4 * str]);
      else mma3d(c[d], fp, br[0], br[4 * str]);
    }
  }
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[d][i] += c[d][i];
}

// s (16 x KC) = a (16 x HD, A-layout values, scaled by f0 / f1 by row) B^T,
// B's row j at Bm + (r0 + j) KSTR. With EXACT each k step is added in
// float32: S's logits are scaled by up to 100 before the exponential, so S
// keeps float32's accuracy (dP needs no more than a fresh accumulator).
template <int HD, bool EXACT>
__device__ __forceinline__ void rows_times_t(float (&s)[KC / 8][4], const float (&a)[HD / 8][4],
                                             float f0, float f1, const float* Bm, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    FragA fa;
    frag_a(fa, a[kk][0] * f0, a[kk][1] * f1, a[kk][2] * f0, a[kk][3] * f1);
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      const float* kr = Bm + (r0 + 8 * j + g) * Attn<HD>::KSTR + 8 * kk + t;
      if (EXACT) mma3(s[j], fa, kr[0], kr[4]);
      else mma3d(s[j], fa, kr[0], kr[4]);
    }
  }
}

}  // namespace
