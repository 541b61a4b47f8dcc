// Hand-written window attention, forward and backward, for Hopper (sm_90a): K4.
//
// Replaces the Pallas TPU kernels of
//   pregen_pde_tpu/ops/window_attention.py::window_attention (forward,
//   `_fwd_kernel`, pallas_call in `_forward`; backward, `_bwd_kernel`,
//   pallas_call in `_vjp_bwd`)
// which compute, per (row, head) of q, k, v (nb, h, n, hd):
//   out = softmax(q k^T + bias[row % nw, head]) v
// and its gradients dq, dk, dv (nb, h, n, hd) and dbias (nw, h, n, n), the
// score gradient summed over the images of each window slot. q and k
// arrive cosine-normalised and q pre-multiplied by the per-head logit scale
// (the caller does that, as in the JAX package), so the kernels compute
// plain q.k^T plus the additive bias (16 sigmoid(CPB) plus the -100 shift
// mask). Window w of image b is row b*nw + w.
//
// Layout. Every (nb, h, n, hd) operand and result is read and written in
// place through its strides for row, head and token, its last dim
// contiguous and each row of hd floats 16-byte aligned: the model hands
// over q, k, v as `reshape(nb, n, h, hd).permute(0, 2, 1, 3)` views of its
// projections, and takes out (and the backward's dq, dk, dv) back in the
// same (nb, n, h, hd) order, so `permute(0, 2, 1, 3).reshape(nb, n, c)` is
// a view. The bias is read through all four of its strides (the model's
// 16 sigmoid(CPB) keeps the head fastest), but for the wide backward, which
// takes contiguous rows (the wrapper copies the model's for it). The
// forward copies nothing.
//
// Forward, with s = q k^T + bias. Two routes, by n:
//   small (n <= 32; scOT-B's stage 3 is n = 16, hd = 32, 24 heads): a warp
//     per (row, head), four to a block. The warp's k and v rows come into
//     its shared memory by cp.async while each lane loads its q and bias;
//     at n <= 16 lane l takes query row l % 16 and half of hd (the two
//     halves' dot products summed by one shuffle), at n <= 32 a lane a row.
//     Each lane holds its row's n scores in registers: the softmax (max,
//     exp, sum) and the product with v in float32 on the CUDA cores, each
//     score a sum over d in order. A 16 x 16 x 32 product would fill no
//     tensor-core tile usefully. What bounds it: latency (a call at the
//     main path is 72 warps of ~1k dependent FLOP each, and a kernel's
//     fixed cost) and the wrapper's enqueue; the bytes (q, k, v, out once)
//     take 0.2 us.
//   wide (n > 32; the attention-only route's n = 64 and 256, scOT-L's
//     stage 2 at hd = 64): a block per (row, head, 128 queries), 16 query
//     rows a warp, the row's k and v tiles in shared memory (cp.async), an
//     online softmax over key chunks of 32 in registers (a running max and
//     sum a row, the output rescaled when the max grows). Each warp fetches
//     the bias of the next chunk into its shared tile by cp.async while it
//     forms this chunk's scores (read in the loop instead, the bias's L2
//     latency stalled every chunk), and writes P over the bias it
//     consumed. P.V runs on the tensor cores in 3xTF32 (attn_mma.cuh), each
//     k step's three products added in float32. S = q k^T, a sum of only
//     hd products, runs on the CUDA cores in float32 at hd <= 32, as in the
//     backward, each lane holding its two rows in registers: the output
//     and the lse read 0.5-0.6x the plain float32 version's own error
//     against float64, and the backward, which rebuilds P from this lse,
//     keeps its margin. S on the tensor cores in 3xTF32 took 0.067 ms
//     against 0.093 at stage 0, B = 16, but read 1.0-1.2x and moved the
//     backward's cotangents from 0.62-0.70 to 0.74-0.86 of their bars
//     (NVIDIA H100, variants.py `fwd_tf32_scores`). hd = 64 keeps S on the
//     tensor cores (four rows of 64 do not fit a lane's registers).
//     What bounds it: the 4 n^2 hd FLOP a (row, head), 0.0098 ms at stage
//     0, B = 16, as 3xTF32 at 495 TFLOP/s, and the bias, read once a (row,
//     head): 50 MB there, from L2; the float32 scores' shared-memory reads.
// Both write each row's log-sum-exp m + log l (nb, h, n) when the backward
// will run; the backward rebuilds P from it without a softmax of its own.
//
// Backward, with P = exp(s - lse), D_i = do_i . o_i:
//   dv = P^T do,  dP = do v^T,  ds = P (dP - D),  dq = ds k,  dk = ds^T q,
//   dbias[w] = the sum of ds over the rows of slot w, in a fixed order.
// Two routes, by n:
//   small (n <= 32): ONE launch. A block per (slot, head) walks the slot's
//     images, a warp per image (two per warp at n <= 16: a lane a row),
//     with the image's q, k, v and do in the warp's shared memory. Lane i
//     forms row i of P and ds on the float32 CUDA cores (keeping them in
//     shared memory) and dq_i; then lane j forms dk_j and dv_j from the
//     columns. Each lane adds its rows of ds into registers over its
//     images, and the block sums those partials in a fixed order into
//     dbias: no score-gradient scratch, no atomics, no second launch;
//     bitwise repeatable. What bounds it: the 10 n^2 hd FLOP per (row,
//     head) on the CUDA cores of the nw h blocks (24 at stage 3), and the
//     wrapper's enqueue.
//   wide (n > 32): TWO launches. The attention backward in blocks of two
//     kinds, 16 rows a warp, 8 warps a block: per (row, head, 128 queries)
//     P from the lse, dP, ds and dq, with ds written to a float32 (nb, h,
//     n, n) scratch; per (row, head, 128 keys) P^T and ds^T again, dv and
//     dk. Then one pass sums the scratch over the images of each slot in a
//     fixed order. The products over n (dq = ds k, dk = ds^T q, dv = P^T
//     do) run on the tensor cores in 3xTF32 (attn_mma.cuh, each k step's
//     three products added in float32). The scores S and dP, sums of only
//     hd = 32 products, run on the CUDA cores in float32, each lane holding
//     its two rows in registers: 3xTF32 keeps ~2^-21 of a product (float32
//     2^-24), and at hd = 32 that error is not averaged away, so on the
//     tensor cores every cotangent read 2.3-2.8x the plain version's own
//     float32 error against float64, 1.55-1.89x here (NVIDIA H100,
//     variants.py). hd = 64 keeps the scores on the tensor cores (four rows
//     of 64 do not fit a lane's registers). The scratch's round trip (2 x
//     50 MB at scOT-B stage 0, B = 16) is what a slot's n x n sum costs
//     when it does not fit a block. What bounds it: the scores' 8 n^2 hd
//     FLOP a (row, head) on the CUDA cores (0.048 ms at stage 0, B = 16, at
//     67 TFLOP/s) and the scratch (0.03 ms at 3.35 TB/s), far from both.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; the entry points return cudaGetLastError() and report
// how many kernels they enqueued (`launched`).

#include <cuda_runtime.h>
#include <math.h>

#include <initializer_list>

#include "attn_mma.cuh"

namespace {

// Dynamic shared memory above 48 KB has to be opted into.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// An (nb, h, n, hd) operand or result: element (r, hh, i, d) at
// p + r sr + hh sh + i st + d; offsets inside one (r, hh) slice fit an int
// (the entry points check), so the hot loops' address arithmetic is 32-bit.
template <typename T>
struct Ten {
  T* p;
  long long sr, sh;
  int st;
  __device__ __forceinline__ T* at(int r, int hh) const { return p + r * sr + hh * sh; }
};
using In = Ten<const float>;
using Out = Ten<float>;

// The additive bias (nw, h, n, n): element (w, hh, i, j) at
// p + w sw + hh sh + i si + j sj.
struct Bias {
  const float* p;
  long long sw, sh;
  int si, sj;
  __device__ __forceinline__ const float* at(int w, int hh) const { return p + w * sw + hh * sh; }
};

constexpr int kSmallMaxN = 32;
constexpr int kWideWarps = 8;

// ---- forward --------------------------------------------------------------------

struct Fwd {
  In q, k, v;
  Bias bias;
  Out out;
  float* lse;  // (nb, h, n) contiguous, or null (nothing saved)
  int nb, h, n, nw;
};

// ---- cp.async ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- the small route: a warp per (row, head) ------------------------------------

constexpr int kFwdSmallWarps = 4;

// NP: n padded to 16 or 32; a row takes LPR lanes of DL head dims each; the
// warp's k and v rows sit in shared memory at stride RS.
template <int HD, int NP>
struct FwdSmall {
  static constexpr int LPR = 32 / NP, DL = HD / LPR, RS = HD + 4;
  static constexpr int WARP = 2 * NP * RS;
  static constexpr int BYTES = kFwdSmallWarps * WARP * 4;
};

template <int HD, int NP>
__global__ void __launch_bounds__(32 * kFwdSmallWarps) attn_fwd_small_kernel(const Fwd a) {
  using L = FwdSmall<HD, NP>;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kFwdSmallWarps + warp;
  if (pair >= a.nb * a.h) return;
  const int row = pair / a.h, head = pair - row * a.h, n = a.n;
  float* Ks = reinterpret_cast<float*>(smem4) + warp * L::WARP;
  float* Vs = Ks + NP * L::RS;
  {  // k and v rows by cp.async; q and the bias row load while they arrive
    const float* kp = a.k.at(row, head);
    const float* vp = a.v.at(row, head);
#pragma unroll
    for (int it = 0; it < NP * HD / 128; ++it) {
      const int e = lane + 32 * it, j = e / (HD / 4), d = 4 * (e % (HD / 4));
      if (j < n) {
        cp_async16(Ks + j * L::RS + d, kp + j * a.k.st + d);
        cp_async16(Vs + j * L::RS + d, vp + j * a.v.st + d);
      }
    }
  }
  const int i = lane % NP, d0 = (lane / NP) * L::DL;
  const bool live = i < n;
  const int ic = live ? i : 0;
  float qr[L::DL];
  {
    const float4* q4 = reinterpret_cast<const float4*>(a.q.at(row, head) + ic * a.q.st + d0);
#pragma unroll
    for (int d4 = 0; d4 < L::DL / 4; ++d4) {
      const float4 t = __ldg(q4 + d4);
      qr[4 * d4] = t.x, qr[4 * d4 + 1] = t.y, qr[4 * d4 + 2] = t.z, qr[4 * d4 + 3] = t.w;
    }
  }
  float b[NP];
  {
    const float* brow = a.bias.at(row % a.nw, head) + ic * a.bias.si;
#pragma unroll
    for (int j = 0; j < NP; ++j) b[j] = j < n ? __ldg(brow + j * a.bias.sj) : 0.f;
  }
  cp_async_wait_all();
  __syncwarp();
  // the row's scores, each a sum over this lane's d in order (the other
  // half's added by one shuffle at NP = 16), then the bias
  float s[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) s[j] = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < L::DL / 4; ++d4)
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float4 kk = *reinterpret_cast<const float4*>(Ks + j * L::RS + d0 + 4 * d4);
      s[j] += qr[4 * d4] * kk.x;
      s[j] += qr[4 * d4 + 1] * kk.y;
      s[j] += qr[4 * d4 + 2] * kk.z;
      s[j] += qr[4 * d4 + 3] * kk.w;
    }
  if constexpr (L::LPR == 2) {
#pragma unroll
    for (int j = 0; j < NP; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], 16);
  }
  // softmax in float32 (expf, not __expf: the bars are a few float32 floors)
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NP; ++j)
    if (j < n) {
      s[j] += b[j];
      m = fmaxf(m, s[j]);
    }
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < NP; ++j)
    if (j < n) {
      s[j] = expf(s[j] - m);
      l += s[j];
    }
  float acc[L::DL];
#pragma unroll
  for (int d = 0; d < L::DL; ++d) acc[d] = 0.f;
#pragma unroll
  for (int j = 0; j < NP; ++j)
    if (j < n) {
#pragma unroll
      for (int d4 = 0; d4 < L::DL / 4; ++d4) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + j * L::RS + d0 + 4 * d4);
        acc[4 * d4] += s[j] * vv.x;
        acc[4 * d4 + 1] += s[j] * vv.y;
        acc[4 * d4 + 2] += s[j] * vv.z;
        acc[4 * d4 + 3] += s[j] * vv.w;
      }
    }
  if (!live) return;
  const float inv = 1.f / l;
  float4* o4 = reinterpret_cast<float4*>(a.out.at(row, head) + i * a.out.st + d0);
#pragma unroll
  for (int d4 = 0; d4 < L::DL / 4; ++d4)
    o4[d4] = make_float4(acc[4 * d4] * inv, acc[4 * d4 + 1] * inv, acc[4 * d4 + 2] * inv,
                         acc[4 * d4 + 3] * inv);
  if (a.lse != nullptr && d0 == 0) a.lse[((long long)row * a.h + head) * n + i] = m + logf(l);
}

// ---- shared by the wide routes: tiles, rows and scores ---------------------------

// rows [0, np) of a (row, head)'s n x HD tile at src (token stride st) into
// shared memory (stride KSTR), zero past n
template <int HD>
__device__ void load_tile(float* dst, const float* __restrict__ src, int st, int np,
                          int n) {
  constexpr int S = Attn<HD>::KSTR;
  for (int e = threadIdx.x; e < np * (HD / 4); e += blockDim.x) {
    const int j = e / (HD / 4), d = 4 * (e % (HD / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < n) v = __ldg(reinterpret_cast<const float4*>(src + j * st + d));
    float* o = dst + j * S + d;
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
}

// the same by cp.async (16 bytes a copy; S keeps every row 16-byte aligned);
// the caller waits (cp_async_wait_all) and syncs
template <int HD>
__device__ void load_tile_async(float* dst, const float* __restrict__ src, int st, int np,
                                int n) {
  constexpr int S = Attn<HD>::KSTR;
  for (int e = threadIdx.x; e < np * (HD / 4); e += blockDim.x) {
    const int j = e / (HD / 4), d = 4 * (e % (HD / 4));
    if (j < n) cp_async16(dst + j * S + d, src + j * st + d);
    else *reinterpret_cast<float4*>(dst + j * S + d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// A warp's rows r0 = i0 + g and r1 = i0 + g + 8 of an n x HD tile (token
// stride st) in the A layout, zero past n, split once into TF32 hi and lo
// parts (a chunk's products reuse them for every chunk of the other operand)
template <int HD>
__device__ __forceinline__ void frag_rows(FragA (&x)[HD / 8], const float* __restrict__ src,
                                          int st, int r0, int r1, int n) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float* p0 = src + (r0 < n ? r0 : 0) * st + 8 * kk + t;
    const float* p1 = src + (r1 < n ? r1 : 0) * st + 8 * kk + t;
    frag_a(x[kk], r0 < n ? __ldg(p0) : 0.f, r1 < n ? __ldg(p1) : 0.f,
           r0 < n ? __ldg(p0 + 4) : 0.f, r1 < n ? __ldg(p1 + 4) : 0.f);
  }
}

// s (16 x KC) = a (16 x HD, split) B^T, B's row j at Bm + (r0 + j) KSTR,
// each k step's three products added in float32
template <int HD>
__device__ __forceinline__ void split_times_t(float (&s)[KC / 8][4], const FragA (&a)[HD / 8],
                                              const float* Bm, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      const float* kr = Bm + (r0 + 8 * j + g) * Attn<HD>::KSTR + 8 * kk + t;
      mma3(s[j], a[kk], kr[0], kr[4]);
    }
}

// s (16 x KC) = rows r0, r1 (ra, rb: HD floats each, in registers) times
// the rows r0 + 8 j + 2 t + e of Bm (stride KSTR), in the accumulator
// layout, in float32 on the CUDA cores: each score a sum over d in order
template <int HD>
__device__ __forceinline__ void f32_times_t(float (&s)[KC / 8][4], const float (&ra)[HD],
                                            const float (&rb)[HD], const float* Bm, int r0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4)
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 b =
            *reinterpret_cast<const float4*>(Bm + (r0 + 8 * j + 2 * t + e) * Attn<HD>::KSTR + 4 * d4);
        s[j][e] += ra[4 * d4] * b.x;
        s[j][e] += ra[4 * d4 + 1] * b.y;
        s[j][e] += ra[4 * d4 + 2] * b.z;
        s[j][e] += ra[4 * d4 + 3] * b.w;
        s[j][2 + e] += rb[4 * d4] * b.x;
        s[j][2 + e] += rb[4 * d4 + 1] * b.y;
        s[j][2 + e] += rb[4 * d4 + 2] * b.z;
        s[j][2 + e] += rb[4 * d4 + 3] * b.w;
      }
}

// A warp's two rows r0, r1 of an n x HD tile as the scores take them: whole
// in registers (F32S: the scores on the CUDA cores) or as split A fragments
template <int HD, bool F32S>
struct Rows;
template <int HD>
struct Rows<HD, true> {
  float a[HD], b[HD];
};
template <int HD>
struct Rows<HD, false> {
  FragA f[HD / 8];
};

template <int HD, bool F32S>
__device__ __forceinline__ void load_rows(Rows<HD, F32S>& x, const float* __restrict__ src,
                                          int st, int r0, int r1, int n) {
  if constexpr (F32S) {
    const float4* p0 = reinterpret_cast<const float4*>(src + (r0 < n ? r0 : 0) * st);
    const float4* p1 = reinterpret_cast<const float4*>(src + (r1 < n ? r1 : 0) * st);
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 u = r0 < n ? __ldg(p0 + d4) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 w = r1 < n ? __ldg(p1 + d4) : make_float4(0.f, 0.f, 0.f, 0.f);
      x.a[4 * d4] = u.x, x.a[4 * d4 + 1] = u.y, x.a[4 * d4 + 2] = u.z, x.a[4 * d4 + 3] = u.w;
      x.b[4 * d4] = w.x, x.b[4 * d4 + 1] = w.y, x.b[4 * d4 + 2] = w.z, x.b[4 * d4 + 3] = w.w;
    }
  } else {
    frag_rows<HD>(x.f, src, st, r0, r1, n);
  }
}

// s (16 x KC) = the rows x times the rows [r0, r0 + KC) of Bm, transposed
template <int HD, bool F32S>
__device__ __forceinline__ void scores(float (&s)[KC / 8][4], const Rows<HD, F32S>& x,
                                       const float* Bm, int r0) {
  if constexpr (F32S) f32_times_t<HD>(s, x.a, x.b, Bm, r0);
  else split_times_t<HD>(s, x.f, Bm, r0);
}

// rows r0, r1 of an accumulator-layout HD-wide result, each scaled by f0 /
// f1, to dst (token stride st), as far as n
template <int HD>
__device__ __forceinline__ void store_frag_rows(float* __restrict__ dst, int st,
                                                const float (&x)[HD / 8][4], int r0, int r1,
                                                int n, float f0 = 1.f, float f1 = 1.f) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    if (r0 < n)
      *reinterpret_cast<float2*>(dst + r0 * st + 8 * d + 2 * t) =
          make_float2(x[d][0] * f0, x[d][1] * f0);
    if (r1 < n)
      *reinterpret_cast<float2*>(dst + r1 * st + 8 * d + 2 * t) =
          make_float2(x[d][2] * f1, x[d][3] * f1);
  }
}

int wide_np(int n) { return (n + KC - 1) / KC * KC; }
int wide_warps(int n) { return n / 16 < kWideWarps ? (n + 15) / 16 : kWideWarps; }
int wide_chunks(int n) { return (n + 16 * wide_warps(n) - 1) / (16 * wide_warps(n)); }

// ---- the wide forward: a block per (row, head, 16 x warps queries) --------------

// K and V (np rows each), then per warp two 16 x KC tiles: the bias of a key
// chunk, fetched a chunk ahead, then that chunk's P over it
template <int HD>
int fwd_wide_smem(int n) {
  using A = Attn<HD>;
  return (2 * wide_np(n) * A::KSTR + wide_warps(n) * 2 * 16 * A::PSTR) * 4;
}

// a warp's 16 x KC bias tile of rows i0.. (rows past n clamped to n - 1,
// columns past n left unset) into T (stride KC + 4) by cp.async, 4 bytes a
// copy, as one group: lane l takes column jc + l of each row
__device__ __forceinline__ void fetch_bias(float* T, const float* bm, int si, int sj,
                                           int i0, int jc, int n) {
  const int lane = threadIdx.x & 31, col = jc + lane;
  if (col < n) {
    const float* src = bm + col * sj;
#pragma unroll
    for (int r = 0; r < 16; ++r)
      cp_async4(T + r * (KC + 4) + lane, src + (i0 + r < n ? i0 + r : n - 1) * si);
  }
  cp_async_commit();
}

template <int HD, bool F32S>
__global__ void __launch_bounds__(32 * kWideWarps) attn_fwd_wide_kernel(const Fwd a) {
  using AT = Attn<HD>;
  extern __shared__ float4 smem4[];
  const int n = a.n, np = (n + KC - 1) / KC * KC;
  const int row = blockIdx.x, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + np * AT::KSTR;
  float* Tw = Vs + np * AT::KSTR + warp * 2 * 16 * AT::PSTR;
  load_tile_async<HD>(Ks, a.k.at(row, head), a.k.st, np, n);
  load_tile_async<HD>(Vs, a.v.at(row, head), a.v.st, np, n);
  const int i0 = (blockIdx.z * warps + warp) * 16;
  const int r0 = i0 + g, r1 = r0 + 8;
  const float* bm = a.bias.at(row % a.nw, head);
  // the warp's query rows and first bias tile, loaded while K and V arrive
  Rows<HD, F32S> qv;
  if (i0 < n) {
    load_rows<HD, F32S>(qv, a.q.at(row, head), a.q.st, r0, r1, n);
    fetch_bias(Tw, bm, a.bias.si, a.bias.sj, i0, 0, n);
  }
  cp_async_wait_all();
  __syncthreads();
  if (i0 >= n) return;
  // the online softmax: a running max m and sum l a row (quad-uniform)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[HD / 8][4] = {};
  for (int jc = 0, c = 0; jc < np; jc += KC, ++c) {
    float* T = Tw + (c & 1) * 16 * AT::PSTR;
    const bool more = jc + KC < np;
    if (more)
      fetch_bias(Tw + ((c + 1) & 1) * 16 * AT::PSTR, bm, a.bias.si, a.bias.sj, i0, jc + KC, n);
    float s[KC / 8][4];
    scores<HD, F32S>(s, qv, Ks, jc);
    if (more) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncwarp();
    float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 8 * j + 2 * t + (i & 1);
        if (jc + col < n) {
          s[j][i] += T[(i < 2 ? g : g + 8) * AT::PSTR + col];
          if (i < 2) c0 = fmaxf(c0, s[j][i]);
          else c1 = fmaxf(c1, s[j][i]);
        }
      }
    // every chunk holds a column below n, so the maxima are finite
    const float n0 = fmaxf(m0, quad_max(c0)), n1 = fmaxf(m1, quad_max(c1));
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = jc + 8 * j + 2 * t + (i & 1);
        const float p = col < n ? expf(s[j][i] - (i < 2 ? n0 : n1)) : 0.f;
        s[j][i] = p;
        if (i < 2) p0 += p;
        else p1 += p;
      }
    const float f0 = expf(m0 - n0), f1 = expf(m1 - n1);  // 0 at the first chunk
    l0 = l0 * f0 + quad_sum(p0);
    l1 = l1 * f1 + quad_sum(p1);
    m0 = n0, m1 = n1;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= f0, o[d][1] *= f0;
      o[d][2] *= f1, o[d][3] *= f1;
    }
    // o += P V on the tensor cores, P written over the bias it consumed
    // (each lane over the very elements it read)
    tile_to_smem(T, s);
    __syncwarp();
    tile_times<HD, true>(o, T, Vs, AT::KSTR, jc);
    __syncwarp();
  }
  store_frag_rows<HD>(a.out.at(row, head), a.out.st, o, r0, r1, n, 1.f / l0, 1.f / l1);
  if (a.lse != nullptr && t == 0) {
    float* lrow = a.lse + ((long long)row * a.h + head) * n;
    if (r0 < n) lrow[r0] = m0 + logf(l0);
    if (r1 < n) lrow[r1] = m1 + logf(l1);
  }
}

template <int HD>
cudaError_t launch_fwd(const Fwd& a, cudaStream_t st) {
  cudaError_t e;
  if (a.n <= kSmallMaxN) {
    const long long pairs = (long long)a.nb * a.h;
    const unsigned grid = (unsigned)((pairs + kFwdSmallWarps - 1) / kFwdSmallWarps);
    if (a.n <= 16) {
      constexpr int smem = FwdSmall<HD, 16>::BYTES;
      if ((e = allow_smem(attn_fwd_small_kernel<HD, 16>, smem)) != cudaSuccess) return e;
      attn_fwd_small_kernel<HD, 16><<<grid, 32 * kFwdSmallWarps, smem, st>>>(a);
    } else {
      constexpr int smem = FwdSmall<HD, 32>::BYTES;
      if ((e = allow_smem(attn_fwd_small_kernel<HD, 32>, smem)) != cudaSuccess) return e;
      attn_fwd_small_kernel<HD, 32><<<grid, 32 * kFwdSmallWarps, smem, st>>>(a);
    }
    return cudaGetLastError();
  }
  const int smem = fwd_wide_smem<HD>(a.n);
  // the scores on the CUDA cores where a warp's rows fit its registers
  auto kern = attn_fwd_wide_kernel<HD, HD <= 32>;
  if ((e = allow_smem(kern, smem)) != cudaSuccess) return e;
  kern<<<dim3(a.nb, a.h, wide_chunks(a.n)), 32 * wide_warps(a.n), smem, st>>>(a);
  return cudaGetLastError();
}

// ---- backward --------------------------------------------------------------------

struct Bwd {
  In q, k, v, o, dout;
  const float* lse;  // (nb, h, n)
  Bias bias;
  Out dq, dk, dv;
  float* dbias;  // (nw, h, n, n)
  float* ds;     // the wide route's (nb, h, n, n) scratch
  int nb, h, n, nw;
};

// ---- the small route: a block per (slot, head), a warp per image ----------------

constexpr int kSmallMaxWarps = 8;

template <int HD>
__device__ __forceinline__ void axpy_row(float (&acc)[HD], float a, const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 x = b4[d4];
    acc[4 * d4] += a * x.x;
    acc[4 * d4 + 1] += a * x.y;
    acc[4 * d4 + 2] += a * x.z;
    acc[4 * d4 + 3] += a * x.w;
  }
}

template <int HD>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&x)[HD]) {
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4)
    reinterpret_cast<float4*>(dst)[d4] =
        make_float4(x[4 * d4], x[4 * d4 + 1], x[4 * d4 + 2], x[4 * d4 + 3]);
}

// The shared memory of the small route: per warp and image of the warp, the
// rows of q, k, v, do (stride HD + 4) and P, ds (stride NP + 1); per block
// the bias tile (stride NP + 1). After the walk the warps' tiles hold the
// dbias partials.
template <int HD, int NP>
struct Small {
  static constexpr int IPW = 32 / NP;  // images a warp at once
  static constexpr int RS = HD + 4, PS = NP + 1;
  static constexpr int IMG = 4 * NP * RS + 2 * NP * PS;  // floats an image
  static constexpr int WARP = IPW * IMG;
  static int bytes(int warps) { return (warps * WARP + NP * PS) * 4; }
};

template <int HD, int NP>
__global__ void __launch_bounds__(32 * kSmallMaxWarps) attn_bwd_small_kernel(const Bwd a) {
  using L = Small<HD, NP>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int n = a.n, h = a.h, w = blockIdx.x, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int half = lane / NP, r = lane % NP;  // this lane's image of the warp's, and row
  const int nimg = a.nb / a.nw, groups = (nimg + L::IPW - 1) / L::IPW;
  float* Bs = sm + warps * L::WARP;
  const float* bsrc = a.bias.at(w, head);
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    Bs[(e / n) * L::PS + e % n] = bsrc[(e / n) * a.bias.si + (e % n) * a.bias.sj];
  float* img = sm + warp * L::WARP + half * L::IMG;
  float* Qs = img;
  float* Ks = Qs + NP * L::RS;
  float* Vs = Ks + NP * L::RS;
  float* Ds_o = Vs + NP * L::RS;  // do
  float* Ps = Ds_o + NP * L::RS;
  float* Gs = Ps + NP * L::PS;  // ds
  float dbacc[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) dbacc[j] = 0.f;
  __syncthreads();

  for (int grp = warp; grp < groups; grp += warps) {
    const int b = grp * L::IPW + half;
    const bool live = b < nimg;
    const int rw = b * a.nw + w;  // the image's row
    const long long base = ((long long)rw * h + head) * n;  // its lse
    // the image's q, k, v and do rows into the warp's tiles (a half-warp an
    // image at NP = 16)
    if (live) {
      const In* src[4] = {&a.q, &a.k, &a.v, &a.dout};
      float* dst[4] = {Qs, Ks, Vs, Ds_o};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float* p = src[m]->at(rw, head);
        const int st = src[m]->st;
        for (int e = r; e < n * HD / 4; e += NP) {
          const int row = e / (HD / 4), d = 4 * (e % (HD / 4));
          *reinterpret_cast<float4*>(dst[m] + row * L::RS + d) =
              __ldg(reinterpret_cast<const float4*>(p + row * st + d));
        }
      }
    }
    __syncwarp();
    // lane i: row i of P and ds, its dbias share, then dq_i. The logits and
    // dP of the row as NP independent sums (each over d in order), so the
    // FMA chains interleave.
    const bool row_ok = live && r < n;
    if (row_ok) {
      float s[NP], dp[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) s[j] = dp[j] = 0.f;
      float D = 0.f;
      const float4* orow = reinterpret_cast<const float4*>(a.o.at(rw, head) + r * a.o.st);
#pragma unroll 2
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 qi = reinterpret_cast<const float4*>(Qs + r * L::RS)[d4];
        const float4 di = reinterpret_cast<const float4*>(Ds_o + r * L::RS)[d4];
        const float4 oi = __ldg(orow + d4);
        D += di.x * oi.x;
        D += di.y * oi.y;
        D += di.z * oi.z;
        D += di.w * oi.w;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const float4 kj = reinterpret_cast<const float4*>(Ks + j * L::RS)[d4];
          const float4 vj = reinterpret_cast<const float4*>(Vs + j * L::RS)[d4];
          s[j] += qi.x * kj.x;
          s[j] += qi.y * kj.y;
          s[j] += qi.z * kj.z;
          s[j] += qi.w * kj.w;
          dp[j] += di.x * vj.x;
          dp[j] += di.y * vj.y;
          dp[j] += di.z * vj.z;
          dp[j] += di.w * vj.w;
        }
      }
      const float L_i = __ldg(a.lse + base + r);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (j < n) {
          const float p = expf(s[j] + Bs[r * L::PS + j] - L_i);
          const float ds = p * (dp[j] - D);
          Ps[r * L::PS + j] = p;
          Gs[r * L::PS + j] = ds;
          dbacc[j] += ds;
        }
      }
    }
    __syncwarp();
    if (row_ok) {
      float acc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = 0.f;
      for (int j = 0; j < n; ++j) axpy_row<HD>(acc, Gs[r * L::PS + j], Ks + j * L::RS);
      store_row<HD>(a.dq.at(rw, head) + r * a.dq.st, acc);
      // lane j: dv_j = sum_i P_ij do_i, dk_j = sum_i ds_ij q_i
      float dv[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = dv[d] = 0.f;
      for (int i = 0; i < n; ++i) {
        axpy_row<HD>(dv, Ps[i * L::PS + r], Ds_o + i * L::RS);
        axpy_row<HD>(acc, Gs[i * L::PS + r], Qs + i * L::RS);
      }
      store_row<HD>(a.dv.at(rw, head) + r * a.dv.st, dv);
      store_row<HD>(a.dk.at(rw, head) + r * a.dk.st, acc);
    }
    __syncwarp();
  }

  // dbias: each lane's partial into the (now free) tiles, then one sum per
  // element over the warps' partials in a fixed order
  __syncthreads();
  float* part = sm + (warp * L::IPW + half) * NP * L::PS;
#pragma unroll
  for (int j = 0; j < NP; ++j) part[r * L::PS + j] = dbacc[j];
  __syncthreads();
  float* dst = a.dbias + ((long long)w * h + head) * n * n;
  const int parts = warps * L::IPW;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    float s = 0.f;
    for (int pi = 0; pi < parts; ++pi) s += sm[pi * NP * L::PS + i * L::PS + j];
    dst[e] = s;
  }
}

// ---- the wide route: query and key blocks on the tensor cores --------------------

// two neighbouring columns c, c + 1 of a score row (c even), as far as n
__device__ __forceinline__ void store_pair(float* row, int c, int n, float x0, float x1) {
  if (c + 1 < n) *reinterpret_cast<float2*>(row + c) = make_float2(x0, x1);
  else if (c < n) row[c] = x0;
}

// Blocks z < nqc take 16 queries a warp: P = exp(q k^T + bias - lse),
// dP = do v^T, ds = P (dP - D) into the scratch, dq = ds k. Blocks
// z >= nqc take 16 keys a warp: dv = P^T do, dk = ds^T q. The bias's rows
// are contiguous (sj = 1): a column stride in these loops' address
// arithmetic cost 10% of the kernel at scOT-B stage 0 (0.445 against 0.408
// ms, NVIDIA H100), and the wrapper copies a bias with another.
template <int HD, bool F32S>
__global__ void __launch_bounds__(32 * kWideWarps, 1) attn_bwd_wide_kernel(const Bwd a, int nqc) {
  using AT = Attn<HD>;
  extern __shared__ float4 smem4[];
  const int n = a.n, np = (n + KC - 1) / KC * KC;
  const int row = blockIdx.x, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;
  const long long bh = (long long)row * a.h + head;
  const float* q = a.q.at(row, head);
  const float* k = a.k.at(row, head);
  const float* v = a.v.at(row, head);
  const float* o = a.o.at(row, head);
  const float* dout = a.dout.at(row, head);
  const Bias& B = a.bias;
  const float* bmat = B.at(row % a.nw, head);
  float* S1 = reinterpret_cast<float*>(smem4);
  float* S2 = S1 + np * AT::KSTR;
  float* Dl = S2 + np * AT::KSTR;
  float* Ll = Dl + np;
  float* Pw = Ll + np + warp * 16 * AT::PSTR;
  if ((int)blockIdx.z < nqc) {
    // ---- queries: S1 = k, S2 = v
    load_tile<HD>(S1, k, a.k.st, np, n);
    load_tile<HD>(S2, v, a.v.st, np, n);
    __syncthreads();
    const int i0 = (blockIdx.z * warps + warp) * 16;
    if (i0 >= n) return;
    const int r0 = i0 + gq, r1 = r0 + 8;
    Rows<HD, F32S> qv, dov;
    load_rows<HD, F32S>(qv, q, a.q.st, r0, r1, n);
    load_rows<HD, F32S>(dov, dout, a.dout.st, r0, r1, n);
    float D0 = 0.f, D1 = 0.f;
    {  // D = do . o over the rows, in float32, a quad's lanes a quarter each
      const float* g0 = dout + (r0 < n ? r0 : 0) * a.dout.st;
      const float* g1 = dout + (r1 < n ? r1 : 0) * a.dout.st;
      const float* o0 = o + (r0 < n ? r0 : 0) * a.o.st;
      const float* o1 = o + (r1 < n ? r1 : 0) * a.o.st;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int c = 8 * kk + t;
        D0 += __ldg(g0 + c) * __ldg(o0 + c) + __ldg(g0 + c + 4) * __ldg(o0 + c + 4);
        D1 += __ldg(g1 + c) * __ldg(o1 + c) + __ldg(g1 + c + 4) * __ldg(o1 + c + 4);
      }
    }
    D0 = quad_sum(r0 < n ? D0 : 0.f), D1 = quad_sum(r1 < n ? D1 : 0.f);
    const float lse0 = r0 < n ? a.lse[bh * n + r0] : 0.f;
    const float lse1 = r1 < n ? a.lse[bh * n + r1] : 0.f;
    const float* b0row = bmat + (r0 < n ? r0 : 0) * B.si;
    const float* b1row = bmat + (r1 < n ? r1 : 0) * B.si;
    float* ds0 = a.ds + (bh * n + r0) * n;
    float* ds1 = a.ds + (bh * n + r1) * n;
    float dq[HD / 8][4] = {};
    for (int jc = 0; jc < np; jc += KC) {
      float s[KC / 8][4], dp[KC / 8][4];
      scores<HD, F32S>(s, qv, S1, jc);
      scores<HD, F32S>(dp, dov, S2, jc);
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        const int col = jc + 8 * j + 2 * t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cc = col + (i & 1);
          const bool top = i < 2;
          float ds = 0.f;
          if (cc < n) {
            const float bv = __ldg((top ? b0row : b1row) + cc);
            const float p = expf(s[j][i] + bv - (top ? lse0 : lse1));
            ds = p * (dp[j][i] - (top ? D0 : D1));
          }
          dp[j][i] = ds;
        }
        if (r0 < n) store_pair(ds0, col, n, dp[j][0], dp[j][1]);
        if (r1 < n) store_pair(ds1, col, n, dp[j][2], dp[j][3]);
      }
      tile_to_smem(Pw, dp);
      __syncwarp();
      tile_times<HD, true>(dq, Pw, S1, AT::KSTR, jc);
      __syncwarp();
    }
    store_frag_rows<HD>(a.dq.at(row, head), a.dq.st, dq, r0, r1, n);
    return;
  }
  // ---- keys: S1 = q, S2 = do, then D and lse per query row
  load_tile<HD>(S1, q, a.q.st, np, n);
  load_tile<HD>(S2, dout, a.dout.st, np, n);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* orow = o + i * a.o.st;
    float D = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) D += S2[i * AT::KSTR + d] * __ldg(orow + d);
    Dl[i] = D;
    Ll[i] = a.lse[bh * n + i];
  }
  __syncthreads();
  const int j0 = ((blockIdx.z - nqc) * warps + warp) * 16;
  if (j0 >= n) return;
  const int r0 = j0 + gq, r1 = r0 + 8;
  Rows<HD, F32S> kv, vv;
  load_rows<HD, F32S>(kv, k, a.k.st, r0, r1, n);
  load_rows<HD, F32S>(vv, v, a.v.st, r0, r1, n);
  float dv[HD / 8][4] = {}, dk[HD / 8][4] = {};
  for (int ic = 0; ic < np; ic += KC) {
    float s[KC / 8][4], dp[KC / 8][4];
    scores<HD, F32S>(s, kv, S1, ic);
    scores<HD, F32S>(dp, vv, S2, ic);
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = ic + 8 * j + 2 * t + (i & 1);
        const int kj = i < 2 ? r0 : r1;
        float p = 0.f, ds = 0.f;
        if (qi < n && kj < n) {
          p = expf(s[j][i] + __ldg(bmat + qi * B.si + kj) - Ll[qi]);
          ds = p * (dp[j][i] - Dl[qi]);
        }
        s[j][i] = p, dp[j][i] = ds;
      }
    // dv += P^T do, then dk += ds^T q
    tile_to_smem(Pw, s);
    __syncwarp();
    tile_times<HD, true>(dv, Pw, S2, AT::KSTR, ic);
    __syncwarp();
    tile_to_smem(Pw, dp);
    __syncwarp();
    tile_times<HD, true>(dk, Pw, S1, AT::KSTR, ic);
    __syncwarp();
  }
  store_frag_rows<HD>(a.dv.at(row, head), a.dv.st, dv, r0, r1, n);
  store_frag_rows<HD>(a.dk.at(row, head), a.dk.st, dk, r0, r1, n);
}

// dbias[w][e] = the sum over the rows r = w, w + nw, ... < nb of ds[r][e],
// in that order; e < per = h n n.
__global__ void dbias_sum_kernel(const float* __restrict__ ds, float* __restrict__ dbias, int nb,
                                 int nw, long long per) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nw * per) return;
  const int w = (int)(idx / per);
  const long long e = idx % per;
  float s = 0.f;
  for (int r = w; r < nb; r += nw) s += ds[(long long)r * per + e];
  dbias[idx] = s;
}

template <int HD>
int wide_smem(int n) {
  using A = Attn<HD>;
  return (wide_np(n) * (2 * A::KSTR + 2) + wide_warps(n) * 16 * A::PSTR) * 4;
}

template <int HD>
int small_warps(int nimg, int np) {
  const int ipw = 32 / np;
  int w = (nimg + ipw - 1) / ipw;
  w = w < kSmallMaxWarps ? w : kSmallMaxWarps;
  const int per = np == 16 ? Small<HD, 16>::WARP : Small<HD, 32>::WARP;
  const int fit = (227 * 1024 / 4 - np * (np + 1)) / per;
  return w < fit ? w : fit;
}

template <int HD>
cudaError_t small_bwd(const Bwd& a, cudaStream_t st) {
  const int np = a.n <= 16 ? 16 : 32;
  const int warps = small_warps<HD>(a.nb / a.nw, np);
  if (warps < 1) return cudaErrorInvalidValue;
  const dim3 grid(a.nw, a.h);
  cudaError_t e;
  if (np == 16) {
    const int smem = Small<HD, 16>::bytes(warps);
    if ((e = allow_smem(attn_bwd_small_kernel<HD, 16>, smem)) != cudaSuccess) return e;
    attn_bwd_small_kernel<HD, 16><<<grid, 32 * warps, smem, st>>>(a);
  } else {
    const int smem = Small<HD, 32>::bytes(warps);
    if ((e = allow_smem(attn_bwd_small_kernel<HD, 32>, smem)) != cudaSuccess) return e;
    attn_bwd_small_kernel<HD, 32><<<grid, 32 * warps, smem, st>>>(a);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t wide_bwd(const Bwd& a, cudaStream_t st, int* launched) {
  if (a.bias.sj != 1) return cudaErrorInvalidValue;
  const int smem = wide_smem<HD>(a.n), nqc = wide_chunks(a.n);
  // the scores on the CUDA cores where a warp's rows fit its registers
  auto kern = attn_bwd_wide_kernel<HD, HD <= 32>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.nb, a.h, 2 * nqc), 32 * wide_warps(a.n), smem, st>>>(a, nqc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  const long long per = (long long)a.h * a.n * a.n, total = a.nw * per;
  dbias_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(a.ds, a.dbias, a.nb, a.nw,
                                                                    per);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  return cudaSuccess;
}

// a stride whose n steps stay within an int (the kernels' 32-bit offsets)
bool slice_fits(long long stride, int n) {
  return stride >= 0 && stride <= 0x7fffffffLL / (n > 0 ? n : 1);
}

}  // namespace

extern "C" {

// out = softmax(q k^T + bias) v, the arguments packed by the wrapper as 28
// int64 (one pointer crosses ctypes, not 28 arguments): the pointers q, k,
// v, bias, out, lse; the (row, head, token) strides of q, k, v and out (the
// last dim contiguous, rows 16-byte aligned); the bias's four strides; nb,
// h, n, hd, nw; the stream. lse (nb, h, n) contiguous, or 0 (nothing
// saved). hd in {8, 16, 32, 64}, n within the wide route's shared memory,
// nb % nw == 0 (checked by the wrapper).
int window_attention_fwd(const long long* p) {
  const auto f = [p](int i) { return reinterpret_cast<const float*>(p[i]); };
  const long long* s = p + 6;
  const int n = (int)p[24];
  for (int i : {2, 5, 8, 11, 14, 15})
    if (!slice_fits(s[i], n)) return cudaErrorInvalidValue;
  const Fwd a{In{f(0), s[0], s[1], (int)s[2]},   In{f(1), s[3], s[4], (int)s[5]},
              In{f(2), s[6], s[7], (int)s[8]},
              Bias{f(3), s[12], s[13], (int)s[14], (int)s[15]},
              Out{reinterpret_cast<float*>(p[4]), s[9], s[10], (int)s[11]},
              reinterpret_cast<float*>(p[5]), (int)p[22], (int)p[23], n, (int)p[26]};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p[27]);
  switch (p[25]) {
    case 8: return launch_fwd<8>(a, st);
    case 16: return launch_fwd<16>(a, st);
    case 32: return launch_fwd<32>(a, st);
    case 64: return launch_fwd<64>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory (bytes) the forward's (fwd = 1) or the
// backward's (fwd = 0) kernel takes for n, hd and, in the backward, nb / nw
// images a slot; the wrapper refuses what exceeds the card's.
int window_attention_smem(int fwd, int n, int hd, int nimg) {
  const int np = n <= 16 ? 16 : 32;
  switch (hd) {
#define PREGEN_SMEM(HD)                                                              \
  case HD:                                                                           \
    if (fwd) return n > kSmallMaxN ? fwd_wide_smem<HD>(n)                            \
                                   : np == 16 ? FwdSmall<HD, 16>::BYTES              \
                                              : FwdSmall<HD, 32>::BYTES;             \
    if (n > kSmallMaxN) return wide_smem<HD>(n);                                     \
    return np == 16 ? Small<HD, 16>::bytes(small_warps<HD>(nimg, 16))                \
                    : Small<HD, 32>::bytes(small_warps<HD>(nimg, 32));
    PREGEN_SMEM(8)
    PREGEN_SMEM(16)
    PREGEN_SMEM(32)
    PREGEN_SMEM(64)
#undef PREGEN_SMEM
    default: return -1;
  }
}

// Gradients of window_attention_fwd from its output o and lse, the
// arguments packed as 46 int64: the pointers q, k, v, o, do, lse, bias, dq,
// dk, dv, dbias, ds; the (row, head, token) strides of q, k, v, o, do, dq,
// dk, dv; the bias's four strides; nb, h, n, hd, nw; the stream. lse (nb,
// h, n) and dbias (nw, h, n, n, summed over images) contiguous; ds the wide
// route's (nb, h, n, n) scratch (0 on the small route). `launched` reports
// the kernels enqueued.
int window_attention_bwd(const long long* p, int* launched) {
  *launched = 0;
  const auto f = [p](int i) { return reinterpret_cast<const float*>(p[i]); };
  const auto w = [p](int i) { return reinterpret_cast<float*>(p[i]); };
  const long long* s = p + 12;
  const int nb = (int)p[40], h = (int)p[41], n = (int)p[42], hd = (int)p[43], nw = (int)p[44];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(p[45]);
  float* ds = w(11);
  for (int i : {2, 5, 8, 11, 14, 17, 20, 23, 26, 27})
    if (!slice_fits(s[i], n)) return cudaErrorInvalidValue;
  const auto in = [&](int i, int j) { return In{f(i), s[j], s[j + 1], (int)s[j + 2]}; };
  const auto out = [&](int i, int j) { return Out{w(i), s[j], s[j + 1], (int)s[j + 2]}; };
  const Bwd a{in(0, 0), in(1, 3), in(2, 6), in(3, 9), in(4, 12), f(5),
              Bias{f(6), s[24], s[25], (int)s[26], (int)s[27]},
              out(7, 15), out(8, 18), out(9, 21), w(10), ds, nb, h, n, nw};
  if (n > kSmallMaxN && ds == nullptr) return cudaErrorInvalidValue;
  cudaError_t e;
  switch (hd) {
#define PREGEN_BWD(HD)                                 \
  case HD:                                             \
    if (n > kSmallMaxN) return wide_bwd<HD>(a, st, launched); \
    e = small_bwd<HD>(a, st);                          \
    break;
    PREGEN_BWD(8)
    PREGEN_BWD(16)
    PREGEN_BWD(32)
    PREGEN_BWD(64)
#undef PREGEN_BWD
    default: return cudaErrorInvalidValue;
  }
  if (e == cudaSuccess) *launched = 1;
  return (int)e;
}

}  // extern "C"
