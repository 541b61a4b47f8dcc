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
// Forward. One block per (row, head); the row's k and v tiles (n x hd)
// sit in shared memory, one thread per query row keeps q and its output in
// registers and walks the keys with an online float32 softmax, so the
// n x n logit tile is never stored. When the backward will run it also
// writes each row's log-sum-exp, m + log l (nb, h, n), from which the
// backward rebuilds P without a softmax of its own. What bounds it: the
// 4 n^2 hd FLOP per (row, head) on the float32 CUDA cores, latency bound
// (one thread per row, a serial walk over the keys); its redesign is
// queued.
//
// Backward, with s = q k^T + bias, P = exp(s - lse), D_i = do_i . o_i:
//   dv = P^T do,  dP = do v^T,  ds = P (dP - D),  dq = ds k,  dk = ds^T q,
//   dbias[w] = the sum of ds over the rows of slot w, in a fixed order.
// Two routes, by n:
//   small (n <= 32; scOT-B's stage 3 is n = 16, hd = 32, 24 heads): ONE
//     launch. A block per (slot, head) walks the slot's images, a warp per
//     image (two per warp at n <= 16: a lane a row), with the image's q, k,
//     v and do in the warp's shared memory. Lane i forms row i of P and ds
//     on the float32 CUDA cores (keeping them in shared memory) and dq_i;
//     then lane j forms dk_j and dv_j from the columns. Each lane adds its
//     rows of ds into registers over its images, and the block sums those
//     partials in a fixed order into dbias: no score-gradient scratch, no
//     atomics, no second launch; bitwise repeatable. What bounds it: the
//     10 n^2 hd FLOP per (row, head) on the CUDA cores of the nw h blocks
//     (24 at stage 3), and the wrapper's enqueue.
//   wide (n > 32; the attention-only route's n = 64 and 256): TWO launches.
//     The attention backward in blocks of two kinds, 16 rows a warp, 8
//     warps a block: per (row, head, 128 queries) P from the lse, dP, ds
//     and dq, with ds written to a float32 (nb, h, n, n) scratch; per (row,
//     head, 128 keys) P^T and ds^T again, dv and dk. Then one pass sums the
//     scratch over the images of each slot in a fixed order. The products
//     over n (dq = ds k, dk = ds^T q, dv = P^T do) run on the tensor cores
//     in 3xTF32 (attn_mma.cuh, each k step's three products added in
//     float32). The scores S and dP, sums of only hd = 32 products, run on
//     the CUDA cores in float32, each lane holding its two rows in
//     registers: 3xTF32 keeps ~2^-21 of a product (float32 2^-24), and at
//     hd = 32 that error is not averaged away, so on the tensor cores every
//     cotangent read 2.3-2.8x the plain version's own float32 error against
//     float64, 1.55-1.89x here (NVIDIA H100, variants.py). hd = 64 keeps
//     the scores on the tensor cores (four rows of 64 do not fit a lane's
//     registers). The
//     scratch's round trip (2 x 50 MB at scOT-B stage 0, B = 16) is what a
//     slot's n x n sum costs when it does not fit a block. What bounds it:
//     the scores' 8 n^2 hd FLOP a (row, head) on the CUDA cores (0.048 ms
//     at stage 0, B = 16, at 67 TFLOP/s) and the scratch (0.03 ms at 3.35
//     TB/s), far from both.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; the entry points return cudaGetLastError() and report
// how many kernels they enqueued (`launched`).

#include <cuda_runtime.h>
#include <math.h>

#include "attn_mma.cuh"

namespace {

// Dynamic shared memory above 48 KB has to be opted into.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---- forward --------------------------------------------------------------------

template <int HD>
__global__ void window_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ bias, float* __restrict__ out,
                                        float* __restrict__ lse, int h, int n, int nw) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + n * HD;
  const int row = blockIdx.x, head = blockIdx.y;
  const long long base = ((long long)row * h + head) * n * HD;
  const float4* k4 = reinterpret_cast<const float4*>(k + base);
  const float4* v4 = reinterpret_cast<const float4*>(v + base);
  for (int e = threadIdx.x; e < n * HD / 4; e += blockDim.x) {
    reinterpret_cast<float4*>(ks)[e] = k4[e];
    reinterpret_cast<float4*>(vs)[e] = v4[e];
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= n) return;
  float qr[HD], acc[HD];
  const float4* q4 = reinterpret_cast<const float4*>(q + base + (long long)i * HD);
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 t = q4[d4];
    qr[4 * d4] = t.x, qr[4 * d4 + 1] = t.y, qr[4 * d4 + 2] = t.z, qr[4 * d4 + 3] = t.w;
    acc[4 * d4] = acc[4 * d4 + 1] = acc[4 * d4 + 2] = acc[4 * d4 + 3] = 0.f;
  }
  const float* brow = bias + (((long long)(row % nw) * h + head) * n + i) * n;
  // online softmax in float32: a running max and sum, rescaled when the max
  // grows (expf, not __expf: the bars against the plain version are ~1e-5)
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < n; ++j) {
    const float4* kj = reinterpret_cast<const float4*>(ks + j * HD);
    float s = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = kj[d4];
      s += qr[4 * d4] * kk.x;
      s += qr[4 * d4 + 1] * kk.y;
      s += qr[4 * d4 + 2] * kk.z;
      s += qr[4 * d4 + 3] * kk.w;
    }
    s = s + __ldg(brow + j);
    if (s > m) {
      const float c = expf(m - s);
      l *= c;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= c;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
    const float4* vj = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 vv = vj[d4];
      acc[4 * d4] += p * vv.x;
      acc[4 * d4 + 1] += p * vv.y;
      acc[4 * d4 + 2] += p * vv.z;
      acc[4 * d4 + 3] += p * vv.w;
    }
  }
  const float inv = 1.f / l;
  float4* o4 = reinterpret_cast<float4*>(out + base + (long long)i * HD);
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4)
    o4[d4] = make_float4(acc[4 * d4] * inv, acc[4 * d4 + 1] * inv, acc[4 * d4 + 2] * inv,
                         acc[4 * d4 + 3] * inv);
  if (lse != nullptr) lse[((long long)row * h + head) * n + i] = m + logf(l);
}

// ---- backward --------------------------------------------------------------------

struct Bwd {
  const float *q, *k, *v, *o, *dout, *lse, *bias;  // (nb, h, n, hd) / (nb, h, n) / (nw, h, n, n)
  float *dq, *dk, *dv, *dbias;
  float* ds;  // the wide route's (nb, h, n, n) scratch
  int nb, h, n, nw;
};

// ---- the small route: a block per (slot, head), a warp per image ----------------

constexpr int kSmallMaxN = 32;
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
  const float* bsrc = a.bias + ((long long)w * h + head) * n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) Bs[(e / n) * L::PS + e % n] = bsrc[e];
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
    const long long base = (((long long)(b * a.nw + w)) * h + head) * n;  // row b nw + w
    // the image's q, k, v and do rows into the warp's tiles (a half-warp an
    // image at NP = 16)
    if (live) {
      const float* src[4] = {a.q + base * HD, a.k + base * HD, a.v + base * HD,
                             a.dout + base * HD};
      float* dst[4] = {Qs, Ks, Vs, Ds_o};
#pragma unroll
      for (int m = 0; m < 4; ++m)
        for (int e = r; e < n * HD / 4; e += NP) {
          const int row = e / (HD / 4), d = 4 * (e % (HD / 4));
          *reinterpret_cast<float4*>(dst[m] + row * L::RS + d) =
              __ldg(reinterpret_cast<const float4*>(src[m]) + e);
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
      const float4* orow = reinterpret_cast<const float4*>(a.o + (base + r) * HD);
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
      store_row<HD>(a.dq + (base + r) * HD, acc);
      // lane j: dv_j = sum_i P_ij do_i, dk_j = sum_i ds_ij q_i
      float dv[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = dv[d] = 0.f;
      for (int i = 0; i < n; ++i) {
        axpy_row<HD>(dv, Ps[i * L::PS + r], Ds_o + i * L::RS);
        axpy_row<HD>(acc, Gs[i * L::PS + r], Qs + i * L::RS);
      }
      store_row<HD>(a.dv + (base + r) * HD, dv);
      store_row<HD>(a.dk + (base + r) * HD, acc);
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

constexpr int kWideWarps = 8;

// rows [0, np) of a (row, head)'s n x HD tile at src into shared memory
// (stride KSTR), zero past n
template <int HD>
__device__ void load_tile(float* dst, const float* __restrict__ src, int np, int n) {
  constexpr int S = Attn<HD>::KSTR;
  for (int e = threadIdx.x; e < np * (HD / 4); e += blockDim.x) {
    const int j = e / (HD / 4), d = 4 * (e % (HD / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < n) v = __ldg(reinterpret_cast<const float4*>(src + (long long)j * HD + d));
    float* o = dst + j * S + d;
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
}

// A warp's rows r0 = i0 + g and r1 = i0 + g + 8 of an n x HD tile in the A
// layout, zero past n, split once into TF32 hi and lo parts (a chunk's
// products reuse them for every chunk of the other operand)
template <int HD>
__device__ __forceinline__ void frag_rows(FragA (&x)[HD / 8], const float* __restrict__ src,
                                          int r0, int r1, int n) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float* p0 = src + (long long)(r0 < n ? r0 : 0) * HD + 8 * kk + t;
    const float* p1 = src + (long long)(r1 < n ? r1 : 0) * HD + 8 * kk + t;
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
__device__ __forceinline__ void load_rows(Rows<HD, F32S>& x, const float* __restrict__ src, int r0,
                                          int r1, int n) {
  if constexpr (F32S) {
    const float4* p0 = reinterpret_cast<const float4*>(src + (long long)(r0 < n ? r0 : 0) * HD);
    const float4* p1 = reinterpret_cast<const float4*>(src + (long long)(r1 < n ? r1 : 0) * HD);
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 u = r0 < n ? __ldg(p0 + d4) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 w = r1 < n ? __ldg(p1 + d4) : make_float4(0.f, 0.f, 0.f, 0.f);
      x.a[4 * d4] = u.x, x.a[4 * d4 + 1] = u.y, x.a[4 * d4 + 2] = u.z, x.a[4 * d4 + 3] = u.w;
      x.b[4 * d4] = w.x, x.b[4 * d4 + 1] = w.y, x.b[4 * d4 + 2] = w.z, x.b[4 * d4 + 3] = w.w;
    }
  } else {
    frag_rows<HD>(x.f, src, r0, r1, n);
  }
}

// s (16 x KC) = the rows x times the rows [r0, r0 + KC) of Bm, transposed
template <int HD, bool F32S>
__device__ __forceinline__ void scores(float (&s)[KC / 8][4], const Rows<HD, F32S>& x,
                                       const float* Bm, int r0) {
  if constexpr (F32S) f32_times_t<HD>(s, x.a, x.b, Bm, r0);
  else split_times_t<HD>(s, x.f, Bm, r0);
}

// rows r0, r1 of an accumulator-layout HD-wide result to dst (n x HD)
template <int HD>
__device__ __forceinline__ void store_frag_rows(float* __restrict__ dst,
                                                const float (&x)[HD / 8][4], int r0, int r1,
                                                int n) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    if (r0 < n)
      *reinterpret_cast<float2*>(dst + (long long)r0 * HD + 8 * d + 2 * t) =
          make_float2(x[d][0], x[d][1]);
    if (r1 < n)
      *reinterpret_cast<float2*>(dst + (long long)r1 * HD + 8 * d + 2 * t) =
          make_float2(x[d][2], x[d][3]);
  }
}

// two neighbouring columns c, c + 1 of a score row (c even), as far as n
__device__ __forceinline__ void store_pair(float* row, int c, int n, float x0, float x1) {
  if (c + 1 < n) *reinterpret_cast<float2*>(row + c) = make_float2(x0, x1);
  else if (c < n) row[c] = x0;
}

// Blocks z < nqc take 16 queries a warp: P = exp(q k^T + bias - lse),
// dP = do v^T, ds = P (dP - D) into the scratch, dq = ds k. Blocks
// z >= nqc take 16 keys a warp: dv = P^T do, dk = ds^T q.
template <int HD, bool F32S>
__global__ void __launch_bounds__(32 * kWideWarps, 1) attn_bwd_wide_kernel(const Bwd a, int nqc) {
  using AT = Attn<HD>;
  extern __shared__ float4 smem4[];
  const int n = a.n, np = (n + KC - 1) / KC * KC;
  const int row = blockIdx.x, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;
  const long long bh = (long long)row * a.h + head;
  const long long base = bh * n * HD;
  const float* bmat = a.bias + (long long)((row % a.nw) * a.h + head) * n * n;
  float* S1 = reinterpret_cast<float*>(smem4);
  float* S2 = S1 + np * AT::KSTR;
  float* Dl = S2 + np * AT::KSTR;
  float* Ll = Dl + np;
  float* Pw = Ll + np + warp * 16 * AT::PSTR;
  if ((int)blockIdx.z < nqc) {
    // ---- queries: S1 = k, S2 = v
    load_tile<HD>(S1, a.k + base, np, n);
    load_tile<HD>(S2, a.v + base, np, n);
    __syncthreads();
    const int i0 = (blockIdx.z * warps + warp) * 16;
    if (i0 >= n) return;
    const int r0 = i0 + gq, r1 = r0 + 8;
    Rows<HD, F32S> qv, dov;
    load_rows<HD, F32S>(qv, a.q + base, r0, r1, n);
    load_rows<HD, F32S>(dov, a.dout + base, r0, r1, n);
    float D0 = 0.f, D1 = 0.f;
    {  // D = do . o over the rows, in float32, a quad's lanes a quarter each
      const float* g0 = a.dout + base + (long long)(r0 < n ? r0 : 0) * HD;
      const float* g1 = a.dout + base + (long long)(r1 < n ? r1 : 0) * HD;
      const float* o0 = a.o + base + (long long)(r0 < n ? r0 : 0) * HD;
      const float* o1 = a.o + base + (long long)(r1 < n ? r1 : 0) * HD;
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
    const float* b0row = bmat + (long long)(r0 < n ? r0 : 0) * n;
    const float* b1row = bmat + (long long)(r1 < n ? r1 : 0) * n;
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
    store_frag_rows<HD>(a.dq + base, dq, r0, r1, n);
    return;
  }
  // ---- keys: S1 = q, S2 = do, then D and lse per query row
  load_tile<HD>(S1, a.q + base, np, n);
  load_tile<HD>(S2, a.dout + base, np, n);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* orow = a.o + base + (long long)i * HD;
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
  load_rows<HD, F32S>(kv, a.k + base, r0, r1, n);
  load_rows<HD, F32S>(vv, a.v + base, r0, r1, n);
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
          p = expf(s[j][i] + __ldg(bmat + (long long)qi * n + kj) - Ll[qi]);
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
  store_frag_rows<HD>(a.dv + base, dv, r0, r1, n);
  store_frag_rows<HD>(a.dk + base, dk, r0, r1, n);
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

int wide_np(int n) { return (n + KC - 1) / KC * KC; }
int wide_warps(int n) { return n / 16 < kWideWarps ? (n + 15) / 16 : kWideWarps; }
int wide_chunks(int n) { return (n + 16 * wide_warps(n) - 1) / (16 * wide_warps(n)); }

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

template <int HD>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const float* bias,
                       float* out, float* lse, int nb, int h, int n, int nw, cudaStream_t st) {
  const int smem = 2 * n * HD * (int)sizeof(float);
  cudaError_t e = allow_smem(window_attention_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  const int threads = (n + 31) / 32 * 32;
  window_attention_kernel<HD><<<dim3(nb, h), threads, smem, st>>>(q, k, v, bias, out, lse, h, n,
                                                                  nw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: (nb, h, n, hd) float32, contiguous; bias: (nw, h, n, n);
// lse (nb, h, n) or null (nothing saved). hd in {8, 16, 32, 64}, n <= 1024,
// nb % nw == 0 (checked by the wrapper).
int window_attention_fwd(const float* q, const float* k, const float* v, const float* bias,
                         float* out, float* lse, int nb, int h, int n, int hd, int nw,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch_fwd<8>(q, k, v, bias, out, lse, nb, h, n, nw, st);
    case 16: return launch_fwd<16>(q, k, v, bias, out, lse, nb, h, n, nw, st);
    case 32: return launch_fwd<32>(q, k, v, bias, out, lse, nb, h, n, nw, st);
    case 64: return launch_fwd<64>(q, k, v, bias, out, lse, nb, h, n, nw, st);
    default: return cudaErrorInvalidValue;
  }
}

// The backward's route for n: 1 (small, one launch) for n <= 32, else 2
// (wide: the attention backward and the dbias sum).
int window_attention_bwd_launches(int n) { return n <= kSmallMaxN ? 1 : 2; }

// The dynamic shared memory the backward's kernel takes (bytes) for n, hd
// and nb / nw images a slot; the wrapper refuses what exceeds the card's.
int window_attention_bwd_smem(int n, int hd, int nimg) {
  const int np = n <= 16 ? 16 : 32;
  switch (hd) {
#define PREGEN_SMEM(HD)                                                              \
  case HD:                                                                           \
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

// Gradients of window_attention_fwd from its output o and lse: q, k, v, o,
// do (nb, h, n, hd); lse (nb, h, n); bias (nw, h, n, n) -> dq, dk, dv (nb,
// h, n, hd), dbias (nw, h, n, n) summed over images. ds: the wide route's
// (nb, h, n, n) scratch (null on the small route). `launched` reports the
// kernels enqueued.
int window_attention_bwd(const float* q, const float* k, const float* v, const float* o,
                         const float* dout, const float* lse, const float* bias, float* dq,
                         float* dk, float* dv, float* dbias, float* ds, int nb, int h, int n,
                         int hd, int nw, void* stream, int* launched) {
  *launched = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bwd a{q, k, v, o, dout, lse, bias, dq, dk, dv, dbias, ds, nb, h, n, nw};
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
