// Hand-written Swin-V2 block forward and backward for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernels
//   pregen_pde_tpu/ops/swin_block.py::fused_swin_block (forward,
//   `_fwd_kernel`, pallas_call in `_fused_call`; backward, `_bwd_kernel`,
//   pallas_call in `_fused_bwd_call`)
// One post-norm Swin-V2 layer on a token grid x (B, H, W, C), cyclically
// shifted by s, windows of ws x ws tokens (n = ws^2), h heads of hd:
//   q, k, v = x Wq^T + bq, x Wk^T, x Wv^T + bv      (per token)
//   o       = softmax(scale_h qn.kn^T + bias[w, h]) v, qn = q/(|q| + 1e-6)
//                                                   (per window and head)
//   a       = o Wp^T + bp
//   x2      = x + dp[b, 0] (LN(a) ln1w[b] + ln1b[b])
//   y       = x2 + dp[b, 1] (LN(gelu_tanh(x2 W1^T + b1) W2^T + b2) ln2w[b] + ln2b[b])
// with LN(t) = (t - mean) / sqrt(E[t^2] - mean^2 + eps) and per-sample
// (conditional) affines. The weights are in nn.Linear's (out, in) layout;
// a null bias pointer means no bias. Every array of tokens stays in the
// grid's own order: the shift only moves which tokens a window gathers
// (logical row r is grid row (r + s) mod H), so the rolls of the grid
// before and after the block are never made.
//
// Design. The TPU kernel is one program per (sample, window) holding the
// window, every weight and the MLP intermediate in VMEM; at scOT-B's widths
// that does not fit an SM's 227 KB, and only the attention is per window.
// What bounds the block on the H100 is its products: 24 M C^2 + 4 M n C FLOP
// (5.2 GFLOP at stage 0, batch 16: 78 us on the float32 cores). Here every
// product runs on the tensor cores in 3xTF32 (a = a_hi + a_lo rounded to
// TF32; a_lo b_hi + a_hi b_lo + a_hi b_hi by mma.sync m16n8k8, each k
// step's three products summed apart and added to float32 accumulators:
// against 3 x 5.2 GFLOP at 495 TFLOP/s = 32 us), fed from a three-stage
// cp.async ring in shared memory. The forward is five launches over all
// B H W tokens:
//   1. qkv = x [Wq; Wk; Wv]^T + [bq; 0; bv] (the three weights read in place);
//   2. the attention, one block per (window, head, 128 queries): k
//      normalised into shared memory, q normalised and scaled in registers,
//      the window's mean rows of k^ and v taken out (see the attention's
//      section), S = q k^T and P v by 3xTF32 mma, the bias added and an
//      online softmax in registers; writes o and, when saving, each row's
//      log-sum-exp;
//   3. a = o Wp^T + bp with CondLN1, the per-sample affine and the drop-path
//      residual in the epilogue: a cluster of 1-4 blocks owns 64 whole
//      C-wide rows (C <= 384), each block a k range, the partial tiles
//      summed over distributed shared memory; their mean and E[t^2], x2;
//   4. hpre = x2 W1^T + b1 (the pre-activation; GELU is applied where it is
//      read, so the hidden is written once);
//   5. m = gelu(hpre) W2^T + b2 with CondLN2 and the residual: y.
// When autograd records the call the forward also saves what the backward
// needs: qkv, o, the log-sum-exps, LN1's and LN2's x^ and rstd, x2, hpre.
//
// Backward (`swin_block_bwd`): no recompute, eight launches:
//   1. LN2's backward row pass: dm, and the per-sample affine sums per
//      8-row group (dm is itself an operand of dW2 and db2, so it is
//      written once rather than formed again in each product's prologue);
//   2. dh = (dm W2) gelu'(hpre);
//   3. dx2 = dy + dh W1 with LN1's backward in the epilogue (block-owned
//      rows): dattn and LN1's per-sample sums;
//   4. do = dattn Wp;
//   5. the attention backward on the tensor cores, blocks of two kinds in one
//      launch: per (window, head, 128 queries) P from the saved log-sum-exp,
//      dP = do v^T, ds = P (dP - D), dq = c ds k^ back through the cosine
//      norm, this block's shares of dscale, and ds itself; per (window,
//      head, 128 keys) P^T and ds^T again, dv = P^T do, dk = c ds^T q^ and
//      its cosine norm. dq, dk, dv need no atomics. ds is written (R, h, n, n)
//      because dbias sums it over the windows of each bias slot, which live
//      in different blocks, and a slot's n x n sum does not fit a block;
//   6. dx = dx2 + dqkv [Wq; Wk; Wv];
//   7. the four weight gradients as one grouped launch of TN products over
//      the M tokens in split-K partials, each bias gradient as one more
//      column of ones in the right operand;
//   8. one fixed-order reduction of every partial (Kahan sums): the weight
//      and bias gradients, the LN affine gradients and ddp, dbias, dscale.
// No atomics anywhere, so a rerun repeats to the bit.
// What bounds it now: neither bound (about a tenth of the 3xTF32 bound on
// an H100 at scOT-B's stages); the mma.sync path's fragment loads, the
// splits and float32 additions of each k step, and two blocks an SM. A
// later version can move the products to wgmma with operands split once in
// shared memory.
//
// Kernels launch on the caller's stream, never synchronise and allocate
// nothing; the entry points return cudaGetLastError() after each launch and
// report how many kernels they enqueued (`launched`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- elementwise ------------------------------------------------------------

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// d/dh gelu_tanh(h), the JAX package's `_gelu_tanh_grad`
__device__ __forceinline__ float gelu_tanh_grad(float h) {
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (h + 0.044715f * h * h * h));
  return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * (c * (1.f + 3.f * 0.044715f * h * h));
}

// Dynamic shared memory above 48 KB is opted into once a kernel instance
// (otherwise every launch would pay one more runtime call).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// Token of local index t of window `row` (= b nwin + w) of the logical
// (shifted) grid: logical (r, c) is grid ((r + s) mod H, (c + s) mod W).
struct Geom {
  int H, W, ws, n, h, shift;
};

__device__ __forceinline__ long long window_token(const Geom& g, int row, int t) {
  const int nww = g.W / g.ws, nwin = (g.H / g.ws) * nww;
  const int b = row / nwin, w = row % nwin;
  int r = (w / nww) * g.ws + t / g.ws + g.shift, c = (w % nww) * g.ws + t % g.ws + g.shift;
  if (r >= g.H) r -= g.H;
  if (c >= g.W) c -= g.W;
  return ((long long)b * g.H + r) * g.W + c;
}

// ---- the products ------------------------------------------------------------
//
// C (M x N) = op(A) op(B) over k in a block's range, 8 warps as 2 (rows) x
// 4 (columns), each warp 16 MT x 8 NT outputs: a block tile of BM = 32 MT
// by BN = 32 NT, k in steps of BK = 32 through a three-stage cp.async ring.
// A is (M, K) row-major, or with AT (K, M) (the transposed token operand of
// a weight gradient). B is (N, K) row-major (an nn.Linear weight in a
// forward product), or with BKN (K, N); B's storage rows come from up to
// three arrays of `bseg` rows each (q, k and v's weights read in place).
// Ragged edges are zero-filled; every width is a multiple of 4 and every
// row 16-byte aligned (the wrapper checks).

constexpr int BK = 32, kThreads = 256, kStages = 3;
enum { OP_NONE = 0, OP_GELU = 1 };
enum { EPI_STORE, EPI_LNF, EPI_LNB };
enum { AUX_NONE, AUX_ADD, AUX_GELU_GRAD };

struct Gemm {
  const float* A;
  int lda;
  const float* B[3];
  int bseg, ldb;
  int nb;        // BKN: real columns of B; column nb reads 1 when ones (weight gradients)
  int ones;
  int M, N, K, kchunk;
  int aop, bop;  // OP_GELU: gelu applied to the operand as it lands in shared memory
  // EPI_STORE: out[m ldo + n] = (acc + bias[n]) gelu'(aux) or + aux, by auxop
  float* out;
  int ldo;
  const float* bias[3];
  int biseg;
  const float* aux;
  int auxop;
  // EPI_LNF / EPI_LNB (a block owns whole rows of N = C): per-sample affine
  // lnw, lnb (B, C) and dp (B, 2) column `which`, tps tokens a sample.
  // LNF: out = res + d (LN(acc + bias) lnw + lnb); x^ and rstd into xhat,
  // rstd when not null. LNB: t = acc + aux is the upstream gradient (written
  // to out2 when not null); out = rstd (g - mean g - x^ mean(g x^)) with
  // g = d t lnw, x^ and rstd the saved xhat_in, rstd_in; part gets the
  // per-8-row sums (t x^, t).
  const float* res;
  const float *lnw, *lnb, *dp;
  int which, tps;
  float eps;
  float *xhat, *rstd, *out2, *part;
  const float *xhat_in, *rstd_in;
};

__device__ __forceinline__ const float* brow(const Gemm& p, int r) {
  const int s = r / p.bseg;
  return p.B[s] + (long long)(r - s * p.bseg) * p.ldb;
}

template <int MT, int NT, bool AT, bool BKN>
struct Tile {
  static constexpr int BM = 32 * MT, BN = 32 * NT;
  static constexpr int ASTR = AT ? BM + 8 : BK + 4;  // conflict-free fragment reads
  static constexpr int BSTR = BKN ? BN + 8 : BK + 4;
  static constexpr int AFL = AT ? BK * ASTR : BM * ASTR;
  static constexpr int BFL = BKN ? BK * BSTR : BN * BSTR;
  static constexpr int STAGE = AFL + BFL;
  static constexpr int ACH = BM * BK / 4, BCH = BN * BK / 4;  // 16-byte chunks a stage

  __device__ static float a(const float* As, int r, int k) {
    return AT ? As[k * ASTR + r] : As[r * ASTR + k];
  }
  __device__ static float b(const float* Bs, int k, int c) {
    return BKN ? Bs[k * BSTR + c] : Bs[c * BSTR + k];
  }
  // chunk e of the A (B) tile: its place in shared memory and its (row, k) in
  // the product's terms
  __device__ static void a_chunk(int e, int& soff, int& r, int& k) {
    if (AT) {
      k = e / (BM / 4), r = 4 * (e % (BM / 4)), soff = k * ASTR + r;
    } else {
      r = e / (BK / 4), k = 4 * (e % (BK / 4)), soff = r * ASTR + k;
    }
  }
  __device__ static void b_chunk(int e, int& soff, int& c, int& k) {
    if (BKN) {
      k = e / (BN / 4), c = 4 * (e % (BN / 4)), soff = k * BSTR + c;
    } else {
      c = e / (BK / 4), k = 4 * (e % (BK / 4)), soff = c * BSTR + k;
    }
  }

  __device__ static void load(const Gemm& p, float* st, int m0, int n0, int k0, int kend) {
    float* As = st;
    float* Bs = st + AFL;
    for (int e = threadIdx.x; e < ACH; e += kThreads) {
      int so, r, k;
      a_chunk(e, so, r, k);
      const int gm = m0 + r, gk = k0 + k;
      const bool ok = gm < p.M && gk < kend;
      const long long at = AT ? (long long)gk * p.lda + gm : (long long)gm * p.lda + gk;
      const float* src = ok ? p.A + at : p.A;
      cp_async16(As + so, src, ok);
    }
    for (int e = threadIdx.x; e < BCH; e += kThreads) {
      int so, c, k;
      b_chunk(e, so, c, k);
      const int gn = n0 + c, gk = k0 + k;
      bool ok;
      const float* src = p.B[0];
      if (BKN) {
        ok = gk < kend && gn < p.nb;
        if (ok) src = brow(p, gk) + gn;
      } else {
        ok = gn < p.N && gk < kend;
        if (ok) src = brow(p, gn) + gk;
      }
      cp_async16(Bs + so, src, ok);
    }
  }

  // after the stage landed: each thread transforms the chunks it copied
  __device__ static void fix(const Gemm& p, float* st, int n0, int k0, int kend) {
    if (p.aop == OP_GELU) {
      for (int e = threadIdx.x; e < ACH; e += kThreads) {
        int so, r, k;
        a_chunk(e, so, r, k);
        float4* v = reinterpret_cast<float4*>(st + so);
        float4 x = *v;
        *v = make_float4(gelu_tanh(x.x), gelu_tanh(x.y), gelu_tanh(x.z), gelu_tanh(x.w));
      }
    }
    if (p.bop == OP_GELU || p.ones) {
      float* Bs = st + AFL;
      for (int e = threadIdx.x; e < BCH; e += kThreads) {
        int so, c, k;
        b_chunk(e, so, c, k);
        float* v = Bs + so;
        if (p.bop == OP_GELU)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = gelu_tanh(v[i]);
        if (BKN && p.ones && n0 + c == p.nb) v[0] = (k0 + k < kend) ? 1.f : 0.f;
      }
    }
  }

  // acc += this stage's products, warp (wm, wn)
  __device__ static void compute(const float* st, int wm, int wn, float (&acc)[MT][NT][4]) {
    const float* As = st;
    const float* Bs = st + AFL;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      FragA fa[MT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int r = wm * 16 * MT + mi * 16 + g;
        frag_a(fa[mi], a(As, r, kk + t), a(As, r + 8, kk + t), a(As, r, kk + t + 4),
               a(As, r + 8, kk + t + 4));
      }
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const int c = wn * 8 * NT + nj * 8 + g;
        uint32_t h0, l0, h1, l1;
        split_tf32(b(Bs, kk + t, c), h0, l0);
        split_tf32(b(Bs, kk + t + 4, c), h1, l1);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma3s(acc[mi][nj], fa[mi], h0, h1, l0, l1);
      }
    }
  }

  // the block's product over k in [kbeg, kend)
  __device__ static void run(const Gemm& p, float* smem, int m0, int n0, int kbeg, int kend,
                             float (&acc)[MT][NT][4]) {
    const int warp = threadIdx.x >> 5, wm = warp / 4, wn = warp % 4;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;
    const int kt_n = (kend - kbeg + BK - 1) / BK;
    load(p, smem, m0, n0, kbeg, kend);
    cp_async_commit();
    if (kt_n > 1) load(p, smem + STAGE, m0, n0, kbeg + BK, kend);
    cp_async_commit();
    for (int kt = 0; kt < kt_n; ++kt) {
      float* st = smem + (kt % kStages) * STAGE;
      cp_async_wait<1>();
      fix(p, st, n0, kbeg + kt * BK, kend);
      __syncthreads();
      if (kt + 2 < kt_n)
        load(p, smem + ((kt + 2) % kStages) * STAGE, m0, n0, kbeg + (kt + 2) * BK, kend);
      cp_async_commit();
      compute(st, wm, wn, acc);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring may be reused by the epilogue
  }

  // visit (row, col, value) of every accumulator
  template <typename F>
  __device__ static void each(const float (&acc)[MT][NT][4], F f) {
    const int warp = threadIdx.x >> 5, wm = warp / 4, wn = warp % 4;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          f(wm * 16 * MT + mi * 16 + g + (i >> 1) * 8, wn * 8 * NT + nj * 8 + 2 * t + (i & 1),
            acc[mi][nj][i]);
  }
};

__device__ __forceinline__ float bias_at(const Gemm& p, int n) {
  const int s = n / p.biseg;
  const float* b = p.bias[s];
  return b ? b[n - s * p.biseg] : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s += v with the rounding error carried (Kahan): the long fixed-order sums
// of partials keep float32's accuracy of a pairwise sum
struct KahanSum {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c, t = s + y;
    c = (t - s) - y;
    s = t;
  }
};

// The LayerNorm epilogues over BM whole rows held in T (stride TS; the
// upstream gradient for LNB), a warp a row (its lanes along the row); U is
// LNB's scratch of the same shape.
constexpr int kGroupRows = 8;  // rows of a per-sample partial sum (a sample holds whole groups)

__device__ void ln_rows_fwd(const Gemm& p, const float* T, int TS, int m0, int r0, int r1) {
  const int N = p.N, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = r0 + warp; r < r1 && m0 + r < p.M; r += kThreads / 32) {
    const int row = m0 + r, b = row / p.tps;
    const float* tr = T + r * TS;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < N; c += 32) s += tr[c], s2 += tr[c] * tr[c];
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = s / N, rstd = 1.f / sqrtf(s2 / N - mean * mean + p.eps);
    if (lane == 0 && p.rstd) p.rstd[row] = rstd;
    const float d = p.dp[2 * b + p.which];
    const float *w = p.lnw + (long long)b * N, *bb = p.lnb + (long long)b * N;
    const long long o = (long long)row * N;
    for (int c = lane; c < N; c += 32) {
      const float xh = (tr[c] - mean) * rstd;
      p.out[o + c] = p.res[o + c] + d * (xh * w[c] + bb[c]);
      if (p.xhat) p.xhat[o + c] = xh;
    }
  }
}

__device__ void ln_rows_bwd(const Gemm& p, const float* T, float* U, int TS, int m0, int r0,
                            int r1) {
  const int N = p.N, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = r0 + warp; r < r1 && m0 + r < p.M; r += kThreads / 32) {
    const int row = m0 + r, b = row / p.tps;
    const float* tr = T + r * TS;
    const float d = p.dp[2 * b + p.which];
    const float* w = p.lnw + (long long)b * N;
    const long long o = (long long)row * N;
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float gv = d * tr[c] * w[c];
      m1 += gv;
      m2 += gv * p.xhat_in[o + c];
    }
    m1 = warp_sum(m1) / N;
    m2 = warp_sum(m2) / N;
    const float rs = p.rstd_in[row];
    for (int c = lane; c < N; c += 32) {
      const float tv = tr[c], xh = p.xhat_in[o + c];
      p.out[o + c] = rs * (d * tv * w[c] - m1 - xh * m2);
      if (p.out2) p.out2[o + c] = tv;
      U[r * TS + c] = tv * xh;
    }
  }
  __syncthreads();
  // per group of kGroupRows rows: (sum t x^, sum t)
  for (int task = threadIdx.x; task < (r1 - r0) / kGroupRows * N; task += kThreads) {
    const int grp = task / N, c = task - grp * N, rg = r0 + grp * kGroupRows;
    if (m0 + rg >= p.M) break;
    float s1 = 0.f, s0 = 0.f;
#pragma unroll
    for (int r = rg; r < rg + kGroupRows; ++r) {
      s1 += U[r * TS + c];
      s0 += T[r * TS + c];
    }
    float* dst = p.part + (long long)((m0 + rg) / kGroupRows) * 2 * N;
    dst[c] = s1;
    dst[N + c] = s0;
  }
}

template <int MT, int NT, bool AT, bool BKN, int EPI>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(const Gemm p) {
  using TL = Tile<MT, NT, AT, BKN>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // EPI_STORE: block (x, y) the output tile (x, y); the row-owning
  // epilogues: block x of a cluster the k range x
  constexpr bool rows = EPI != EPI_STORE;
  const int m0 = blockIdx.y * TL::BM, n0 = rows ? 0 : blockIdx.x * TL::BN;
  const int kbeg = rows ? blockIdx.x * p.kchunk : 0, kend = min(p.K, kbeg + p.kchunk);
  float acc[MT][NT][4];
  TL::run(p, smem, m0, n0, kbeg, kend, acc);
  const int warp = threadIdx.x >> 5, wm = warp / 4, wn = warp % 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (EPI == EPI_STORE) {
#pragma unroll
    for (int nj = 0; nj < NT; ++nj) {
      const int gn = n0 + wn * 8 * NT + nj * 8 + 2 * t;
      if (gn >= p.N) continue;
      const float b0 = bias_at(p, gn), b1 = bias_at(p, gn + 1);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + wm * 16 * MT + mi * 16 + g + 8 * h;
          if (gm >= p.M) continue;
          const long long o = (long long)gm * p.ldo + gn;
          float2 v = make_float2(acc[mi][nj][2 * h] + b0, acc[mi][nj][2 * h + 1] + b1);
          if (p.auxop != AUX_NONE) {
            const float2 a = *reinterpret_cast<const float2*>(p.aux + o);
            if (p.auxop == AUX_GELU_GRAD) v.x *= gelu_tanh_grad(a.x), v.y *= gelu_tanh_grad(a.y);
            else v.x += a.x, v.y += a.y;
          }
          *reinterpret_cast<float2*>(p.out + o) = v;
        }
    }
  } else {
    // A cluster of S = gridDim.x blocks owns BM whole rows (N <= BN), each
    // block a k range: the partial tiles are summed over the cluster in rank
    // order through distributed shared memory, rank r taking BM / S rows,
    // then the LayerNorm epilogue on those rows.
    constexpr int TS = TL::BN + 4;
    float* T = smem;
    float* U = smem + TL::BM * TS;
#pragma unroll
    for (int nj = 0; nj < NT; ++nj) {
      const int c = wn * 8 * NT + nj * 8 + 2 * t;
      if (c >= p.N) continue;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 16 * MT + mi * 16 + g + 8 * h;
          T[r * TS + c] = acc[mi][nj][2 * h], T[r * TS + c + 1] = acc[mi][nj][2 * h + 1];
        }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int S = gridDim.x, rows = TL::BM / S, r0 = blockIdx.x * rows;
    const float* bias = EPI == EPI_LNF ? p.bias[0] : nullptr;
    for (int r = r0 + warp; r < r0 + rows && m0 + r < p.M; r += kThreads / 32)
      for (int c = lane; c < p.N; c += 32) {
        float v = 0.f;
        for (int q = 0; q < S; ++q) v += cluster.map_shared_rank(T, q)[r * TS + c];
        if (bias) v += bias[c];
        if (EPI == EPI_LNB) v += p.aux[(long long)(m0 + r) * p.N + c];
        U[r * TS + c] = v;
      }
    cluster.sync();  // the peers' reads of T are done
    if (EPI == EPI_LNF) ln_rows_fwd(p, U, TS, m0, r0, r0 + rows);
    else ln_rows_bwd(p, U, T, TS, m0, r0, r0 + rows);
  }
}

// LN2's backward row pass: LNB over 32 rows with the upstream gradient dy
// read from p.aux (no product).
__global__ void __launch_bounds__(kThreads) ln_bwd_rows_kernel(const Gemm p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int TS = p.N + 4, m0 = blockIdx.x * 32;
  float* T = smem;
  float* U = smem + 32 * TS;
  for (int r = threadIdx.x >> 5; r < 32 && m0 + r < p.M; r += kThreads / 32)
    for (int c = threadIdx.x & 31; c < p.N; c += 32)
      T[r * TS + c] = p.aux[(long long)(m0 + r) * p.N + c];
  __syncthreads();
  ln_rows_bwd(p, T, U, TS, m0, 0, 32);
}

// The weight gradients: up to four TN products in one launch, blocks
// numbered problem by problem (tiles x splits each).
struct Gemm4 {
  Gemm g[4];
  int blocks[4];  // prefix ends
  int count;
};

constexpr int WG_MT = 4, WG_NT = 4;  // the weight gradients' 128 x 128 tiles

__global__ void __launch_bounds__(kThreads) wgrad_kernel(const Gemm4 q) {
  using TL = Tile<WG_MT, WG_NT, true, true>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int pi = 0;
  while (pi + 1 < q.count && (int)blockIdx.x >= q.blocks[pi]) ++pi;
  const Gemm& p = q.g[pi];
  const int local = blockIdx.x - (pi ? q.blocks[pi - 1] : 0);
  const int tn = (p.N + TL::BN - 1) / TL::BN, tm = (p.M + TL::BM - 1) / TL::BM;
  const int z = local / (tm * tn), rest = local - z * tm * tn;
  const int m0 = (rest / tn) * TL::BM, n0 = (rest % tn) * TL::BN;
  const int kbeg = z * p.kchunk, kend = min(p.K, kbeg + p.kchunk);
  float acc[WG_MT][WG_NT][4];
  TL::run(p, smem, m0, n0, kbeg, kend, acc);
  float* out = p.out + (long long)z * p.M * p.N;
  TL::each(acc, [&](int r, int c, float v) {
    const int gm = m0 + r, gn = n0 + c;
    if (gm < p.M && gn < p.N) out[(long long)gm * p.N + gn] = v;
  });
}

// ---- the attention -------------------------------------------------------------
//
// Per (window, head): 16 rows a warp, up to 8 warps a block (two blocks an
// SM); keys (and, in the backward, queries) in chunks of 32, the window's
// rows padded with zeros to a multiple of 32 and the padding masked. The
// window's token indices are computed once into shared memory. Rows of k
// (k^ normalised), v, q^ and do sit in shared memory with a row stride of
// HD + 4 (conflict-free B fragments read along HD), v in the forward
// HD + 8 mod 32 in {8, 24} (read along keys). Each warp keeps its 16 x 32
// tile of P (or ds) in shared memory to turn the accumulator layout into
// the A layout. A chunk's products go into fresh accumulators (S, dP) or a
// zeroed chunk sum added to the running one in float32 (o, dq, dk, dv).
//
// The products take the window's mean rows k^bar of k^ and vbar of v out
// first. Where a window's tokens are alike (a uniform stretch of flow) k^
// and v are their mean plus a little, and the backward's sums cancel:
// dP - D, the rows of ds (which sum to nought) against k^, and dscale. A
// 3xTF32 operand keeps about 21 bits of its value, so on the mean's scale
// those sums came out 10-25x plain float32's error (dq, dk, dscale on
// scOT-B's training step). Taken out, the products see only the part that
// differs: the forward's logits are c q^.(k^ - k^bar), a shift by the row
// constant c q^.k^bar that the softmax does not see (the saved
// log-sum-exps are of these logits), and o = vbar + P (v - vbar). The
// backward takes dP - D = do.(v - vbar) - do.(o - vbar), dq = c ds
// (k^ - k^bar) and dscale = ds q^.(k^ - k^bar), each equal to the
// uncentred form because a row of ds sums to nought. The means are summed
// in a fixed order from the same rows in every block of a window.

constexpr int kAttnWarps = 8;

// the window's token indices into tok[0, n)
__device__ void window_tokens(int* tok, const Geom& g, int row) {
  for (int j = threadIdx.x; j < g.n; j += blockDim.x) tok[j] = (int)window_token(g, row, j);
}

// rows [0, np) of a head's HD columns at src + token * ld into shared
// memory (stride `str`), zero past n
template <int HD>
__device__ void load_rows(float* dst, int str, const float* src, long long ld, int np, int n,
                          const int* tok) {
  for (int e = threadIdx.x; e < np * (HD / 4); e += blockDim.x) {
    const int j = e / (HD / 4), d = 4 * (e % (HD / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < n) v = __ldg(reinterpret_cast<const float4*>(src + tok[j] * ld + d));
    float* o = dst + j * str + d;
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
}

// mean[d]: the mean over rows < n of column d of the shared array a, in a
// fixed order (each of P = blockDim / HD threads of a column sums every
// P-th row, then the P partial sums in order); red holds blockDim floats.
// Ends with the block synchronised.
template <int HD>
__device__ void window_mean(const float* a, int str, int n, float* red, float* mean) {
  const int P = (int)blockDim.x >= HD ? (int)blockDim.x / HD : 1;
  for (int e = threadIdx.x; e < P * HD; e += blockDim.x) {
    const int d = e % HD, part = e / HD;
    float s = 0.f;
    for (int j = part; j < n; j += P) s += a[j * str + d];
    red[e] = s;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float s = 0.f;
    for (int part = 0; part < P; ++part) s += red[part * HD + d];
    mean[d] = s / n;
  }
  __syncthreads();
}

// a -= mean in each row < n of the shared array
template <int HD>
__device__ void subtract_rows(float* a, int str, int n, const float* mean) {
  for (int e = threadIdx.x; e < n * HD; e += blockDim.x) a[(e / HD) * str + e % HD] -= mean[e % HD];
}

// x / (|x| + 1e-6) for each row < n of the shared array
template <int HD>
__device__ void normalise_rows(float* a, int str, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float ss = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) ss += a[j * str + d] * a[j * str + d];
    const float inv = 1.f / (sqrtf(ss) + 1e-6f);
#pragma unroll
    for (int d = 0; d < HD; ++d) a[j * str + d] *= inv;
  }
}

// The A-layout values of a warp's 16 rows (tokens tok0, tok1 = rows g, g+8)
// of a head's HD columns at src + tok * ld; returns the rows' |x|^2 (summed
// over the quad)
template <int HD>
__device__ __forceinline__ void load_frag_rows(float (&v)[HD / 8][4], const float* src,
                                               long long ld, long long tok0, long long tok1,
                                               float& ss0, float& ss1) {
  const int t = threadIdx.x & 3;
  ss0 = ss1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    v[kk][0] = __ldg(src + tok0 * ld + 8 * kk + t);
    v[kk][1] = __ldg(src + tok1 * ld + 8 * kk + t);
    v[kk][2] = __ldg(src + tok0 * ld + 8 * kk + t + 4);
    v[kk][3] = __ldg(src + tok1 * ld + 8 * kk + t + 4);
    ss0 += v[kk][0] * v[kk][0] + v[kk][2] * v[kk][2];
    ss1 += v[kk][1] * v[kk][1] + v[kk][3] * v[kk][3];
  }
  ss0 = quad_sum(ss0);
  ss1 = quad_sum(ss1);
}

// o = softmax(c q^ k^T + bias) v for 16 query rows a warp; qkv (M, 3C) with
// the head's q, k, v at columns head HD, C + head HD, 2C + head HD; o (M, C);
// lse (R, h, n) when not null, of the logits less c q^.k^bar.
template <int HD>
__global__ void __launch_bounds__(32 * kAttnWarps, 2) attn_fwd_kernel(
    const float* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ scale,
    float* __restrict__ o, float* __restrict__ lse, int C, int nw, Geom g) {
  using AT = Attn<HD>;
  extern __shared__ float4 smem4[];
  const int n = g.n, np = (n + KC - 1) / KC * KC;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + np * AT::KSTR;
  int* tok = reinterpret_cast<int*>(Vs + np * AT::VSTR);
  const int row = blockIdx.x, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  float* Pw = reinterpret_cast<float*>(tok + np) + warp * 16 * AT::PSTR;
  float* kbar = reinterpret_cast<float*>(tok + np) + (blockDim.x >> 5) * 16 * AT::PSTR;
  float* vbar = kbar + HD;
  float* red = vbar + HD;
  const long long ld = 3LL * C;
  window_tokens(tok, g, row);
  __syncthreads();
  load_rows<HD>(Ks, AT::KSTR, qkv + C + head * HD, ld, np, n, tok);
  load_rows<HD>(Vs, AT::VSTR, qkv + 2 * C + head * HD, ld, np, n, tok);
  __syncthreads();
  normalise_rows<HD>(Ks, AT::KSTR, n);
  __syncthreads();
  window_mean<HD>(Ks, AT::KSTR, n, red, kbar);
  window_mean<HD>(Vs, AT::VSTR, n, red, vbar);
  subtract_rows<HD>(Ks, AT::KSTR, n, kbar);
  subtract_rows<HD>(Vs, AT::VSTR, n, vbar);
  __syncthreads();
  const int i0 = (blockIdx.z * (blockDim.x >> 5) + warp) * 16;
  if (i0 >= n) return;
  const long long tok0 = tok[i0 + gq], tok1 = tok[i0 + gq + 8];
  float qv[HD / 8][4], ss0, ss1;
  load_frag_rows<HD>(qv, qkv + head * HD, ld, tok0, tok1, ss0, ss1);
  // the logit scale folded into q^
  const float c = scale[head];
  const float f0 = c / (sqrtf(ss0) + 1e-6f), f1 = c / (sqrtf(ss1) + 1e-6f);
  const float* b0row = bias + ((long long)((row % nw) * g.h + head) * n + i0 + gq) * n;
  const float* b1row = b0row + 8LL * n;
  float oacc[HD / 8][4] = {};
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int jc = 0; jc < np; jc += KC) {
    float s[KC / 8][4];
    rows_times_t<HD, true>(s, qv, f0, f1, Ks, jc);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      const int col = jc + 8 * j + 2 * t;
      if (col < n) {
        const float2 ba = __ldg(reinterpret_cast<const float2*>(b0row + col));
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b1row + col));
        s[j][0] += ba.x, s[j][1] += ba.y, s[j][2] += bb.x, s[j][3] += bb.y;
      } else {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0, m1 = mn1;
    l0 *= c0, l1 *= c1;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      oacc[d][0] *= c0, oacc[d][1] *= c0, oacc[d][2] *= c1, oacc[d][3] *= c1;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      s[j][0] = expf(s[j][0] - m0), s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1), s[j][3] = expf(s[j][3] - m1);
      l0 += s[j][0] + s[j][1], l1 += s[j][2] + s[j][3];
    }
    tile_to_smem(Pw, s);
    __syncwarp();
    tile_times<HD>(oacc, Pw, Vs, AT::VSTR, jc);
    __syncwarp();
  }
  l0 = quad_sum(l0), l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = head * HD + 8 * d + 2 * t;
    const float v0 = vbar[8 * d + 2 * t], v1 = vbar[8 * d + 2 * t + 1];
    *reinterpret_cast<float2*>(o + tok0 * C + col) =
        make_float2(v0 + oacc[d][0] * inv0, v1 + oacc[d][1] * inv0);
    *reinterpret_cast<float2*>(o + tok1 * C + col) =
        make_float2(v0 + oacc[d][2] * inv1, v1 + oacc[d][3] * inv1);
  }
  if (lse && t == 0) {
    float* lr = lse + ((long long)row * g.h + head) * n + i0 + gq;
    lr[0] = m0 + logf(l0);
    lr[8] = m1 + logf(l1);
  }
}

// d/dx of x / (|x| + 1e-6) applied to dy (rows g, g+8 in the accumulator
// layout, raw x at src + tok * ld + column), the JAX kernel's
// dy/(|x|+e) - x (x.dy)/(max(|x|, 1e-30) (|x|+e)^2); written to dst.
template <int HD>
__device__ __forceinline__ void cosine_norm_bwd_store(const float (&dy)[HD / 8][4],
                                                      const float* src, float* dst, long long ld,
                                                      long long tok0, long long tok1, float nrm0,
                                                      float nrm1) {
  const int t = threadIdx.x & 3;
  float x[HD / 8][4];
  float xd0 = 0.f, xd1 = 0.f;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(src + tok0 * ld + 8 * d + 2 * t));
    const float2 b = __ldg(reinterpret_cast<const float2*>(src + tok1 * ld + 8 * d + 2 * t));
    x[d][0] = a.x, x[d][1] = a.y, x[d][2] = b.x, x[d][3] = b.y;
    xd0 += dy[d][0] * a.x + dy[d][1] * a.y;
    xd1 += dy[d][2] * b.x + dy[d][3] * b.y;
  }
  xd0 = quad_sum(xd0), xd1 = quad_sum(xd1);
  const float e0 = nrm0 + 1e-6f, e1 = nrm1 + 1e-6f;
  const float a0 = 1.f / e0, c0 = xd0 / (fmaxf(nrm0, 1e-30f) * e0 * e0);
  const float a1 = 1.f / e1, c1 = xd1 / (fmaxf(nrm1, 1e-30f) * e1 * e1);
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    *reinterpret_cast<float2*>(dst + tok0 * ld + 8 * d + 2 * t) =
        make_float2(dy[d][0] * a0 - x[d][0] * c0, dy[d][1] * a0 - x[d][1] * c0);
    *reinterpret_cast<float2*>(dst + tok1 * ld + 8 * d + 2 * t) =
        make_float2(dy[d][2] * a1 - x[d][2] * c1, dy[d][3] * a1 - x[d][3] * c1);
  }
}

// The attention backward, the window's mean rows taken out as in the
// forward. Blocks z < nqc take 16 queries a warp: with
// P = exp(c q^ k^T + bias - lse), dP = do v^T, D = do.o and ds = P (dP - D),
// dq = c ds k^ through the cosine norm, ds into dsbuf (R, h, n, n) and each
// warp's share of dscale = sum ds (q^.k^) into dsc (R, h, nqc, kAttnWarps).
// Blocks z >= nqc take 16 keys a warp: dv = P^T do, dk = c ds^T q^ through
// the cosine norm. dqkv (M, 3C) as qkv. dP and the products into dq and dk
// add each k step in float32 (EXACT).
template <int HD>
__global__ void __launch_bounds__(32 * kAttnWarps, 2) attn_bwd_kernel(
    const float* __restrict__ qkv, const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ bias, const float* __restrict__ scale,
    float* __restrict__ dqkv, float* __restrict__ dsbuf, float* __restrict__ dsc, int C, int nw,
    int nqc, Geom g) {
  using AT = Attn<HD>;
  extern __shared__ float4 smem4[];
  const int n = g.n, np = (n + KC - 1) / KC * KC;
  const int row = blockIdx.x, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;
  const long long ld = 3LL * C;
  const float c = scale[head];
  const long long bh = (long long)row * g.h + head;
  const float* bmat = bias + (long long)((row % nw) * g.h + head) * n * n;
  float* S1 = reinterpret_cast<float*>(smem4);
  float* S2 = S1 + np * AT::KSTR;
  float* Dl = S2 + np * AT::KSTR;
  float* Ll = Dl + np;
  int* tok = reinterpret_cast<int*>(Ll + np);
  float* Pw = reinterpret_cast<float*>(tok + np) + warp * 16 * AT::PSTR;
  float* kbar = reinterpret_cast<float*>(tok + np) + warps * 16 * AT::PSTR;
  float* vbar = kbar + HD;
  float* red = vbar + HD;
  window_tokens(tok, g, row);
  __syncthreads();
  if ((int)blockIdx.z < nqc) {
    // ---- queries: S1 = k^ - k^bar, S2 = v - vbar
    load_rows<HD>(S1, AT::KSTR, qkv + C + head * HD, ld, np, n, tok);
    load_rows<HD>(S2, AT::KSTR, qkv + 2 * C + head * HD, ld, np, n, tok);
    __syncthreads();
    normalise_rows<HD>(S1, AT::KSTR, n);
    __syncthreads();
    window_mean<HD>(S1, AT::KSTR, n, red, kbar);
    window_mean<HD>(S2, AT::KSTR, n, red, vbar);
    subtract_rows<HD>(S1, AT::KSTR, n, kbar);
    subtract_rows<HD>(S2, AT::KSTR, n, vbar);
    __syncthreads();
    const int i0 = (blockIdx.z * warps + warp) * 16;
    float* dscw = dsc + (bh * nqc + blockIdx.z) * kAttnWarps;
    if (warp == 0 && lane >= warps && lane < kAttnWarps) dscw[lane] = 0.f;
    if (i0 >= n) {
      if (lane == 0) dscw[warp] = 0.f;
      return;
    }
    const long long tok0 = tok[i0 + gq], tok1 = tok[i0 + gq + 8];
    float qv[HD / 8][4], dov[HD / 8][4], ss0, ss1;
    load_frag_rows<HD>(qv, qkv + head * HD, ld, tok0, tok1, ss0, ss1);
    const float nrm0 = sqrtf(ss0), nrm1 = sqrtf(ss1);
    // the logit scale folded into q^ as the forward folds it
    const float f0 = c / (nrm0 + 1e-6f), f1 = c / (nrm1 + 1e-6f);
    load_frag_rows<HD>(dov, dout + head * HD, C, tok0, tok1, ss0, ss1);
    float D0 = 0.f, D1 = 0.f;  // do.(o - vbar)
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float* o0 = o + tok0 * C + head * HD + 8 * kk + t;
      const float* o1 = o + tok1 * C + head * HD + 8 * kk + t;
      const float va = vbar[8 * kk + t], vb = vbar[8 * kk + t + 4];
      D0 += dov[kk][0] * (__ldg(o0) - va) + dov[kk][2] * (__ldg(o0 + 4) - vb);
      D1 += dov[kk][1] * (__ldg(o1) - va) + dov[kk][3] * (__ldg(o1 + 4) - vb);
    }
    D0 = quad_sum(D0), D1 = quad_sum(D1);
    const float lse0 = lse[bh * n + i0 + gq], lse1 = lse[bh * n + i0 + gq + 8];
    const float* b0row = bmat + (long long)(i0 + gq) * n;
    const float* b1row = b0row + 8LL * n;
    float* ds0 = dsbuf + (bh * n + i0 + gq) * n;
    float* ds1 = ds0 + 8LL * n;
    float dq[HD / 8][4] = {};
    KahanSum part;  // this thread's share of dscale
    for (int jc = 0; jc < np; jc += KC) {
      float s[KC / 8][4], dp[KC / 8][4];
      rows_times_t<HD, true>(s, qv, f0, f1, S1, jc);
      rows_times_t<HD, true>(dp, dov, 1.f, 1.f, S2, jc);
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        const int col = jc + 8 * j + 2 * t;
        if (col < n) {
          const float2 ba = __ldg(reinterpret_cast<const float2*>(b0row + col));
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b1row + col));
          const float bv[4] = {ba.x, ba.y, bb.x, bb.y};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = expf(s[j][i] + bv[i] - (i < 2 ? lse0 : lse1));
            const float ds = p * (dp[j][i] - (i < 2 ? D0 : D1));
            part.add(ds * s[j][i]);  // c times this thread's share
            dp[j][i] = ds;
          }
          *reinterpret_cast<float2*>(ds0 + col) = make_float2(dp[j][0], dp[j][1]);
          *reinterpret_cast<float2*>(ds1 + col) = make_float2(dp[j][2], dp[j][3]);
        } else {
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        }
      }
      tile_to_smem(Pw, dp);
      __syncwarp();
      tile_times<HD, true>(dq, Pw, S1, AT::KSTR, jc);
      __syncwarp();
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[d][i] *= c;
    cosine_norm_bwd_store<HD>(dq, qkv + head * HD, dqkv + head * HD, ld, tok0, tok1, nrm0, nrm1);
    const float share = warp_sum(part.s) / c;
    if (lane == 0) dscw[warp] = share;
    return;
  }
  // ---- keys: k^bar and vbar from the rows the query blocks take them
  // from, then S1 = q^, S2 = do, and D = do.(o - vbar) and lse per query row
  load_rows<HD>(S1, AT::KSTR, qkv + C + head * HD, ld, np, n, tok);
  __syncthreads();
  normalise_rows<HD>(S1, AT::KSTR, n);
  __syncthreads();
  window_mean<HD>(S1, AT::KSTR, n, red, kbar);
  load_rows<HD>(S1, AT::KSTR, qkv + 2 * C + head * HD, ld, np, n, tok);
  __syncthreads();
  window_mean<HD>(S1, AT::KSTR, n, red, vbar);
  load_rows<HD>(S1, AT::KSTR, qkv + head * HD, ld, np, n, tok);
  load_rows<HD>(S2, AT::KSTR, dout + head * HD, C, np, n, tok);
  __syncthreads();
  normalise_rows<HD>(S1, AT::KSTR, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* orow = o + (long long)tok[i] * C + head * HD;
    float D = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) D += S2[i * AT::KSTR + d] * (__ldg(orow + d) - vbar[d]);
    Dl[i] = D;
    Ll[i] = lse[bh * n + i];
  }
  __syncthreads();
  const int j0 = ((blockIdx.z - nqc) * warps + warp) * 16;
  if (j0 >= n) return;
  const long long tok0 = tok[j0 + gq], tok1 = tok[j0 + gq + 8];
  float kv[HD / 8][4], vv[HD / 8][4], ss0, ss1;
  load_frag_rows<HD>(kv, qkv + C + head * HD, ld, tok0, tok1, ss0, ss1);
  const float nrm0 = sqrtf(ss0), nrm1 = sqrtf(ss1);
  const float f0 = 1.f / (nrm0 + 1e-6f), f1 = 1.f / (nrm1 + 1e-6f);
  load_frag_rows<HD>(vv, qkv + 2 * C + head * HD, ld, tok0, tok1, ss0, ss1);
  // the warp's keys as k^ - k^bar and v - vbar
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float ka = kbar[8 * kk + t], kb = kbar[8 * kk + t + 4];
    const float va = vbar[8 * kk + t], vb = vbar[8 * kk + t + 4];
    kv[kk][0] = kv[kk][0] * f0 - ka, kv[kk][1] = kv[kk][1] * f1 - ka;
    kv[kk][2] = kv[kk][2] * f0 - kb, kv[kk][3] = kv[kk][3] * f1 - kb;
    vv[kk][0] -= va, vv[kk][1] -= va, vv[kk][2] -= vb, vv[kk][3] -= vb;
  }
  float dv[HD / 8][4] = {}, dk[HD / 8][4] = {};
  const float* bc0 = bmat + j0 + gq;  // bias[i][j] at bc0 + i n (rows j, j + 8)
  for (int ic = 0; ic < np; ic += KC) {
    float s[KC / 8][4], dp[KC / 8][4];
    rows_times_t<HD, true>(s, kv, 1.f, 1.f, S1, ic);
    rows_times_t<HD, true>(dp, vv, 1.f, 1.f, S2, ic);
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = ic + 8 * j + 2 * t + (i & 1);
        float p = 0.f, ds = 0.f;
        if (qi < n) {
          const float b = __ldg(bc0 + (long long)qi * n + (i >> 1) * 8);
          p = expf(c * s[j][i] + b - Ll[qi]);
          ds = p * (dp[j][i] - Dl[qi]);
        }
        s[j][i] = p, dp[j][i] = ds;
      }
    // dv += P^T do, then dk += ds^T q^
    tile_to_smem(Pw, s);
    __syncwarp();
    tile_times<HD>(dv, Pw, S2, AT::KSTR, ic);
    __syncwarp();
    tile_to_smem(Pw, dp);
    __syncwarp();
    tile_times<HD, true>(dk, Pw, S1, AT::KSTR, ic);
    __syncwarp();
  }
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = 2 * C + head * HD + 8 * d + 2 * t;
    *reinterpret_cast<float2*>(dqkv + tok0 * ld + col) = make_float2(dv[d][0], dv[d][1]);
    *reinterpret_cast<float2*>(dqkv + tok1 * ld + col) = make_float2(dv[d][2], dv[d][3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[d][i] *= c;
  }
  cosine_norm_bwd_store<HD>(dk, qkv + C + head * HD, dqkv + C + head * HD, ld, tok0, tok1, nrm0,
                            nrm1);
}

// ---- the backward's fixed-order reduction ----------------------------------------
//
// Blocks [0, 2B): the LayerNorm affine gradients of sample b = block % B,
// LN (block / B) + 1 (dlnw = d S1, dlnb = d S0 from the per-8-row sums
// (S1, S0) in order, ddp[b] = sum_c lnw S1 + lnb S0). The other blocks take
// one element each of: the four weight gradients (the split-K partials
// summed in order, each row scattered to its weight or, for the column of
// ones, its bias), dbias (ds summed over the windows of a slot in order),
// dscale (the per-warp shares in order).
struct Reduce {
  const float* wpart[4];
  int wm[4], wn[4], ws[4];  // rows, columns (with the ones column), splits
  int wseg[4];
  float* wout[4][3];
  float* bout[4][3];
  long long wend[4];  // prefix ends of the weight elements
  const float* lnpart[2];
  const float *lnw[2], *lnb[2], *dp;
  float *dlnw[2], *dlnb[2], *ddp;
  int B, C, gps;
  const float* ds;
  float* dbias;
  int R, nw;
  long long per;  // h n n
  const float* dsc;
  float* dscale;
  int h, P;       // P shares a (window, head)
  long long total;
};

__global__ void __launch_bounds__(kThreads) reduce_kernel(const Reduce q) {
  if ((int)blockIdx.x < 2 * q.B) {
    __shared__ float red[kThreads / 32];
    const int b = blockIdx.x % q.B, l = blockIdx.x / q.B, C = q.C;
    const float d = q.dp[2 * b + l];
    float acc = 0.f;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      KahanSum s1, s0;
      for (int gi = 0; gi < q.gps; ++gi) {
        const float* pr = q.lnpart[l] + ((long long)b * q.gps + gi) * 2 * C;
        s1.add(pr[c]);
        s0.add(pr[C + c]);
      }
      const long long i = (long long)b * C + c;
      q.dlnw[l][i] = d * s1.s;
      q.dlnb[l][i] = d * s0.s;
      acc += q.lnw[l][i] * s1.s + q.lnb[l][i] * s0.s;
    }
    acc = warp_sum(acc);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < kThreads / 32; ++i) s += red[i];
      q.ddp[2 * b + l] = s;
    }
    return;
  }
  long long e = (long long)(blockIdx.x - 2 * q.B) * kThreads + threadIdx.x;
  if (e >= q.total) return;
  for (int p = 0; p < 4; ++p) {
    if (e < q.wend[p]) {
      const long long base = p ? q.wend[p - 1] : 0, L = (long long)q.wm[p] * q.wn[p];
      const long long k = e - base;
      KahanSum ks;
      for (int z = 0; z < q.ws[p]; ++z) ks.add(q.wpart[p][z * L + k]);
      const float s = ks.s;
      const int i = (int)(k / q.wn[p]), j = (int)(k % q.wn[p]), seg = i / q.wseg[p];
      const int ri = i - seg * q.wseg[p], nin = q.wn[p] - 1;
      if (j < nin) q.wout[p][seg][(long long)ri * nin + j] = s;
      else if (q.bout[p][seg]) q.bout[p][seg][ri] = s;
      return;
    }
  }
  e -= q.wend[3];
  if (e < q.nw * q.per) {
    const int w = (int)(e / q.per);
    const long long r = e - w * q.per;
    KahanSum s;
    for (int row = w; row < q.R; row += q.nw) s.add(q.ds[row * q.per + r]);
    q.dbias[e] = s.s;
    return;
  }
  e -= q.nw * q.per;
  KahanSum s;
  for (int row = 0; row < q.R; ++row)
    for (int i = 0; i < q.P; ++i) s.add(q.dsc[((long long)row * q.h + e) * q.P + i]);
  q.dscale[e] = s.s;
}

// ---- launches --------------------------------------------------------------------

constexpr int kRowNT[] = {1, 2, 3, 4, 6, 8, 12};  // row-owning tiles: BN = 32 NT >= C

int row_nt(int C) {
  for (int nt : kRowNT)
    if (32 * nt >= C) return nt;
  return 0;
}

template <int MT, int NT, bool BKN>
cudaError_t launch_gemm(const Gemm& p, dim3 grid, cudaStream_t st) {
  using TL = Tile<MT, NT, false, BKN>;
  const int smem = kStages * TL::STAGE * 4;
  static int allowed = 0;
  cudaError_t e = allow_smem(gemm_kernel<MT, NT, false, BKN, EPI_STORE>, smem, allowed);
  if (e != cudaSuccess) return e;
  gemm_kernel<MT, NT, false, BKN, EPI_STORE><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// a general product: 64 x 96 tiles (of the sizes timed on an H100, the
// fastest at every stage), the whole K in each block
constexpr int GEN_MT = 2, GEN_NT = 3;
template <bool BKN>
cudaError_t gemm(const Gemm& p, cudaStream_t st) {
  constexpr int BM = 32 * GEN_MT, BN = 32 * GEN_NT;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, 1);
  return launch_gemm<GEN_MT, GEN_NT, BKN>(p, grid, st);
}

// A row-owning product with a LayerNorm epilogue: clusters of S blocks own
// 32 MT whole rows of N <= 384, each block a k range, S in {1, 2, 4} the
// least that gives two blocks an SM (the row tiles alone are 16 at stage 2,
// batch 16). S follows from the shapes and the card, so a rerun repeats to
// the bit.
template <int MT, int NT, bool BKN, int EPI>
cudaError_t launch_rows(Gemm p, cudaStream_t st) {
  using TL = Tile<MT, NT, false, BKN>;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int tiles = (p.M + TL::BM - 1) / TL::BM;
  int S = 1;
  while (S < 4 && tiles * S < 2 * sms) S *= 2;
  p.kchunk = ((p.K + S - 1) / S + BK - 1) / BK * BK;
  int smem = kStages * TL::STAGE * 4;
  const int epi = 2 * TL::BM * (TL::BN + 4) * 4;
  smem = smem > epi ? smem : epi;
  static int allowed = 0;
  cudaError_t e = allow_smem(gemm_kernel<MT, NT, false, BKN, EPI>, smem, allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(S, tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gemm_kernel<MT, NT, false, BKN, EPI>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

constexpr int ROWS_MT = 2;  // 64 rows a cluster
template <bool BKN, int EPI>
cudaError_t gemm_rows(const Gemm& p, cudaStream_t st) {
  switch (row_nt(p.N)) {
#define PREGEN_ROWS(NT) \
  case NT: return launch_rows<ROWS_MT, NT, BKN, EPI>(p, st);
    PREGEN_ROWS(1)
    PREGEN_ROWS(2)
    PREGEN_ROWS(3)
    PREGEN_ROWS(4)
    PREGEN_ROWS(6)
    PREGEN_ROWS(8)
    PREGEN_ROWS(12)
#undef PREGEN_ROWS
    default: return cudaErrorInvalidValue;
  }
}

int attn_warps(int n) { return n / 16 < kAttnWarps ? n / 16 : kAttnWarps; }
int attn_chunks(int n) { return (n + 16 * attn_warps(n) - 1) / (16 * attn_warps(n)); }
int attn_np(int n) { return (n + KC - 1) / KC * KC; }

template <int HD>
cudaError_t attn_fwd(const float* qkv, const float* bias, const float* scale, float* o, float* lse,
                     int R, int C, int nw, const Geom& g, cudaStream_t st) {
  using A = Attn<HD>;
  const int np = attn_np(g.n);
  const int smem =
      (np * (A::KSTR + A::VSTR + 1) + attn_warps(g.n) * (16 * A::PSTR + 32) + 2 * HD) * 4;
  static int allowed = 0;
  cudaError_t e = allow_smem(attn_fwd_kernel<HD>, smem, allowed);
  if (e != cudaSuccess) return e;
  attn_fwd_kernel<HD><<<dim3(R, g.h, attn_chunks(g.n)), 32 * attn_warps(g.n), smem, st>>>(
      qkv, bias, scale, o, lse, C, nw, g);
  return cudaGetLastError();
}

template <int HD>
cudaError_t attn_bwd(const float* qkv, const float* o, const float* dout, const float* lse,
                     const float* bias, const float* scale, float* dqkv, float* ds, float* dsc,
                     int R, int C, int nw, const Geom& g, cudaStream_t st) {
  using A = Attn<HD>;
  const int np = attn_np(g.n), nqc = attn_chunks(g.n);
  const int smem = (np * (2 * A::KSTR + 3) + attn_warps(g.n) * (16 * A::PSTR + 32) + 2 * HD) * 4;
  static int allowed = 0;
  cudaError_t e = allow_smem(attn_bwd_kernel<HD>, smem, allowed);
  if (e != cudaSuccess) return e;
  attn_bwd_kernel<HD><<<dim3(R, g.h, 2 * nqc), 32 * attn_warps(g.n), smem, st>>>(
      qkv, o, dout, lse, bias, scale, dqkv, ds, dsc, C, nw, nqc, g);
  return cudaGetLastError();
}

#define PREGEN_HD_SWITCH(hd, CALL)     \
  switch (hd) {                        \
    case 8: { constexpr int HD = 8; CALL; } break;   \
    case 16: { constexpr int HD = 16; CALL; } break; \
    case 32: { constexpr int HD = 32; CALL; } break; \
    case 64: { constexpr int HD = 64; CALL; } break; \
    default: return cudaErrorInvalidValue;           \
  }

#define PREGEN_TRY(call)              \
  do {                                \
    const cudaError_t e_ = (call);    \
    if (e_ != cudaSuccess) return e_; \
    ++*launched;                      \
  } while (0)

Gemm product(const float* A, int lda, const float* B0, const float* B1, const float* B2, int bseg,
             int ldb, int M, int N, int K, float* out, int ldo) {
  Gemm p = {};
  p.A = A, p.lda = lda;
  p.B[0] = B0, p.B[1] = B1, p.B[2] = B2;
  p.bseg = bseg, p.ldb = ldb, p.nb = N;
  p.M = M, p.N = N, p.K = K, p.kchunk = K;
  p.out = out, p.ldo = ldo;
  p.biseg = N;
  return p;
}

constexpr int kWgradRows = 512;  // tokens a split of the weight gradients

// The backward's float32 workspace, carved in this order (each piece
// rounded up to 64 floats).
struct BwdWork {
  float *dm, *dh, *dx2, *dattn, *dout, *dqkv, *ds, *dsc, *ln1, *ln2, *wpart[4];
};

long long carve(float* base, BwdWork* w, int B, int H, int W, int C, int heads, int ws, int F) {
  const long long M = (long long)B * H * W, n = (long long)ws * ws;
  const long long R = (long long)B * (H / ws) * (W / ws);
  const long long S = (M + kWgradRows - 1) / kWgradRows;
  const long long sizes[] = {M * C, M * F, M * C, M * C, M * C, 3 * M * C,
                             R * heads * n * n, R * heads * attn_chunks((int)n) * kAttnWarps,
                             M / kGroupRows * 2 * C, M / kGroupRows * 2 * C,
                             S * C * (F + 1), S * F * (C + 1), S * C * (C + 1),
                             S * 3 * C * (C + 1)};
  BwdWork unused;
  if (!w) w = &unused;
  float** slots[] = {&w->dm, &w->dh, &w->dx2, &w->dattn, &w->dout, &w->dqkv, &w->ds, &w->dsc,
                     &w->ln1, &w->ln2, &w->wpart[0], &w->wpart[1], &w->wpart[2], &w->wpart[3]};
  long long off = 0;
  for (int i = 0; i < 14; ++i) {
    *slots[i] = base ? base + off : nullptr;
    off += (sizes[i] + 63) / 64 * 64;
  }
  return off;
}

}  // namespace

extern "C" {

// x, y: (B, H, W, C) in the grid's order; bias (nw, h, n, n) with nw = 1
// or (H/ws)(W/ws), the logical (shifted) grid's windows; scale (h,); wq, wk,
// wv, wp (C, C), w1 (F, C), w2 (C, F) in nn.Linear's (out, in) layout, bq,
// bv, bp (C,), b1 (F,), b2 (C,) (null: no bias); ln1w, ln1b, ln2w, ln2b
// (B, C); dp (B, 2). Scratch: qkv (M, 3C), o (M, C), x2 (M, C), hpre (M, F),
// M = B H W. Saved for the backward when not null: lse (R, h, n), xhat1,
// xhat2 (M, C), rstd1, rstd2 (M,). hd = C / heads in {8, 16, 32, 64}, n a
// multiple of 16 up to 256, C <= 384 (checked by the wrapper).
int swin_block_fwd(const float* x, const float* bias, const float* scale, const float* wq,
                   const float* bq, const float* wk, const float* wv, const float* bv,
                   const float* wp, const float* bp, const float* ln1w, const float* ln1b,
                   const float* w1, const float* b1, const float* w2, const float* b2,
                   const float* ln2w, const float* ln2b, const float* dp, float* qkv, float* o,
                   float* x2, float* hpre, float* y, float* lse, float* xhat1, float* rstd1,
                   float* xhat2, float* rstd2, int B, int H, int W, int C, int heads, int ws,
                   int nw, int F, int shift, float eps, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int M = B * H * W, R = B * (H / ws) * (W / ws);
  const Geom g{H, W, ws, ws * ws, heads, shift};
  Gemm p = product(x, C, wq, wk, wv, C, C, M, 3 * C, C, qkv, 3 * C);
  p.bias[0] = bq, p.bias[2] = bv, p.biseg = C;
  PREGEN_TRY(gemm<false>(p, st));
  PREGEN_HD_SWITCH(C / heads, PREGEN_TRY(attn_fwd<HD>(qkv, bias, scale, o, lse, R, C, nw, g, st)));
  p = product(o, C, wp, nullptr, nullptr, C, C, M, C, C, x2, C);
  p.bias[0] = bp, p.res = x, p.lnw = ln1w, p.lnb = ln1b, p.dp = dp, p.which = 0, p.tps = H * W;
  p.eps = eps, p.xhat = xhat1, p.rstd = rstd1;
  PREGEN_TRY((gemm_rows<false, EPI_LNF>(p, st)));
  p = product(x2, C, w1, nullptr, nullptr, F, C, M, F, C, hpre, F);
  p.bias[0] = b1;
  PREGEN_TRY(gemm<false>(p, st));
  p = product(hpre, F, w2, nullptr, nullptr, C, F, M, C, F, y, C);
  p.aop = OP_GELU, p.bias[0] = b2, p.res = x2, p.lnw = ln2w, p.lnb = ln2b, p.dp = dp, p.which = 1;
  p.tps = H * W, p.eps = eps, p.xhat = xhat2, p.rstd = rstd2;
  PREGEN_TRY((gemm_rows<false, EPI_LNF>(p, st)));
  return cudaSuccess;
}

// Floats of the backward's workspace (see BwdWork).
long long swin_block_bwd_workspace(int B, int H, int W, int C, int heads, int ws, int F) {
  return carve(nullptr, nullptr, B, H, W, C, heads, ws, F);
}

// Every gradient of swin_block_fwd for the output gradient dy (B, H, W, C),
// from the operands and what the forward saved (qkv, o, lse, xhat1, rstd1,
// x2, hpre, xhat2, rstd2). Outputs in the operands' layouts: dx; dbias
// (nw, h, n, n); dscale (h); dwq, dwk, dwv, dwp (C, C); dbq, dbv (null when
// the layer has no such bias), dbp (C); dw1 (F, C), db1 (F); dw2 (C, F),
// db2 (C); dln1w, dln1b, dln2w, dln2b (B, C); ddp (B, 2). `work` holds
// swin_block_bwd_workspace(...) floats.
int swin_block_bwd(const float* x, const float* dy, const float* bias, const float* scale,
                   const float* wq, const float* wk, const float* wv, const float* wp,
                   const float* w1, const float* w2, const float* ln1w, const float* ln1b,
                   const float* ln2w, const float* ln2b, const float* dp, const float* qkv,
                   const float* o, const float* lse, const float* xhat1, const float* rstd1,
                   const float* x2, const float* hpre, const float* xhat2, const float* rstd2,
                   float* dx, float* dbias, float* dscale, float* dwq, float* dbq, float* dwk,
                   float* dwv, float* dbv, float* dwp, float* dbp, float* dln1w, float* dln1b,
                   float* dw1, float* db1, float* dw2, float* db2, float* dln2w, float* dln2b,
                   float* ddp, float* work, int B, int H, int W, int C, int heads, int ws, int nw,
                   int F, int shift, float eps, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  BwdWork k;
  carve(work, &k, B, H, W, C, heads, ws, F);
  const int M = B * H * W, R = B * (H / ws) * (W / ws), n = ws * ws;
  const Geom g{H, W, ws, n, heads, shift};
  // 1. LN2's backward: dm and its per-sample sums
  Gemm p = product(nullptr, 0, nullptr, nullptr, nullptr, 1, 0, M, C, 0, k.dm, C);
  p.aux = dy, p.lnw = ln2w, p.dp = dp, p.which = 1, p.tps = H * W, p.xhat_in = xhat2;
  p.rstd_in = rstd2, p.part = k.ln2;
  {
    const int smem = 2 * 32 * (C + 4) * 4;
    static int allowed = 0;
    cudaError_t e = allow_smem(ln_bwd_rows_kernel, smem, allowed);
    if (e != cudaSuccess) return e;
    ln_bwd_rows_kernel<<<(M + 31) / 32, kThreads, smem, st>>>(p);
    PREGEN_TRY(cudaGetLastError());
  }
  // 2. dh = (dm W2) gelu'(hpre)
  p = product(k.dm, C, w2, nullptr, nullptr, C, F, M, F, C, k.dh, F);
  p.aux = hpre, p.auxop = AUX_GELU_GRAD;
  PREGEN_TRY(gemm<true>(p, st));
  // 3. dx2 = dy + dh W1, LN1's backward in the epilogue: dattn and its sums
  p = product(k.dh, F, w1, nullptr, nullptr, F, C, M, C, F, k.dattn, C);
  p.aux = dy, p.lnw = ln1w, p.dp = dp, p.which = 0, p.tps = H * W, p.xhat_in = xhat1;
  p.rstd_in = rstd1, p.out2 = k.dx2, p.part = k.ln1;
  PREGEN_TRY((gemm_rows<true, EPI_LNB>(p, st)));
  // 4. do = dattn Wp
  p = product(k.dattn, C, wp, nullptr, nullptr, C, C, M, C, C, k.dout, C);
  PREGEN_TRY(gemm<true>(p, st));
  // 5. the attention backward
  PREGEN_HD_SWITCH(C / heads, PREGEN_TRY(attn_bwd<HD>(qkv, o, k.dout, lse, bias, scale, k.dqkv,
                                                      k.ds, k.dsc, R, C, nw, g, st)));
  // 6. dx = dx2 + dqkv [Wq; Wk; Wv]
  p = product(k.dqkv, 3 * C, wq, wk, wv, C, C, M, C, 3 * C, dx, C);
  p.aux = k.dx2, p.auxop = AUX_ADD;
  PREGEN_TRY(gemm<true>(p, st));
  // 7. the weight gradients G^T X over the tokens, a column of ones for the bias
  Gemm4 q = {};
  const float* G[4] = {k.dm, k.dh, k.dattn, k.dqkv};
  const float* X[4] = {hpre, x2, o, x};
  const int rows[4] = {C, F, C, 3 * C}, cols[4] = {F, C, C, C};
  const int S = (M + kWgradRows - 1) / kWgradRows;
  int blocks = 0;
  for (int i = 0; i < 4; ++i) {
    Gemm& w = q.g[i];
    w = product(G[i], rows[i], X[i], nullptr, nullptr, M, cols[i], rows[i], cols[i] + 1, M,
                k.wpart[i], cols[i] + 1);
    w.nb = cols[i], w.ones = 1, w.kchunk = kWgradRows, w.bop = i == 0 ? OP_GELU : OP_NONE;
    constexpr int BM = 32 * WG_MT, BN = 32 * WG_NT;
    blocks += ((rows[i] + BM - 1) / BM) * ((cols[i] + BN) / BN) * S;
    q.blocks[i] = blocks;
  }
  q.count = 4;
  {
    using TL = Tile<WG_MT, WG_NT, true, true>;
    const int smem = kStages * TL::STAGE * 4;
    static int allowed = 0;
    cudaError_t e = allow_smem(wgrad_kernel, smem, allowed);
    if (e != cudaSuccess) return e;
    wgrad_kernel<<<blocks, kThreads, smem, st>>>(q);
    PREGEN_TRY(cudaGetLastError());
  }
  // 8. every partial summed in a fixed order
  Reduce r = {};
  float* wout[4][3] = {{dw2}, {dw1}, {dwp}, {dwq, dwk, dwv}};
  float* bout[4][3] = {{db2}, {db1}, {dbp}, {dbq, nullptr, dbv}};
  long long end = 0;
  for (int i = 0; i < 4; ++i) {
    r.wpart[i] = k.wpart[i], r.wm[i] = rows[i], r.wn[i] = cols[i] + 1, r.ws[i] = S;
    r.wseg[i] = i == 3 ? C : rows[i];
    for (int s = 0; s < 3; ++s) r.wout[i][s] = wout[i][s], r.bout[i][s] = bout[i][s];
    end += (long long)rows[i] * (cols[i] + 1);
    r.wend[i] = end;
  }
  r.lnpart[0] = k.ln1, r.lnpart[1] = k.ln2, r.lnw[0] = ln1w, r.lnw[1] = ln2w;
  r.lnb[0] = ln1b, r.lnb[1] = ln2b, r.dp = dp, r.dlnw[0] = dln1w, r.dlnw[1] = dln2w;
  r.dlnb[0] = dln1b, r.dlnb[1] = dln2b, r.ddp = ddp, r.B = B, r.C = C, r.gps = H * W / kGroupRows;
  r.ds = k.ds, r.dbias = dbias, r.R = R, r.nw = nw, r.per = (long long)heads * n * n;
  r.dsc = k.dsc, r.dscale = dscale, r.h = heads, r.P = attn_chunks(n) * kAttnWarps;
  r.total = end + nw * r.per + heads;
  reduce_kernel<<<(unsigned)(2 * B + (r.total + kThreads - 1) / kThreads), kThreads, 0, st>>>(r);
  PREGEN_TRY(cudaGetLastError());
  return cudaSuccess;
}

}  // extern "C"
