// Hand-written Swin-V2 block forward and backward for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernels
//   pregen_pde_tpu/ops/swin_block.py::fused_swin_block (forward,
//   `_fwd_kernel`, pallas_call in `_fused_call`; backward, `_bwd_kernel`,
//   pallas_call in `_fused_bwd_call`)
// One post-norm Swin-V2 layer on an (already cyclically shifted) token grid
// x (B, H, W, C), windows of ws x ws tokens (n = ws^2), h heads of hd:
//   q, k, v = x Wq + bq, x Wk, x Wv + bv           (per token)
//   o       = softmax(scale_h qn.kn^T + bias[w, h]) v, qn = q/(|q| + 1e-6)
//                                                   (per window and head)
//   a       = o Wp + bp
//   x2      = x + dp[b, 0] (LN(a) ln1w[b] + ln1b[b])
//   y       = x2 + dp[b, 1] (LN(gelu_tanh(x2 W1 + b1) W2 + b2) ln2w[b] + ln2b[b])
// with LN(t) = (t - mean) / sqrt(E[t^2] - mean^2 + eps) and per-sample
// (conditional) affines.
//
// Design. The TPU kernel is one program per (sample, window) holding the
// window's tokens, every weight and the MLP intermediate in VMEM; it lost to
// XLA on the TPU, and at scOT-B's widths a 256 x 384 float32 tile with its
// 4x MLP intermediate does not fit an SM's 227 KB. Only the attention is
// per window: the projections, LayerNorms and MLP act per token. So the
// block is seven launches over all B H W tokens on the caller's stream:
//   1. qkv GEMM with the bias epilogue ((M, C) x (C, 3C));
//   2. attention, one block per (window, head), windows addressed by index
//      into the token grid: cosine normalisation, logit scale, bias, online
//      softmax . v (window_softmax.cuh), written head-major into o (M, C);
//   3. proj GEMM ((M, C) x (C, C) + bp);
//   4. row pass: CondLN1 with the per-sample affine, drop-path residual;
//   5. MLP1 GEMM with the GELU-tanh epilogue ((M, C) x (C, 4C));
//   6. MLP2 GEMM ((M, 4C) x (4C, C) + b2);
//   7. row pass: CondLN2 and the residual.
// The GEMMs are one shared-memory tiled SGEMM (64 x 64 output tiles, 16-deep
// k steps, 4 x 4 outputs a thread), float32 with float32 accumulation.
//
// What bounds it on the H100: the dense products (24 M C^2 FLOP for qkv,
// proj and the MLP, plus 4 M n C for the attention) on the float32 CUDA
// cores; scOT-B stage 0 at batch 16 (M = 16384, C = 96, n = 256) is 5.2
// GFLOP, 78 us at the 67 TFLOP/s peak, against ~16 MB of x, y, weights and
// bias (5 us at 3.35 TB/s).
// The intermediates (qkv, o, a, x2, the 4C hidden, the MLP output) round-trip
// device memory, mostly inside the 50 MB L2. A later version can move the GEMMs
// to tensor cores (TF32 or 3xbf16 with a bar), fuse the LayerNorm passes
// into the GEMM epilogues, and fuse MLP1 and MLP2 per token tile.
//
// Backward (`swin_block_bwd`). The TPU's backward is one program per
// (window, sample) with the weight-gradient accumulators resident in VMEM
// and a sequential grid; blocks here run in parallel in no order, so it is
// launches over all tokens too: the forward's first six recomputed (nothing
// is saved by the forward), the LayerNorm backward row passes, NT GEMMs for
// the activation gradients (the GELU derivative and the residual adds in
// their epilogues), split-K TN GEMMs for the weight gradients (the reduction
// runs over the M = B H W tokens: 16,384 at stage 0, so the (C, 4C) output
// alone would fill only a dozen 64 x 64 tiles), the attention backward of
// attention_bwd.cuh, and fixed-order sums of every partial (deterministic).
// It runs wherever the forward runs (C <= 384 in the model; the JAX
// package's C <= 192 backward limit is the TPU's VMEM and does not apply).
// Bound like the forward, on the float32 CUDA cores: about 3x its FLOP
// (the recompute, then two products per forward product).
//
// Kernels launch on the caller's stream, never synchronise and allocate
// nothing; the entry points return cudaGetLastError() after each launch and
// report how many kernels they enqueued (`launched`).

#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"
#include "window_softmax.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, kGemmThreads = 256;

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

enum Epilogue { EPI_BIAS, EPI_GELU, EPI_GELU_GRAD, EPI_ADD };

// C[M, N] = op(A)[M, K] op(B)[K, N] over this block's k range, row-major,
// ragged edges masked. TA: A is stored (K, M); TB: B is stored (N, K).
// Split-K: block z sums k in [z kchunk, (z+1) kchunk) into C + z M N.
// Epilogue: EPI_BIAS adds bias[n] (bias may be null); EPI_GELU also, then
// writes GELU-tanh to C and the pre-activation to C2 (if not null);
// EPI_GELU_GRAD multiplies by gelu_tanh_grad(aux[m, n]); EPI_ADD adds
// aux[m, n].
template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ bias, const float* __restrict__ aux, float* __restrict__ C,
            float* __restrict__ C2, int M, int N, int K, int kchunk) {
  __shared__ __align__(16) float As[BK][BM + 4];  // A tile, transposed (k-major)
  __shared__ __align__(16) float Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += kGemmThreads) {
      const int mm = TA ? e % BM : e / BK, kk = TA ? e / BM : e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < ke)
                       ? (TA ? A[(long long)gk * M + gm] : A[(long long)gm * K + gk]) : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += kGemmThreads) {
      const int kk = TB ? e % BK : e / BN, nn = TB ? e / BK : e % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < ke && gn < N)
                       ? (TB ? B[(long long)gn * K + gk] : B[(long long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
  C += (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      const long long idx = (long long)gm * N + gn;
      float val = acc[i][j];
      if (EPI == EPI_BIAS || EPI == EPI_GELU) val += bias ? bias[gn] : 0.f;
      if (EPI == EPI_GELU) {
        if (C2) C2[idx] = val;
        val = gelu_tanh(val);
      }
      if (EPI == EPI_GELU_GRAD) val *= gelu_tanh_grad(aux[idx]);
      if (EPI == EPI_ADD) val += aux[idx];
      C[idx] = val;
    }
  }
}

// One block per (window, head): window wi = b * nwh * nww + wh * nww + ww of
// the token grid (B, H, W); its n = ws^2 tokens in row-major order.
template <int HD>
__global__ void window_attn_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                                   const float* __restrict__ scale, float* __restrict__ o,
                                   int H, int W, int C, int ws, int nw) {
  extern __shared__ float4 smem4[];
  const int n = ws * ws;
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + n * HD;
  const int nww = W / ws, nwin = (H / ws) * nww;
  const int wi = blockIdx.x, head = blockIdx.y;
  const int b = wi / nwin, w = wi % nwin;
  const int t = threadIdx.x;
  long long tok = 0;
  if (t < n) {
    const int r = (w / nww) * ws + t / ws, c = (w % nww) * ws + t % ws;
    tok = ((long long)b * H + r) * W + c;
    const float* row = qkv + tok * 3 * C + head * HD;
    float kk[HD];
    float ss = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      kk[d] = row[C + d];
      ss += kk[d] * kk[d];
    }
    const float kinv = 1.f / (sqrtf(ss) + 1e-6f);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      ks[t * HD + d] = kk[d] * kinv;
      vs[t * HD + d] = row[2 * C + d];
    }
  }
  __syncthreads();
  if (t >= n) return;
  const float* row = qkv + tok * 3 * C + head * HD;
  float q[HD], acc[HD];
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    q[d] = row[d];
    ss += q[d] * q[d];
  }
  const float qinv = 1.f / (sqrtf(ss) + 1e-6f);
#pragma unroll
  for (int d = 0; d < HD; ++d) q[d] *= qinv;
  const int heads = C / HD;
  const float* brow = bias + (((long long)(nw > 1 ? w : 0) * heads + head) * n + t) * n;
  window_softmax_row<HD>(q, scale[head], ks, vs, brow, n, acc);
  float* out = o + tok * C + head * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) out[d] = acc[d];
}

// One warp per token row: y = res + dp[b, which] ((t - mean) rstd w[b] + bb[b]).
__global__ void cond_ln_residual_kernel(const float* __restrict__ res, const float* __restrict__ t,
                                        const float* __restrict__ w, const float* __restrict__ bb,
                                        const float* __restrict__ dp, int which, float* __restrict__ y,
                                        int M, int C, int tokens_per_sample, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* tr = t + (long long)row * C;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = tr[c];
    s += v;
    s2 += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = s / C;
  const float rstd = 1.f / sqrtf(s2 / C - mean * mean + eps);
  const int b = row / tokens_per_sample;
  const float keep = dp[2 * b + which];
  const float* wr = w + (long long)b * C;
  const float* br = bb + (long long)b * C;
  const float* rr = res + (long long)row * C;
  float* yr = y + (long long)row * C;
  for (int c = lane; c < C; c += 32) yr[c] = rr[c] + keep * ((tr[c] - mean) * rstd * wr[c] + br[c]);
}

// One warp per token row, the LayerNorm backward of a post-norm residual
// y = res + d (LN(t) w[b] + bb[b]) for the upstream gradient g:
// xhat = (t - mean) rstd, dxhat = d g w[b], dt = rstd (dxhat - mean(dxhat)
// - xhat mean(dxhat xhat)) (the JAX `_ln_bwd`); writes dt and xhat.
__global__ void ln_bwd_kernel(const float* __restrict__ g, const float* __restrict__ t,
                              const float* __restrict__ w, const float* __restrict__ dp, int which,
                              float* __restrict__ dt, float* __restrict__ xhat, int M, int C,
                              int tokens_per_sample, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* tr = t + (long long)row * C;
  const float* gr = g + (long long)row * C;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = tr[c];
    s += v;
    s2 += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = s / C;
  const float rstd = 1.f / sqrtf(s2 / C - mean * mean + eps);
  const int b = row / tokens_per_sample;
  const float d = dp[2 * b + which];
  const float* wr = w + (long long)b * C;
  float* xr = xhat + (long long)row * C;
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float xh = (tr[c] - mean) * rstd, dxh = d * gr[c] * wr[c];
    xr[c] = xh;
    m1 += dxh;
    m2 += dxh * xh;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m1 += __shfl_xor_sync(0xffffffffu, m1, off);
    m2 += __shfl_xor_sync(0xffffffffu, m2, off);
  }
  m1 /= C;
  m2 /= C;
  float* dr = dt + (long long)row * C;
  for (int c = lane; c < C; c += 32) dr[c] = rstd * (d * gr[c] * wr[c] - m1 - xr[c] * m2);
}

// Column sums over segments of T rows of A (nseg T, N), split over blocks:
// part[z][seg][0][c] = sum of A X over split z's rows when X is not null,
// and part[z][seg][X ? 1 : 0][c] = sum of A. 32 columns x 8 row lanes a
// block, the lanes added in a fixed order.
__global__ void colsum_kernel(const float* __restrict__ A, const float* __restrict__ X,
                              float* __restrict__ part, int N, int T, int nseg, int tchunk) {
  __shared__ float s0[8][33], s1[8][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx, seg = blockIdx.y, z = blockIdx.z;
  const int r1 = min(T, (z + 1) * tchunk);
  float a0 = 0.f, a1 = 0.f;
  if (c < N) {
    for (int r = z * tchunk + ty; r < r1; r += 8) {
      const long long idx = ((long long)seg * T + r) * N + c;
      const float a = A[idx];
      a1 += a;
      if (X) a0 += a * X[idx];
    }
  }
  s0[ty][tx] = a0;
  s1[ty][tx] = a1;
  __syncthreads();
  if (ty != 0 || c >= N) return;
  float t0 = 0.f, t1 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t0 += s0[i][tx];
    t1 += s1[i][tx];
  }
  const int k = X ? 2 : 1;
  float* out = part + (long long)(z * nseg + seg) * k * N;
  if (X) out[c] = t0;
  out[(k - 1) * N + c] = t1;
}

// out[i] = sum over z < S of part[z L + i], in order.
__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out, int S,
                                     long long L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  float s = 0.f;
  for (int z = 0; z < S; ++z) s += part[(long long)z * L + i];
  out[i] = s;
}

// Per sample b (one block): from red (B, 2, C) = (sum g xhat, sum g),
// dlnw = d S1, dlnb = d S0 and ddp[b, which] = sum_c (w S1 + bb S0), the
// drop-path multiplier's gradient (d = dp[b, which]).
__global__ void affine_grad_kernel(const float* __restrict__ red, const float* __restrict__ w,
                                   const float* __restrict__ bb, const float* __restrict__ dp,
                                   int which, float* __restrict__ dlnw, float* __restrict__ dlnb,
                                   float* __restrict__ ddp, int C) {
  __shared__ float part[32];
  const int b = blockIdx.x, t = threadIdx.x;
  const float d = dp[2 * b + which];
  const float* s1 = red + (long long)b * 2 * C;
  const float* s0 = s1 + C;
  float acc = 0.f;
  for (int c = t; c < C; c += blockDim.x) {
    const long long i = (long long)b * C + c;
    dlnw[i] = d * s1[c];
    dlnb[i] = d * s0[c];
    acc += w[i] * s1[c] + bb[i] * s0[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (t % 32 == 0) part[t / 32] = acc;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    for (int i = 0; i < (int)blockDim.x / 32; ++i) s += part[i];
    ddp[2 * b + which] = s;
  }
}

// k rows per split of a K-long reduction over `splits` blocks (a multiple
// of BK), and the number of splits that then hold work
int split_chunk(int K, int splits) {
  if (splits <= 1) return K;
  return ((K + splits - 1) / splits + BK - 1) / BK * BK;
}
int split_count(int K, int splits) { return (K + split_chunk(K, splits) - 1) / split_chunk(K, splits); }

template <bool TA, bool TB, int EPI>
cudaError_t gemm_t(const float* A, const float* B, const float* bias, const float* aux, float* C,
                   float* C2, int M, int N, int K, int splits, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split_count(K, splits));
  gemm_kernel<TA, TB, EPI><<<grid, kGemmThreads, 0, st>>>(A, B, bias, aux, C, C2, M, N, K,
                                                           split_chunk(K, splits));
  return cudaGetLastError();
}

cudaError_t gemm(const float* A, const float* B, const float* bias, float* C, int M, int N, int K,
                 bool gelu, cudaStream_t st, float* pre = nullptr) {
  return gelu ? gemm_t<false, false, EPI_GELU>(A, B, bias, nullptr, C, pre, M, N, K, 1, st)
              : gemm_t<false, false, EPI_BIAS>(A, B, bias, nullptr, C, nullptr, M, N, K, 1, st);
}

template <int HD>
cudaError_t attention(const float* qkv, const float* bias, const float* scale, float* o, int B,
                      int H, int W, int C, int ws, int nw, cudaStream_t st) {
  const int n = ws * ws;
  const int smem = 2 * n * HD * (int)sizeof(float);
  cudaError_t e = allow_smem(window_attn_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * (H / ws) * (W / ws), C / HD);
  window_attn_kernel<HD><<<grid, (n + 31) / 32 * 32, smem, st>>>(qkv, bias, scale, o, H, W, C, ws,
                                                                 nw);
  return cudaGetLastError();
}

cudaError_t cond_ln(const float* res, const float* t, const float* w, const float* bb,
                    const float* dp, int which, float* y, int M, int C, int tps, float eps,
                    cudaStream_t st) {
  constexpr int kRows = 8;  // warps (token rows) per block
  cond_ln_residual_kernel<<<(M + kRows - 1) / kRows, 32 * kRows, 0, st>>>(res, t, w, bb, dp, which,
                                                                          y, M, C, tps, eps);
  return cudaGetLastError();
}

cudaError_t ln_bwd(const float* g, const float* t, const float* w, const float* dp, int which,
                   float* dt, float* xhat, int M, int C, int tps, float eps, cudaStream_t st) {
  constexpr int kRows = 8;
  ln_bwd_kernel<<<(M + kRows - 1) / kRows, 32 * kRows, 0, st>>>(g, t, w, dp, which, dt, xhat, M, C,
                                                                tps, eps);
  return cudaGetLastError();
}

#define PREGEN_TRY(call)                          \
  do {                                            \
    const cudaError_t e_ = (call);                \
    if (e_ != cudaSuccess) return e_;             \
    ++*launched;                                  \
  } while (0)

// out (nseg, k, N) = column sums of A (and of A X) over segments of T rows
// (k = 2 with X, else 1): partials over split_count(T, splits) blocks of
// rows, then their fixed-order sum. 2 launches.
cudaError_t colsum(const float* A, const float* X, float* out, float* part, int N, int T, int nseg,
                   int splits, cudaStream_t st, int* launched) {
  const int z = split_count(T, splits);
  colsum_kernel<<<dim3((N + 31) / 32, nseg, z), 256, 0, st>>>(A, X, part, N, T, nseg,
                                                              split_chunk(T, splits));
  PREGEN_TRY(cudaGetLastError());
  const long long L = (long long)nseg * (X ? 2 : 1) * N;
  reduce_splits_kernel<<<(unsigned)((L + 255) / 256), 256, 0, st>>>(part, out, z, L);
  PREGEN_TRY(cudaGetLastError());
  return cudaSuccess;
}

// W (Mw, N) = A^T G for A (K, Mw) and G (K, N) row-major, K the token
// count: split-K partials into `part`, then their fixed-order sum.
cudaError_t wgrad(const float* A, const float* G, float* W, float* part, int Mw, int N, int K,
                  int splits, cudaStream_t st, int* launched) {
  const int z = split_count(K, splits);
  PREGEN_TRY((gemm_t<true, false, EPI_BIAS>(A, G, nullptr, nullptr, z > 1 ? part : W, nullptr, Mw,
                                            N, K, splits, st)));
  if (z > 1) {
    const long long L = (long long)Mw * N;
    reduce_splits_kernel<<<(unsigned)((L + 255) / 256), 256, 0, st>>>(part, W, z, L);
    PREGEN_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

// Launches 1-6 of the block: qkv = x Wqkv + bqkv; o = attention; a = o Wp
// + bp; x2 = x + d1 (LN(a) ln1w + ln1b); gl = gelu(x2 W1 + b1) (the
// pre-activation into pre when not null); m = gl W2 + b2. a and m may share
// storage (a is spent by the time m is written).
cudaError_t block_front(const float* x, const float* bias, const float* scale, const float* wqkv,
                        const float* bqkv, const float* wp, const float* bp, const float* ln1w,
                        const float* ln1b, const float* w1, const float* b1, const float* w2,
                        const float* b2, const float* dp, float* qkv, float* o, float* a,
                        float* x2, float* gl, float* pre, float* m, int B, int H, int W, int C,
                        int heads, int ws, int nw, int F, float eps, cudaStream_t st,
                        int* launched) {
  const int M = B * H * W;
  PREGEN_TRY(gemm(x, wqkv, bqkv, qkv, M, 3 * C, C, false, st));
  switch (C / heads) {
    case 8: PREGEN_TRY(attention<8>(qkv, bias, scale, o, B, H, W, C, ws, nw, st)); break;
    case 16: PREGEN_TRY(attention<16>(qkv, bias, scale, o, B, H, W, C, ws, nw, st)); break;
    case 32: PREGEN_TRY(attention<32>(qkv, bias, scale, o, B, H, W, C, ws, nw, st)); break;
    case 64: PREGEN_TRY(attention<64>(qkv, bias, scale, o, B, H, W, C, ws, nw, st)); break;
    default: return cudaErrorInvalidValue;
  }
  PREGEN_TRY(gemm(o, wp, bp, a, M, C, C, false, st));
  PREGEN_TRY(cond_ln(x, a, ln1w, ln1b, dp, 0, x2, M, C, H * W, eps, st));
  PREGEN_TRY(gemm(x2, w1, b1, gl, M, F, C, true, st, pre));
  PREGEN_TRY(gemm(gl, w2, b2, m, M, C, F, false, st));
  return cudaSuccess;
}

// The backward's float32 workspace, carved in this order (each piece
// rounded up to 64 floats): qkv, dqkv (M, 3C); o, a, x2, m, dm, xhat, dx2,
// dattn, do (M, C); pre, gl, dh (M, F); ds (R, h, n, n); stats (R, h, n, 2);
// dscale shares (R, h); red (B, 2, C); part (splits partials of the
// largest weight gradient or column sum).
struct BwdWork {
  float *qkv, *dqkv, *o, *a, *x2, *m, *dm, *xhat, *dx2, *dattn, *dout, *pre, *gl, *dh, *ds, *stats,
      *dscp, *red, *part;
};

long long carve(float* base, BwdWork* w, int B, int H, int W, int C, int heads, int ws, int F,
                int splits) {
  const long long M = (long long)B * H * W, n = (long long)ws * ws;
  const long long R = (long long)B * (H / ws) * (W / ws);
  const long long mx = C * 3LL > F ? C * 3LL : F;
  long long part = (long long)C * (C * 3LL > F ? C * 3LL : F);  // the largest weight gradient
  if (2LL * B * C > part) part = 2LL * B * C;
  if (mx > part) part = mx;
  const long long sizes[] = {M * 3 * C, M * 3 * C, M * C, M * C, M * C, M * C, M * C, M * C,
                             M * C, M * C, M * C, M * F, M * F, M * F, R * heads * n * n,
                             R * heads * n * 2, R * heads, 2LL * B * C, part * (splits > 1 ? splits : 1)};
  BwdWork unused;
  if (!w) w = &unused;
  float** slots[] = {&w->qkv, &w->dqkv, &w->o, &w->a, &w->x2, &w->m, &w->dm, &w->xhat, &w->dx2,
                     &w->dattn, &w->dout, &w->pre, &w->gl, &w->dh, &w->ds, &w->stats, &w->dscp,
                     &w->red, &w->part};
  long long off = 0;
  for (int i = 0; i < 19; ++i) {
    *slots[i] = base ? base + off : nullptr;
    off += (sizes[i] + 63) / 64 * 64;
  }
  return off;
}

}  // namespace

extern "C" {

// x, y: (B, H, W, C); bias (nw, h, n, n) with nw = 1 or (H/ws)(W/ws);
// scale (h,); wqkv (C, 3C) = [Wq | Wk | Wv] with head-major columns, bqkv
// (3C,) = [bq | 0 | bv]; wp (C, C), bp (C,); w1 (C, F), b1 (F,); w2 (F, C),
// b2 (C,); ln1w, ln1b, ln2w, ln2b (B, C); dp (B, 2). Scratch: qkv (M, 3C),
// o (M, C), t (M, C), x2 (M, C), hid (M, F), M = B H W. hd = C / heads in
// {8, 16, 32, 64}; H, W multiples of ws (checked by the wrapper).
int swin_block_fwd(const float* x, const float* bias, const float* scale, const float* wqkv,
                   const float* bqkv, const float* wp, const float* bp, const float* ln1w,
                   const float* ln1b, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* ln2w, const float* ln2b, const float* dp,
                   float* qkv, float* o, float* t, float* x2, float* hid, float* y, int B, int H,
                   int W, int C, int heads, int ws, int nw, int F, float eps, void* stream,
                   int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  cudaError_t e = block_front(x, bias, scale, wqkv, bqkv, wp, bp, ln1w, ln1b, w1, b1, w2, b2, dp,
                              qkv, o, t, x2, hid, nullptr, t, B, H, W, C, heads, ws, nw, F, eps,
                              st, launched);
  if (e != cudaSuccess) return e;
  PREGEN_TRY(cond_ln(x2, t, ln2w, ln2b, dp, 1, y, B * H * W, C, H * W, eps, st));
  return cudaSuccess;
}

// Floats of the backward's workspace (see BwdWork).
long long swin_block_bwd_workspace(int B, int H, int W, int C, int heads, int ws, int F,
                                   int splits) {
  return carve(nullptr, nullptr, B, H, W, C, heads, ws, F, splits);
}

// Every gradient of swin_block_fwd for the output gradient dy (B, H, W, C),
// the operands as there. The forward's intermediates are recomputed
// (launches 1-6 of the forward, keeping a, m and the MLP pre-activation),
// then: the LN2 backward row pass and its per-sample affine sums; dh =
// (dm W2^T) gelu'(pre), dW2 = gl^T dm, db2; dx2 = dy + dh W1^T, dW1 =
// x2^T dh, db1; the LN1 backward row pass and its sums; do = dattn Wp^T,
// dWp = o^T dattn, dbp; the attention backward (attention_bwd.cuh, with the
// cosine normalisation, dscale and dbias); dx = dx2 + dqkv Wqkv^T, dWqkv =
// x^T dqkv, dbqkv. The weight gradients reduce over the M = B H W tokens
// in `splits` split-K partials, summed in a fixed order; so are the bias
// and per-sample sums: no atomics, and a rerun repeats to the bit.
// Outputs: dx (B, H, W, C); dbias (nw, h, n, n); dscale (h); dwqkv (C, 3C);
// dbqkv (3C); dwp (C, C); dbp (C); dw1 (C, F); db1 (F); dw2 (F, C); db2 (C);
// dln1w, dln1b, dln2w, dln2b (B, C); ddp (B, 2). `work` holds
// swin_block_bwd_workspace(...) floats.
int swin_block_bwd(const float* x, const float* dy, const float* bias, const float* scale,
                   const float* wqkv, const float* bqkv, const float* wp, const float* bp,
                   const float* ln1w, const float* ln1b, const float* w1, const float* b1,
                   const float* w2, const float* b2, const float* ln2w, const float* ln2b,
                   const float* dp, float* dx, float* dbias, float* dscale, float* dwqkv,
                   float* dbqkv, float* dwp, float* dbp, float* dw1, float* db1, float* dw2,
                   float* db2, float* dln1w, float* dln1b, float* dln2w, float* dln2b, float* ddp,
                   float* work, int B, int H, int W, int C, int heads, int ws, int nw, int F,
                   int splits, float eps, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  BwdWork k;
  carve(work, &k, B, H, W, C, heads, ws, F, splits);
  const int M = B * H * W, tps = H * W;
  cudaError_t e = block_front(x, bias, scale, wqkv, bqkv, wp, bp, ln1w, ln1b, w1, b1, w2, b2, dp,
                              k.qkv, k.o, k.a, k.x2, k.gl, k.pre, k.m, B, H, W, C, heads, ws, nw,
                              F, eps, st, launched);
  if (e != cudaSuccess) return e;
  // LN2 and the MLP
  PREGEN_TRY(ln_bwd(dy, k.m, ln2w, dp, 1, k.dm, k.xhat, M, C, tps, eps, st));
  if ((e = colsum(dy, k.xhat, k.red, k.part, C, tps, B, splits, st, launched))) return e;
  affine_grad_kernel<<<B, 128, 0, st>>>(k.red, ln2w, ln2b, dp, 1, dln2w, dln2b, ddp, C);
  PREGEN_TRY(cudaGetLastError());
  PREGEN_TRY((gemm_t<false, true, EPI_GELU_GRAD>(k.dm, w2, nullptr, k.pre, k.dh, nullptr, M, F, C,
                                                 1, st)));
  if ((e = wgrad(k.gl, k.dm, dw2, k.part, F, C, M, splits, st, launched))) return e;
  if ((e = colsum(k.dm, nullptr, db2, k.part, C, M, 1, splits, st, launched))) return e;
  PREGEN_TRY((gemm_t<false, true, EPI_ADD>(k.dh, w1, nullptr, dy, k.dx2, nullptr, M, C, F, 1, st)));
  if ((e = wgrad(k.x2, k.dh, dw1, k.part, C, F, M, splits, st, launched))) return e;
  if ((e = colsum(k.dh, nullptr, db1, k.part, F, M, 1, splits, st, launched))) return e;
  // LN1 and the output projection
  PREGEN_TRY(ln_bwd(k.dx2, k.a, ln1w, dp, 0, k.dattn, k.xhat, M, C, tps, eps, st));
  if ((e = colsum(k.dx2, k.xhat, k.red, k.part, C, tps, B, splits, st, launched))) return e;
  affine_grad_kernel<<<B, 128, 0, st>>>(k.red, ln1w, ln1b, dp, 0, dln1w, dln1b, ddp, C);
  PREGEN_TRY(cudaGetLastError());
  PREGEN_TRY((gemm_t<false, true, EPI_BIAS>(k.dattn, wp, nullptr, nullptr, k.dout, nullptr, M, C,
                                            C, 1, st)));
  if ((e = wgrad(k.o, k.dattn, dwp, k.part, C, C, M, splits, st, launched))) return e;
  if ((e = colsum(k.dattn, nullptr, dbp, k.part, C, M, 1, splits, st, launched))) return e;
  // attention, then the qkv projection
  const AttnGeom g{heads, ws * ws, H, W, ws};
  const int R = B * (H / ws) * (W / ws);
  if ((e = attention_bwd<true>(C / heads, k.qkv, k.qkv + C, k.qkv + 2 * C, 3 * C, k.o, k.dout, C,
                               bias, nw, scale, k.dqkv, k.dqkv + C, k.dqkv + 2 * C, k.ds,
                               reinterpret_cast<float2*>(k.stats), k.dscp, dbias, dscale, R, g, st,
                               launched)))
    return e;
  PREGEN_TRY((gemm_t<false, true, EPI_ADD>(k.dqkv, wqkv, nullptr, k.dx2, dx, nullptr, M, C, 3 * C,
                                           1, st)));
  if ((e = wgrad(x, k.dqkv, dwqkv, k.part, C, 3 * C, M, splits, st, launched))) return e;
  if ((e = colsum(k.dqkv, nullptr, dbqkv, k.part, 3 * C, M, 1, splits, st, launched))) return e;
  return cudaSuccess;
}

}  // extern "C"
