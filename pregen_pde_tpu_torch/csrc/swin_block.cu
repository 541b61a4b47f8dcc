// Hand-written Swin-V2 block forward for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel
//   pregen_pde_tpu/ops/swin_block.py::fused_swin_block (forward,
//   `_fwd_kernel`, pallas_call in `_fused_call`)
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
// Kernels launch on the caller's stream, never synchronise and allocate
// nothing; the entry point returns cudaGetLastError() after each launch and
// reports how many kernels it enqueued (`launched`).

#include <cuda_runtime.h>
#include <math.h>

#include "window_softmax.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, kGemmThreads = 256;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// C[M, N] = A[M, K] B[K, N] + bias[N] (bias may be null), then GELU-tanh
// when GELU. Row-major, ragged edges masked.
template <bool GELU>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + 4];  // A tile, transposed (k-major)
  __shared__ __align__(16) float Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += kGemmThreads) {
      const int mm = e / BK, kk = e % BK, gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[(long long)gm * K + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += kGemmThreads) {
      const int kk = e / BN, nn = e % BN, gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? B[(long long)gk * N + gn] : 0.f;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float val = acc[i][j] + (bias ? bias[gn] : 0.f);
      if (GELU) val = gelu_tanh(val);
      C[(long long)gm * N + gn] = val;
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

cudaError_t gemm(const float* A, const float* B, const float* bias, float* C, int M, int N, int K,
                 bool gelu, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (gelu)
    gemm_kernel<true><<<grid, kGemmThreads, 0, st>>>(A, B, bias, C, M, N, K);
  else
    gemm_kernel<false><<<grid, kGemmThreads, 0, st>>>(A, B, bias, C, M, N, K);
  return cudaGetLastError();
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
  const int M = B * H * W, hd = C / heads;
  *launched = 0;
  cudaError_t e = gemm(x, wqkv, bqkv, qkv, M, 3 * C, C, false, st);
  if (e != cudaSuccess) return e;
  ++*launched;
  switch (hd) {
    case 8: e = attention<8>(qkv, bias, scale, o, B, H, W, C, ws, nw, st); break;
    case 16: e = attention<16>(qkv, bias, scale, o, B, H, W, C, ws, nw, st); break;
    case 32: e = attention<32>(qkv, bias, scale, o, B, H, W, C, ws, nw, st); break;
    case 64: e = attention<64>(qkv, bias, scale, o, B, H, W, C, ws, nw, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  ++*launched;
  if ((e = gemm(o, wp, bp, t, M, C, C, false, st)) != cudaSuccess) return e;
  ++*launched;
  if ((e = cond_ln(x, t, ln1w, ln1b, dp, 0, x2, M, C, H * W, eps, st)) != cudaSuccess) return e;
  ++*launched;
  if ((e = gemm(x2, w1, b1, hid, M, F, C, true, st)) != cudaSuccess) return e;
  ++*launched;
  if ((e = gemm(hid, w2, b2, t, M, C, F, false, st)) != cudaSuccess) return e;
  ++*launched;
  if ((e = cond_ln(x2, t, ln2w, ln2b, dp, 1, y, M, C, H * W, eps, st)) != cudaSuccess) return e;
  ++*launched;
  return cudaSuccess;
}

}  // extern "C"
