// Hand-written window attention forward for Hopper (sm_90a): K4.
//
// Replaces the Pallas TPU kernel
//   pregen_pde_tpu/ops/window_attention.py::window_attention (forward,
//   `_fwd_kernel`, pallas_call in `_forward`)
// which computes, per (row, head) of q, k, v (nb, h, n, hd):
//   out = softmax(q k^T + bias[row % nw, head]) v
// q and k arrive cosine-normalised and q pre-multiplied by the per-head
// logit scale (the caller does that, as in the JAX package), so the kernel
// computes plain q.k^T plus the additive (nw, h, n, n) bias (16 sigmoid(CPB)
// plus the -100 shift mask). Window w of image b is row b*nw + w.
//
// Design. One block per (row, head); the row's k and v tiles (n x hd,
// n <= 256, hd <= 64) sit in shared memory (2 n hd 4 bytes: 64 KB at
// n = 256, hd = 32), one thread per query row keeps q and its output in
// registers and walks the keys with an online float32 softmax
// (window_softmax.cuh), so the n x n logit tile is never stored. The bias
// row is read once per query through the read-only cache.
//
// What bounds it on the H100: the 4 n^2 hd FLOP per (row, head) on the
// float32 CUDA cores (scOT-B stage 0 at batch 16: 1.6 GFLOP, 24 us at the
// 67 TFLOP/s peak, against 28 MB of q/k/v/out/bias traffic, 8 us at
// 3.35 TB/s). One thread per row issues a dependent FMA chain over hd and a
// serial walk over n keys: a simple first form, latency bound. A later version
// can split keys across a warp, use mma.sync on tensor cores, or batch
// several heads per block.
//
// Backward (replaces `_bwd_kernel`, pallas_call in `_vjp_bwd`):
// attention_bwd.cuh's three launches (rows: dq and the score gradient ds
// into a float32 (nb, h, n, n) scratch; cols: dk and dv; the bias gradient
// as a fixed-order sum over the images of each window slot). It bounds like
// the forward: about 2.5x its FLOP (the logits twice, dp, dq, dk, dv) on the
// float32 CUDA cores, plus the scratch's round trip (50 MB at scOT-B stage 0,
// B = 16), which stays mostly in L2 only at the smaller stages.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; the entry points return cudaGetLastError().

#include <cuda_runtime.h>

#include "attention_bwd.cuh"
#include "window_softmax.cuh"

namespace {

template <int HD>
__global__ void window_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ bias, float* __restrict__ out,
                                        int h, int n, int nw) {
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
    qr[4 * d4] = t.x;
    qr[4 * d4 + 1] = t.y;
    qr[4 * d4 + 2] = t.z;
    qr[4 * d4 + 3] = t.w;
  }
  const float* brow = bias + (((long long)(row % nw) * h + head) * n + i) * n;
  window_softmax_row<HD>(qr, 1.f, ks, vs, brow, n, acc);
  float4* o4 = reinterpret_cast<float4*>(out + base + (long long)i * HD);
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4)
    o4[d4] = make_float4(acc[4 * d4], acc[4 * d4 + 1], acc[4 * d4 + 2], acc[4 * d4 + 3]);
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, float* out,
                   int nb, int h, int n, int nw, cudaStream_t st) {
  const int smem = 2 * n * HD * (int)sizeof(float);
  cudaError_t e = allow_smem(window_attention_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  const int threads = (n + 31) / 32 * 32;
  window_attention_kernel<HD><<<dim3(nb, h), threads, smem, st>>>(q, k, v, bias, out, h, n, nw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: (nb, h, n, hd) float32, contiguous; bias: (nw, h, n, n).
// hd in {8, 16, 32, 64}, n <= 1024, nb % nw == 0 (checked by the wrapper).
int window_attention_fwd(const float* q, const float* k, const float* v, const float* bias,
                         float* out, int nb, int h, int n, int hd, int nw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(q, k, v, bias, out, nb, h, n, nw, st);
    case 16: return launch<16>(q, k, v, bias, out, nb, h, n, nw, st);
    case 32: return launch<32>(q, k, v, bias, out, nb, h, n, nw, st);
    case 64: return launch<64>(q, k, v, bias, out, nb, h, n, nw, st);
    default: return cudaErrorInvalidValue;
  }
}

// Gradients of window_attention_fwd: q, k, v, o (the forward's output), do
// (nb, h, n, hd); bias (nw, h, n, n) -> dq, dk, dv (nb, h, n, hd), dbias
// (nw, h, n, n) summed over images. Scratch: ds (nb, h, n, n), stats
// (nb, h, n, 2). `launched` reports the kernels enqueued (3).
int window_attention_bwd(const float* q, const float* k, const float* v, const float* bias,
                         const float* o, const float* dout, float* dq, float* dk, float* dv,
                         float* dbias, float* ds, float* stats, int nb, int h, int n, int hd,
                         int nw, void* stream, int* launched) {
  *launched = 0;
  const AttnGeom g{h, n, 0, 0, 1};
  return attention_bwd<false>(hd, q, k, v, hd, o, dout, hd, bias, nw, nullptr, dq, dk, dv, ds,
                              reinterpret_cast<float2*>(stats), nullptr, dbias, nullptr, nb, g,
                              static_cast<cudaStream_t>(stream), launched);
}

}  // extern "C"
