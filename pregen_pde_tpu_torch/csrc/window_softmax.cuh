// One query row of window attention, shared by K3 (swin_block.cu) and K4
// (window_attention.cu):
//   out = softmax_j(scale * q.k_j + bias_j) . v_j,   j < n
// with the row's keys and values in shared memory (n x HD, row-major) and
// q in registers. Online softmax in float32 (a running max and sum,
// rescaled when the max grows), so the n-wide logit row is never stored.
// expf, not __expf: the bars against the plain version are ~1e-5.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

template <int HD>
__device__ __forceinline__ void window_softmax_row(const float (&q)[HD], float scale,
                                                   const float* __restrict__ ks,
                                                   const float* __restrict__ vs,
                                                   const float* __restrict__ brow, int n,
                                                   float (&acc)[HD]) {
  float m = -INFINITY, l = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float4* kj = reinterpret_cast<const float4*>(ks + j * HD);
    float s = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = kj[d4];
      s += q[4 * d4] * kk.x;
      s += q[4 * d4 + 1] * kk.y;
      s += q[4 * d4 + 2] * kk.z;
      s += q[4 * d4 + 3] * kk.w;
    }
    s = s * scale + __ldg(brow + j);
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
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] *= inv;
}

// Dynamic shared memory above 48 KB has to be opted into, once per
// template instance.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
