// Backward of window attention per (window, head), shared by K4's backward
// (window_attention.cu) and the attention step of K3's backward
// (swin_block.cu). With s_ij = c q_i.k_j + bias_ij, p = softmax_j(s),
// o_i = sum_j p_ij v_j and the output gradient do:
//   dv_j  = sum_i p_ij do_i
//   dp_ij = do_i . v_j
//   ds_ij = p_ij (dp_ij - D_i),  D_i = sum_j p_ij dp_ij = do_i . o_i
//   dq_i  = c sum_j ds_ij k_j,   dk_j = c sum_i ds_ij q_i
//   dbias[w] = sum over the windows of slot w of ds,  dc = sum ds_ij (q_i.k_j)
// K4 (!SWIN): q, k arrive normalised and scaled (c = 1), rows of the
// (nb, h, n, hd) arrays. K3 (SWIN): raw q, k, v from the qkv projection of
// the token grid (B, H, W), cosine-normalised here (x / (|x| + 1e-6)) with
// the per-head logit scale c, and dq, dk taken back through the
// normalisation with the JAX kernel's guard max(|x|, 1e-30).
//
// Design. dq reduces over keys but dk and dv over queries, so one thread
// per query row cannot write dk, dv without atomics. Two launches:
//   rows: one block per (window, head), one thread per query row, k and v
//         in shared memory; the row's max and sum (written as stats), then
//         p, dp and ds per key, dq, and ds into a float32 (windows, h, n, n)
//         scratch (and, for K3, the row's share of dc, summed per block);
//   cols: one block per (window, head), one thread per key row, q and do
//         in shared memory; p recomputed from the stats, dk and dv.
// Then dbias sums the scratch over the windows of each slot in a fixed
// order (deterministic, no atomics), and for K3 dc over the windows.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct AttnGeom {
  int h, n;      // heads, tokens per window
  int H, W, ws;  // SWIN: the token grid and the window side
};

// Index of token t of window `row`: K4, the row of the (nb, h, n) layout;
// K3, the token of the (B, H, W) grid (window row = b nwin + w).
template <bool SWIN>
__device__ __forceinline__ long long attn_token(const AttnGeom& g, int row, int head, int t) {
  if (!SWIN) return ((long long)row * g.h + head) * g.n + t;
  const int nww = g.W / g.ws, nwin = (g.H / g.ws) * nww;
  const int b = row / nwin, w = row % nwin;
  const int r = (w / nww) * g.ws + t / g.ws, c = (w % nww) * g.ws + t % g.ws;
  return ((long long)b * g.H + r) * g.W + c;
}

template <int HD>
__device__ __forceinline__ float dot_smem(const float (&a)[HD], const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 x = b4[d4];
    s += a[4 * d4] * x.x;
    s += a[4 * d4 + 1] * x.y;
    s += a[4 * d4 + 2] * x.z;
    s += a[4 * d4 + 3] * x.w;
  }
  return s;
}

template <int HD>
__device__ __forceinline__ void axpy_smem(float (&acc)[HD], float a, const float* __restrict__ b) {
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

// Load a raw row; with NORM scale it to x / (|x| + 1e-6). Returns |x|.
template <int HD, bool NORM>
__device__ __forceinline__ float load_row(const float* __restrict__ src, float (&x)[HD]) {
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    x[d] = src[d];
    ss += x[d] * x[d];
  }
  const float nrm = sqrtf(ss);
  if (NORM) {
    const float inv = 1.f / (nrm + 1e-6f);
#pragma unroll
    for (int d = 0; d < HD; ++d) x[d] *= inv;
  }
  return nrm;
}

// d/dx of x / (|x| + e) applied to dy, written to dst: the JAX kernel's
// dy/(|x|+e) - x (x.dy)/(max(|x|, 1e-30) (|x|+e)^2), x the raw row at src.
template <int HD>
__device__ __forceinline__ void cosine_norm_bwd(const float (&dy)[HD], const float* __restrict__ src,
                                                float nrm, float* __restrict__ dst) {
  float x[HD];
  float xdot = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    x[d] = src[d];
    xdot += dy[d] * x[d];
  }
  const float e = nrm + 1e-6f;
  const float a = 1.f / e, c = xdot / (fmaxf(nrm, 1e-30f) * e * e);
#pragma unroll
  for (int d = 0; d < HD; ++d) dst[d] = dy[d] * a - x[d] * c;
}

// q, k, v (and dq, dk, dv) rows at base + token * sq (+ head * HD for K3);
// o and do at base + token * so (+ head * HD for K3).
template <int HD, bool SWIN>
__global__ void attn_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v, int sq,
                                     const float* __restrict__ o, const float* __restrict__ dout,
                                     int so, const float* __restrict__ bias, int nw,
                                     const float* __restrict__ scale, float* __restrict__ dq,
                                     float* __restrict__ ds, float2* __restrict__ stats,
                                     float* __restrict__ dsc_part, AttnGeom g) {
  extern __shared__ float4 smem4[];
  const int n = g.n;
  float* ks = reinterpret_cast<float*>(smem4);  // k (normalised for K3)
  float* vs = ks + n * HD;
  float* red = vs + n * HD;  // one float per warp
  const int row = blockIdx.x, head = blockIdx.y, t = threadIdx.x;
  const int hoff = SWIN ? head * HD : 0;
  const float c = SWIN ? scale[head] : 1.f;
  if (t < n) {
    const long long tok = attn_token<SWIN>(g, row, head, t);
    float kk[HD];
    load_row<HD, SWIN>(k + tok * sq + hoff, kk);
    const float* vr = v + tok * sq + hoff;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      ks[t * HD + d] = kk[d];
      vs[t * HD + d] = vr[d];
    }
  }
  __syncthreads();
  float dsc = 0.f;
  if (t < n) {
    const long long tok = attn_token<SWIN>(g, row, head, t);
    float qn[HD], dov[HD], acc[HD];
    const float qnrm = load_row<HD, SWIN>(q + tok * sq + hoff, qn);
    const float* orow = o + tok * so + hoff;
    const float* drow = dout + tok * so + hoff;
    float D = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dov[d] = drow[d];
      D += dov[d] * orow[d];
      acc[d] = 0.f;
    }
    const float* brow = bias + (((long long)(row % nw) * g.h + head) * n + t) * n;
    float m = -INFINITY, l = 0.f;
    for (int j = 0; j < n; ++j) {
      const float s = c * dot_smem<HD>(qn, ks + j * HD) + __ldg(brow + j);
      if (s > m) {
        l *= expf(m - s);
        m = s;
      }
      l += expf(s - m);
    }
    const float inv = 1.f / l;
    float* dsr = ds + (((long long)row * g.h + head) * n + t) * n;
    for (int j = 0; j < n; ++j) {
      const float spre = dot_smem<HD>(qn, ks + j * HD);
      const float p = expf(c * spre + __ldg(brow + j) - m) * inv;
      const float dsv = p * (dot_smem<HD>(dov, vs + j * HD) - D);
      dsr[j] = dsv;
      dsc += dsv * spre;
      axpy_smem<HD>(acc, dsv, ks + j * HD);
    }
    float* dqr = dq + tok * sq + hoff;
    if (SWIN) {
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= c;
      cosine_norm_bwd<HD>(acc, q + tok * sq + hoff, qnrm, dqr);
    } else {
#pragma unroll
      for (int d = 0; d < HD; ++d) dqr[d] = acc[d];
    }
    stats[((long long)row * g.h + head) * n + t] = make_float2(m, inv);
  }
  if (SWIN) {  // this (window, head)'s share of dc, summed in a fixed order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dsc += __shfl_xor_sync(0xffffffffu, dsc, off);
    if (t % 32 == 0) red[t / 32] = dsc;
    __syncthreads();
    if (t == 0) {
      float s = 0.f;
      for (int w = 0; w < (int)blockDim.x / 32; ++w) s += red[w];
      dsc_part[(long long)row * g.h + head] = s;
    }
  }
}

template <int HD, bool SWIN>
__global__ void attn_bwd_cols_kernel(const float* __restrict__ q, const float* __restrict__ k, int sq,
                                     const float* __restrict__ dout, int so,
                                     const float* __restrict__ bias, int nw,
                                     const float* __restrict__ scale, const float* __restrict__ ds,
                                     const float2* __restrict__ stats, float* __restrict__ dk,
                                     float* __restrict__ dv, AttnGeom g) {
  extern __shared__ float4 smem4[];
  const int n = g.n;
  float* qs = reinterpret_cast<float*>(smem4);  // q (normalised for K3)
  float* dos = qs + n * HD;
  float2* st = reinterpret_cast<float2*>(dos + n * HD);
  const int row = blockIdx.x, head = blockIdx.y, t = threadIdx.x;
  const int hoff = SWIN ? head * HD : 0;
  const float c = SWIN ? scale[head] : 1.f;
  const long long blk = (long long)row * g.h + head;
  if (t < n) {
    const long long tok = attn_token<SWIN>(g, row, head, t);
    float qq[HD];
    load_row<HD, SWIN>(q + tok * sq + hoff, qq);
    const float* drow = dout + tok * so + hoff;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qs[t * HD + d] = qq[d];
      dos[t * HD + d] = drow[d];
    }
    st[t] = stats[blk * n + t];
  }
  __syncthreads();
  if (t >= n) return;
  const int j = t;
  const long long tok = attn_token<SWIN>(g, row, head, j);
  float kn[HD], dkn[HD], dvv[HD];
  const float knrm = load_row<HD, SWIN>(k + tok * sq + hoff, kn);
#pragma unroll
  for (int d = 0; d < HD; ++d) dkn[d] = dvv[d] = 0.f;
  const float* bcol = bias + ((long long)(row % nw) * g.h + head) * n * n + j;
  const float* dcol = ds + blk * n * n + j;
  for (int i = 0; i < n; ++i) {
    const float2 mi = st[i];
    const float p = expf(c * dot_smem<HD>(kn, qs + i * HD) + __ldg(bcol + (long long)i * n) - mi.x)
                    * mi.y;
    axpy_smem<HD>(dvv, p, dos + i * HD);
    axpy_smem<HD>(dkn, dcol[(long long)i * n], qs + i * HD);
  }
  float* dkr = dk + tok * sq + hoff;
  float* dvr = dv + tok * sq + hoff;
#pragma unroll
  for (int d = 0; d < HD; ++d) dvr[d] = dvv[d];
  if (SWIN) {
#pragma unroll
    for (int d = 0; d < HD; ++d) dkn[d] *= c;
    cosine_norm_bwd<HD>(dkn, k + tok * sq + hoff, knrm, dkr);
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) dkr[d] = dkn[d];
  }
}

// dbias[w][e] = sum over rows r = w, w + nw, ... < R of ds[r][e]; e < per.
__global__ void attn_dbias_kernel(const float* __restrict__ ds, float* __restrict__ dbias, int R,
                                  int nw, long long per) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nw * per) return;
  const int w = (int)(idx / per);
  const long long e = idx % per;
  float s = 0.f;
  for (int r = w; r < R; r += nw) s += ds[(long long)r * per + e];
  dbias[idx] = s;
}

// dscale[h] = sum over rows of the per-(row, head) shares.
__global__ void attn_dscale_kernel(const float* __restrict__ part, float* __restrict__ dscale, int R,
                                   int h) {
  const int head = blockIdx.x * blockDim.x + threadIdx.x;
  if (head >= h) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += part[(long long)r * h + head];
  dscale[head] = s;
}

template <typename Kernel>
inline cudaError_t attn_allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The whole backward over R windows: rows, cols, dbias (and dscale for K3).
// dq/dk/dv may alias one qkv-gradient array (K3) with stride sq.
template <int HD, bool SWIN>
cudaError_t attention_bwd_launch(const float* q, const float* k, const float* v, int sq,
                                 const float* o, const float* dout, int so, const float* bias,
                                 int nw, const float* scale, float* dq, float* dk, float* dv,
                                 float* ds, float2* stats, float* dsc_part, float* dbias,
                                 float* dscale, int R, AttnGeom g, cudaStream_t st, int* launched) {
  const int n = g.n;
  const int threads = (n + 31) / 32 * 32;
  const dim3 grid(R, g.h);
  const int smem_rows = 2 * n * HD * (int)sizeof(float) + 32 * (int)sizeof(float);
  cudaError_t e = attn_allow_smem(attn_bwd_rows_kernel<HD, SWIN>, smem_rows);
  if (e != cudaSuccess) return e;
  attn_bwd_rows_kernel<HD, SWIN><<<grid, threads, smem_rows, st>>>(
      q, k, v, sq, o, dout, so, bias, nw, scale, dq, ds, stats, dsc_part, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  const int smem_cols = 2 * n * HD * (int)sizeof(float) + n * (int)sizeof(float2);
  if ((e = attn_allow_smem(attn_bwd_cols_kernel<HD, SWIN>, smem_cols)) != cudaSuccess) return e;
  attn_bwd_cols_kernel<HD, SWIN><<<grid, threads, smem_cols, st>>>(
      q, k, sq, dout, so, bias, nw, scale, ds, stats, dk, dv, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  const long long per = (long long)g.h * n * n, total = nw * per;
  attn_dbias_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(ds, dbias, R, nw, per);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ++*launched;
  if (SWIN) {
    attn_dscale_kernel<<<1, 32 * ((g.h + 31) / 32), 0, st>>>(dsc_part, dscale, R, g.h);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ++*launched;
  }
  return cudaSuccess;
}

template <bool SWIN>
cudaError_t attention_bwd(int hd, const float* q, const float* k, const float* v, int sq,
                          const float* o, const float* dout, int so, const float* bias, int nw,
                          const float* scale, float* dq, float* dk, float* dv, float* ds,
                          float2* stats, float* dsc_part, float* dbias, float* dscale, int R,
                          AttnGeom g, cudaStream_t st, int* launched) {
  switch (hd) {
#define PREGEN_ATTN_BWD_CASE(HD)                                                                 \
  case HD:                                                                                       \
    return attention_bwd_launch<HD, SWIN>(q, k, v, sq, o, dout, so, bias, nw, scale, dq, dk, dv, \
                                          ds, stats, dsc_part, dbias, dscale, R, g, st, launched);
    PREGEN_ATTN_BWD_CASE(8)
    PREGEN_ATTN_BWD_CASE(16)
    PREGEN_ATTN_BWD_CASE(32)
    PREGEN_ATTN_BWD_CASE(64)
#undef PREGEN_ATTN_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
