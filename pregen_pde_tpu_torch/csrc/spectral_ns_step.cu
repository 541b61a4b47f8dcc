// Hand-written CN+AB2 pseudo-spectral vorticity stepper for Hopper (sm_90a),
// in two routes: for n in {128, 256} the cluster-resident kernel
// (sns_cluster_kernel, entry point sns_traj: one launch a call, each image's
// state in a thread-block cluster's shared memory for all its steps; its
// design note is with it, below the chain); for n in {512, 1024} the chain
// of three launches a step described next. At 512^2 the state (w_hat and
// the history, 4 MB of complex64; 2.1 MB as half spectra) and two packed
// physical planes (4 MB) exceed what a cluster of 16 blocks holds
// (16 x 227 KB = 3.6 MB), so those grids stay on the chain.
//
// Replaces the Pallas TPU kernel
//   pregen_pde_tpu/solvers/spectral_ns_pallas.py::build_batched_traj
// (kernel body `make_kernel`), whose meaning is
//   NSVorticitySolver._build_traj_packed(scheme="ab2").
//
// State per image: w_hat (n, n) complex in natural fft2 order, and the AB2
// history (the previous step's explicit right-hand side). One AB2 step is
//   psi = w_hat / |k|^2
//   u + i v     = ifft2((kx + i ky) psi)        (packed pair, Hermitian packs)
//   wx + i wy   = ifft2((-ky + i kx) w_hat)
//   r           = -dealias * fft2(u wx + v wy) + F_hat - drag w_hat
//   w_hat'      = (w_hat vn + dt (1.5 r - 0.5 r_prev)) vd,  r_prev' = r
// with vn = 1 - dt/2 nu k^2, vd = 1 / (1 + dt/2 nu k^2), k^2 the TRUE |k|^2
// (Nyquist included) and nu per image. kx, ky are the Nyquist-zeroed
// derivative wavenumbers.
//
// What bounds it on the H100. A step needs ~12 full-plane passes of
// complex64 (201 MB at 256^2, batch 32), so memory passes are the floor the
// design works against; measured on an H100 (PERF.md) a step moves them at
// ~0.7 TB/s, a fifth of HBM bandwidth, so the present bound is inside the SM:
// the radix-2 butterflies in shared memory with a barrier per stage, and at
// small batch too few blocks (B*n/L) to fill 132 SMs. The TPU kernel keeps one
// image's state resident in VMEM for the whole loop; at 256^2 the state plus
// history is 1 MB of complex64, far above an SM's 227 KB of shared memory, so
// here each 2-D transform is split into a row pass and a column pass, each
// holding whole lines (n <= 1024 complex) in shared memory and running a
// radix-2 FFT there. The step's algebra is fused into the passes' prologues
// and epilogues so a step is three launches and about 12 full-plane passes
// of complex64 (instead of ~30 for unfused FFT calls plus elementwise ops):
//   1. row pass, inverse:  prologue builds both packs from w_hat -> T0, T1
//   2. column pass:        inverse of T0, T1; advection product; forward
//                          column FFT of the product -> A
//   3. row pass, forward:  epilogue applies dealias, -adv, forcing, drag and
//                          the CN+AB2 update with the per-image nu; writes
//                          w_hat and the history in place.
// Snapshots reuse the same passes: vorticity = one inverse transform keeping
// the real part; fields = velocity pack + two derivative packs, rhs_p =
// 2(u_x v_y - u_y v_x), forward transform, p_hat = -R_hat / |k|^2, inverse.
//
// All arithmetic is float32 on CUDA cores; twiddles are built in float64 on
// the host. Only n in {128, 256, 512, 1024} (powers of two) are handled.
// Kernels launch on the caller's stream, never synchronise and allocate
// nothing; every entry point returns cudaGetLastError(), and the stepper's
// entry points also report how many kernels they launched (`launched`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Consts {
  int B, n, logn, L;          // batch, grid, log2(n), lines per block
  const float* kxd;           // (n) derivative wavenumbers, Nyquist zeroed
  const float* k2v;           // (n) true k^2 per axis
  const float* de;            // (n) 2/3-rule mask per axis (0/1)
  const float2* tw;           // (n/2) exp(-2 pi i j / n)
};

enum RowMode {
  ROW_FWD_REAL = 0,   // real input -> forward row FFT -> out
  ROW_FWD = 1,        // complex -> forward -> out
  ROW_INV = 2,        // complex * scale -> inverse -> out
  ROW_STEP_INV = 3,   // W -> packs P1, P2 (scaled) -> inverse -> T0, T1
  ROW_FIELDS_INV = 4, // W -> packs P1, P3, P4 (scaled) -> inverse -> T0, T1, T2
  ROW_UPDATE = 5,     // A -> forward -> CN+AB2 update of W, history
  ROW_BOOT = 6,       // A -> forward -> history = rhs (no update)
  ROW_PRESSURE = 7,   // A -> forward -> * (-1/|k|^2) * scale -> inverse -> T0
};

enum ColMode {
  COL_FWD = 0,        // complex -> forward -> out (in place allowed)
  COL_INV = 1,        // complex * scale -> inverse -> out
  COL_STEP = 2,       // T0, T1 -> inverse; adv = u wx + v wy; forward -> A
  COL_REAL_OUT = 3,   // T0 -> inverse -> real part to a strided float output
  COL_FIELDS = 4,     // T0, T1, T2 -> inverse; u, v out; rhs_p forward -> A
};

struct Bufs {
  float2* W;          // (B, n, n) state
  float2* Np;         // (B, n, n) AB2 history
  float2* T0;         // (B, n, n) scratch planes
  float2* T1;
  float2* T2;
  float2* A;
  const float2* F;    // (n, n) forcing spectrum, or null
  const float* nu;    // (B)
  float dt, drag;
  int dealias;
};

// strided real output: out[b * img_stride + (y * n + x) * elem_stride + c]
struct RealOut {
  float* ptr;
  long long img_stride;
  int elem_stride;
  int chan;           // channel of the first plane written
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int bitrev(int i, int logn) {
  return (int)(__brev((unsigned)i) >> (32 - logn));
}

// In-place radix-2 decimation-in-time FFT of `nlines` lines of length n held
// in shared memory at stride `stride`, input in bit-reversed order, output
// natural. Unnormalised; `inverse` uses conjugate twiddles.
__device__ void fft_lines(float2* s, int nlines, int stride, const Consts& c,
                          bool inverse) {
  const int n = c.n;
  const int nb = n >> 1;
  const int total = nlines * nb;
  __syncthreads();
  for (int lg = 1; lg <= c.logn; ++lg) {
    const int half = 1 << (lg - 1);
    const int twshift = c.logn - lg;  // twiddle index = pos * (n / len)
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int line = t >> (c.logn - 1);
      const int j = t & (nb - 1);
      const int pos = j & (half - 1);
      const int i0 = ((j >> (lg - 1)) << lg) + pos;
      const int i1 = i0 + half;
      float2 w = __ldg(&c.tw[pos << twshift]);
      if (inverse) w.y = -w.y;
      float2* Ls = s + line * stride;
      const float2 a = Ls[i0];
      const float2 b = cmul(w, Ls[i1]);
      Ls[i0] = make_float2(a.x + b.x, a.y + b.y);
      Ls[i1] = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float inv_k2(const Consts& c, int y, int x) {
  const float k2 = c.k2v[y] + c.k2v[x];
  return k2 > 0.f ? 1.f / k2 : 0.f;
}

// ---------------------------------------------------------------------------
// row pass: a block holds L consecutive rows (of the flattened B*n rows)
// ---------------------------------------------------------------------------

__global__ void row_kernel(Consts c, Bufs b, int mode, const void* in,
                           float2* out, float scale) {
  extern __shared__ float2 smem[];
  const int n = c.n;
  const int stride = n + 1;
  const int L = c.L;
  const long long row0 = (long long)blockIdx.x * L;
  const int nplanes = (mode == ROW_STEP_INV) ? 2 : (mode == ROW_FIELDS_INV ? 3 : 1);
  float2* s0 = smem;
  float2* s1 = smem + L * stride;
  float2* s2 = smem + 2 * L * stride;

  // ---- load + prologue (into bit-reversed positions) ----
  for (int t = threadIdx.x; t < L * n; t += blockDim.x) {
    const int line = t / n;
    const int x = t - line * n;
    const long long row = row0 + line;
    const int y = (int)(row % n);
    const long long g = row * n + x;
    const int d = line * stride + bitrev(x, c.logn);
    if (mode == ROW_FWD_REAL) {
      s0[d] = make_float2(static_cast<const float*>(in)[g], 0.f);
    } else if (mode == ROW_FWD || mode == ROW_INV) {
      const float2 v = static_cast<const float2*>(in)[g];
      s0[d] = make_float2(v.x * scale, v.y * scale);
    } else if (mode == ROW_STEP_INV || mode == ROW_FIELDS_INV) {
      const float2 w = b.W[g];
      const float kx = c.kxd[x], ky = c.kxd[y];
      const float ik = inv_k2(c, y, x) * scale;
      const float pr = w.x * ik, pi = w.y * ik;               // psi (scaled)
      s0[d] = make_float2(kx * pr - ky * pi, kx * pi + ky * pr);  // (kx+i ky) psi
      if (mode == ROW_STEP_INV) {
        // (-ky + i kx) w_hat, scaled
        s1[d] = make_float2((-ky * w.x - kx * w.y) * scale,
                            (kx * w.x - ky * w.y) * scale);
      } else {
        // (kx + i ky)(-ky psi) and (kx + i ky)(kx psi)
        const float tr = -ky * pr, ti = -ky * pi;
        s1[d] = make_float2(kx * tr - ky * ti, kx * ti + ky * tr);
        const float qr = kx * pr, qi = kx * pi;
        s2[d] = make_float2(kx * qr - ky * qi, kx * qi + ky * qr);
      }
    } else {  // ROW_UPDATE, ROW_BOOT, ROW_PRESSURE read the column-pass output A
      s0[d] = b.A[g];
    }
  }

  const bool inverse = (mode == ROW_INV || mode == ROW_STEP_INV ||
                        mode == ROW_FIELDS_INV);
  fft_lines(smem, nplanes * L, stride, c, inverse);

  // ---- epilogue (natural order) ----
  if (mode == ROW_PRESSURE) {
    // p_hat = -R_hat / |k|^2, then the inverse row FFT in shared memory
    for (int t = threadIdx.x; t < L * n; t += blockDim.x) {
      const int line = t / n;
      const int x = t - line * n;
      const int y = (int)((row0 + line) % n);
      const float f = -inv_k2(c, y, x) * scale;
      const float2 v = s0[line * stride + x];
      s1[line * stride + bitrev(x, c.logn)] = make_float2(v.x * f, v.y * f);
    }
    fft_lines(s1, L, stride, c, true);
    for (int t = threadIdx.x; t < L * n; t += blockDim.x) {
      const int line = t / n;
      const int x = t - line * n;
      b.T0[(row0 + line) * n + x] = s1[line * stride + x];
    }
    return;
  }
  for (int t = threadIdx.x; t < L * n; t += blockDim.x) {
    const int line = t / n;
    const int x = t - line * n;
    const long long row = row0 + line;
    const long long g = row * n + x;
    const int sidx = line * stride + x;
    if (mode == ROW_UPDATE || mode == ROW_BOOT) {
      const int img = (int)(row / n);
      const int y = (int)(row % n);
      float2 a = s0[sidx];
      if (b.dealias) {
        const float m = c.de[y] * c.de[x];
        a.x *= m;
        a.y *= m;
      }
      const float2 w = b.W[g];
      float rr = -a.x, ri = -a.y;
      if (b.F != nullptr) {
        const float2 f = b.F[(long long)y * n + x];
        rr += f.x;
        ri += f.y;
      }
      if (b.drag != 0.f) {
        rr -= b.drag * w.x;
        ri -= b.drag * w.y;
      }
      if (mode == ROW_UPDATE) {
        const float2 np = b.Np[g];
        const float nuk2 = b.nu[img] * (c.k2v[y] + c.k2v[x]);
        const float hdt = 0.5f * b.dt;
        const float vn = 1.f - hdt * nuk2;
        const float vd = 1.f / (1.f + hdt * nuk2);
        b.W[g] = make_float2((w.x * vn + b.dt * (1.5f * rr - 0.5f * np.x)) * vd,
                             (w.y * vn + b.dt * (1.5f * ri - 0.5f * np.y)) * vd);
      }
      b.Np[g] = make_float2(rr, ri);
    } else if (mode == ROW_STEP_INV) {
      b.T0[g] = s0[sidx];
      b.T1[g] = s1[sidx];
    } else if (mode == ROW_FIELDS_INV) {
      b.T0[g] = s0[sidx];
      b.T1[g] = s1[sidx];
      b.T2[g] = s2[sidx];
    } else {
      out[g] = s0[sidx];
    }
  }
}

// ---------------------------------------------------------------------------
// column pass: a block holds L consecutive columns of one image
// ---------------------------------------------------------------------------

__global__ void col_kernel(Consts c, Bufs b, int mode, const float2* in,
                           float2* out, float scale, RealOut ro) {
  extern __shared__ float2 smem[];
  const int n = c.n;
  const int stride = n + 1;
  const int L = c.L;
  const int tiles = n / L;
  const int img = blockIdx.x / tiles;
  const int x0 = (blockIdx.x - img * tiles) * L;
  const long long base = (long long)img * n * n;
  const int nplanes = (mode == COL_STEP) ? 2 : (mode == COL_FIELDS ? 3 : 1);
  float2* s0 = smem;
  float2* s1 = smem + L * stride;
  float2* s2 = smem + 2 * L * stride;

  const float2* src0 = (mode == COL_FWD || mode == COL_INV) ? in : b.T0;
  for (int t = threadIdx.x; t < L * n; t += blockDim.x) {
    const int y = t / L;
    const int cc = t - y * L;
    const long long g = base + (long long)y * n + x0 + cc;
    const int d = cc * stride + bitrev(y, c.logn);
    float2 v = src0[g];
    s0[d] = make_float2(v.x * scale, v.y * scale);
    if (nplanes > 1) s1[d] = b.T1[g];
    if (nplanes > 2) s2[d] = b.T2[g];
  }
  fft_lines(smem, nplanes * L, stride, c, mode != COL_FWD);

  if (mode == COL_FWD || mode == COL_INV) {
    for (int t = threadIdx.x; t < L * n; t += blockDim.x) {
      const int y = t / L;
      const int cc = t - y * L;
      out[base + (long long)y * n + x0 + cc] = s0[cc * stride + y];
    }
    return;
  }
  if (mode == COL_REAL_OUT) {
    for (int t = threadIdx.x; t < L * n; t += blockDim.x) {
      const int y = t / L;
      const int cc = t - y * L;
      ro.ptr[img * ro.img_stride +
             ((long long)y * n + x0 + cc) * ro.elem_stride + ro.chan] =
          s0[cc * stride + y].x;
    }
    return;
  }
  // COL_STEP / COL_FIELDS: a real product per point, computed in place in the
  // last plane (natural order), then copied bit-reversed into plane 0 for the
  // forward column FFT.
  float2* sp = (mode == COL_STEP) ? s1 : s2;
  for (int t = threadIdx.x; t < L * n; t += blockDim.x) {
    const int y = t / L;
    const int cc = t - y * L;
    const int i = cc * stride + y;
    if (mode == COL_STEP) {
      const float2 uv = s0[i], wg = s1[i];
      s1[i] = make_float2(uv.x * wg.x + uv.y * wg.y, 0.f);
    } else {
      const float2 uv = s0[i], du = s1[i], dv = s2[i];
      const long long o = img * ro.img_stride +
                          ((long long)y * n + x0 + cc) * ro.elem_stride + ro.chan;
      ro.ptr[o] = uv.x;
      ro.ptr[o + 1] = uv.y;
      // du = u_x + i u_y, dv = v_x + i v_y
      s2[i] = make_float2(2.f * (du.x * dv.y - du.y * dv.x), 0.f);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L * n; t += blockDim.x) {
    const int y = t / L;
    const int cc = t - y * L;
    s0[cc * stride + bitrev(y, c.logn)] = sp[cc * stride + y];
  }
  fft_lines(s0, L, stride, c, false);
  for (int t = threadIdx.x; t < L * n; t += blockDim.x) {
    const int y = t / L;
    const int cc = t - y * L;
    b.A[base + (long long)y * n + x0 + cc] = s0[cc * stride + y];
  }
}

constexpr int kThreads = 256;

size_t smem_bytes(const Consts& c, int nplanes) {
  return (size_t)nplanes * c.L * (c.n + 1) * sizeof(float2);
}

cudaError_t ensure_smem(size_t bytes) {
  static size_t row_set = 0, col_set = 0;
  cudaError_t e = cudaSuccess;
  if (bytes > row_set) {
    e = cudaFuncSetAttribute(row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    row_set = bytes;
  }
  if (bytes > col_set) {
    e = cudaFuncSetAttribute(col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    col_set = bytes;
  }
  return e;
}

// launch_row / launch_col enqueue one kernel and return 1 (the launch count)
int launch_row(const Consts& c, const Bufs& b, int mode, const void* in, float2* out,
               float scale, cudaStream_t st) {
  // shared-memory planes: the packs, or the pressure pass's second buffer
  const int np = (mode == ROW_FIELDS_INV) ? 3
               : (mode == ROW_STEP_INV || mode == ROW_PRESSURE) ? 2 : 1;
  const int blocks = c.B * c.n / c.L;
  row_kernel<<<blocks, kThreads, smem_bytes(c, np), st>>>(c, b, mode, in, out, scale);
  return 1;
}

int launch_col(const Consts& c, const Bufs& b, int mode, const float2* in, float2* out,
               float scale, RealOut ro, cudaStream_t st) {
  const int np = (mode == COL_STEP) ? 2 : (mode == COL_FIELDS ? 3 : 1);
  const int blocks = c.B * (c.n / c.L);
  col_kernel<<<blocks, kThreads, smem_bytes(c, np), st>>>(c, b, mode, in, out, scale, ro);
  return 1;
}

int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

Consts make_consts(int B, int n, const float* kxd, const float* k2v, const float* de,
                   const void* tw) {
  Consts c;
  c.B = B;
  c.n = n;
  c.logn = ilog2(n);
  c.L = n >= 1024 ? 4 : (n >= 512 ? 8 : 16);
  c.kxd = kxd;
  c.k2v = k2v;
  c.de = de;
  c.tw = static_cast<const float2*>(tw);
  return c;
}

Bufs make_bufs(void* W, void* Np, void* T0, void* T1, void* T2, void* A,
               const void* F, const float* nu, float dt, float drag, int dealias) {
  Bufs b;
  b.W = static_cast<float2*>(W);
  b.Np = static_cast<float2*>(Np);
  b.T0 = static_cast<float2*>(T0);
  b.T1 = static_cast<float2*>(T1);
  b.T2 = static_cast<float2*>(T2);
  b.A = static_cast<float2*>(A);
  b.F = static_cast<const float2*>(F);
  b.nu = nu;
  b.dt = dt;
  b.drag = drag;
  b.dealias = dealias;
  return b;
}

int one_step(const Consts& c, const Bufs& b, int row_mode, cudaStream_t st) {
  const float inv_n2 = 1.f / ((float)c.n * (float)c.n);
  return launch_row(c, b, ROW_STEP_INV, nullptr, nullptr, inv_n2, st) +
         launch_col(c, b, COL_STEP, nullptr, nullptr, 1.f, RealOut{nullptr, 0, 1, 0}, st) +
         launch_row(c, b, row_mode, nullptr, nullptr, 1.f, st);
}

// The stepper entry points' return: the set-up error `e`, else
// cudaGetLastError(); `launched` gets the number of kernels enqueued, or 0
// after an error.
int finish(cudaError_t e, int n_launched, int* launched) {
  if (e == cudaSuccess) e = cudaGetLastError();
  if (launched != nullptr) *launched = e == cudaSuccess ? n_launched : 0;
  return (int)e;
}

}  // namespace

extern "C" {

// 2-D FFT of B complex64 (n, n) planes: out = fft2(in) or ifft2(in)
// (normalised by 1/n^2). `in` and `out` may alias.
int sns_fft2(const void* in, void* out, int B, int n, int inverse, const void* tw,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Consts c = make_consts(B, n, nullptr, nullptr, nullptr, tw);
  cudaError_t e = ensure_smem(smem_bytes(c, 3));
  if (e != cudaSuccess) return (int)e;
  Bufs b = make_bufs(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, 0.f, 0.f, 0);
  const float s = inverse ? 1.f / (float)n : 1.f;
  launch_row(c, b, inverse ? ROW_INV : ROW_FWD, in, static_cast<float2*>(out), s, st);
  launch_col(c, b, inverse ? COL_INV : COL_FWD, static_cast<float2*>(out),
             static_cast<float2*>(out), s, RealOut{nullptr, 0, 1, 0}, st);
  return (int)cudaGetLastError();
}

// w_hat = fft2(w0) and the AB2 history = rhs(w_hat) (forward-Euler bootstrap).
int sns_init(const float* w0, void* W, void* Np, void* T0, void* T1, void* T2, void* A,
             const void* F, const float* nu, const float* kxd, const float* k2v,
             const float* de, const void* tw, int B, int n, float dt, float drag,
             int dealias, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Consts c = make_consts(B, n, kxd, k2v, de, tw);
  cudaError_t e = ensure_smem(smem_bytes(c, 3));
  if (e != cudaSuccess) return finish(e, 0, launched);
  Bufs b = make_bufs(W, Np, T0, T1, T2, A, F, nu, dt, drag, dealias);
  int k = launch_row(c, b, ROW_FWD_REAL, w0, b.W, 1.f, st);
  k += launch_col(c, b, COL_FWD, b.W, b.W, 1.f, RealOut{nullptr, 0, 1, 0}, st);
  k += one_step(c, b, ROW_BOOT, st);
  return finish(cudaSuccess, k, launched);
}

// `steps` CN+AB2 steps in place on (W, Np).
int sns_advance(void* W, void* Np, void* T0, void* T1, void* T2, void* A, const void* F,
                const float* nu, const float* kxd, const float* k2v, const float* de,
                const void* tw, int B, int n, int steps, float dt, float drag,
                int dealias, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Consts c = make_consts(B, n, kxd, k2v, de, tw);
  cudaError_t e = ensure_smem(smem_bytes(c, 3));
  if (e != cudaSuccess) return finish(e, 0, launched);
  Bufs b = make_bufs(W, Np, T0, T1, T2, A, F, nu, dt, drag, dealias);
  int k = 0;
  for (int i = 0; i < steps; ++i) {
    k += one_step(c, b, ROW_UPDATE, st);
  }
  return finish(cudaSuccess, k, launched);
}

// Snapshot epilogue of the current state into a strided float32 output:
//   fields == 0: out[b*img_stride + (y*n+x)*elem_stride] = Re ifft2(w_hat)
//   fields == 1: channels 0, 1, 2 = u, v, p (elem_stride 3)
int sns_snapshot(void* W, void* T0, void* T1, void* T2, void* A, const float* kxd,
                 const float* k2v, const void* tw, int B, int n, int fields,
                 float* out, long long img_stride, int elem_stride, void* stream,
                 int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Consts c = make_consts(B, n, kxd, k2v, nullptr, tw);
  cudaError_t e = ensure_smem(smem_bytes(c, 3));
  if (e != cudaSuccess) return finish(e, 0, launched);
  Bufs b = make_bufs(W, nullptr, T0, T1, T2, A, nullptr, nullptr, 0.f, 0.f, 0);
  const float inv_n2 = 1.f / ((float)n * (float)n);
  int k = 0;
  if (!fields) {
    k += launch_row(c, b, ROW_INV, b.W, b.T0, inv_n2, st);
    k += launch_col(c, b, COL_REAL_OUT, nullptr, nullptr, 1.f,
                    RealOut{out, img_stride, elem_stride, 0}, st);
  } else {
    k += launch_row(c, b, ROW_FIELDS_INV, nullptr, nullptr, inv_n2, st);
    k += launch_col(c, b, COL_FIELDS, nullptr, nullptr, 1.f,
                    RealOut{out, img_stride, elem_stride, 0}, st);
    k += launch_row(c, b, ROW_PRESSURE, nullptr, nullptr, inv_n2, st);
    k += launch_col(c, b, COL_REAL_OUT, nullptr, nullptr, 1.f,
                    RealOut{out, img_stride, elem_stride, 2}, st);
  }
  return finish(cudaSuccess, k, launched);
}

}  // extern "C"

// ===========================================================================
// The cluster-resident stepper (n in {128, 256}): one launch a call.
//
// An image is held by a cluster of C = n/16 blocks of 256 threads. Block r
// owns the spectral columns kx = 16r .. 16r+15 (w_hat and the AB2 history,
// each a (16, n) slab in shared memory, a line per kx along ky) and, in
// physical space, the rows y = 16r .. 16r+15. A thread group of 16 lanes
// (a half-warp) works on one line: lane t holds the points t + 16m.
//
// A step, with its two cluster barriers (cluster.sync(): arrive.release +
// wait.acquire):
//   1. pack (kx + i ky) psi and (-ky + i kx) w_hat from the slab into
//      registers; inverse FFT along ky (a line a half-warp); write each
//      value into the exchange buffer X1 at the tile of the block that owns
//      its row                                                      | A
//   2. read this block's tile from every peer's X1 (DSMEM) straight into
//      the registers of the x transform; inverse FFT along x; the advection
//      product u w_x + v w_y; forward FFT along x; write into the exchange
//      buffer G at the tile of the block that owns its column        | B
//   3. read this block's tile from every peer's G; forward FFT along ky;
//      dealias, -adv, forcing, drag and the CN+AB2 update with the image's
//      nu, into the slab (w_hat, history).
// X1 and G are separate buffers, so a peer still reading X1 (part 2) is
// never overwritten before barrier B, and a peer reading G (part 3) never
// before the next barrier A: two barriers a step. A snapshot adds its own
// exchanges (vorticity: one; fields: u + i v, then the two derivative packs
// with rhs_p = 2(u_x v_y - u_y v_x) forward, p_hat = -R_hat / |k|^2, and
// p inverse: four) and one barrier after its last read of X1, so that the
// next step's writes to X1 wait for every peer. A last barrier keeps each
// block alive until its peers are done reading it.
//
// The line transforms: n = 16 R (R = C = n/16). Lane t computes an R-point
// DFT of x[t + 16m] in registers and multiplies by W_n^{t k1} (a table
// [k1][t], built in float64 on the host and held in shared memory); the
// values go through the line's scratch (positions t + 16 k1, padded by one
// complex every 16, so no bank is hit twice); lane k1 < R reads Y[j][k1]
// (j < 16) and computes a 16-point DFT, which gives X[k1 + R k2]. Both
// small DFTs are radix-2 in registers with every index known at compile
// time, so no bit-reversal is executed and a transform has two half-warp
// syncs and no block barrier. The spectrum stays in natural order along
// each line; the layout is the transpose (kx-major) of fft2's, so the
// forcing spectrum is handed over transposed (`to_kernel_layout` in the
// wrapper) and the 1-D constants are unchanged.
//
// The exchange tiles: X1[plane][dest block][row y & 15][kx & 15] and
// G[dest block][kx & 15][y & 15], row stride 17 complex: a source lane
// writes a column of a tile (stride 17: 16 banks), a reading half-warp
// takes a row (128 contiguous bytes from the peer).
//
// Shared memory a block (complex64): the twiddles n, the slab's 1/|k|^2
// 8n and the 1-D constants 2n (floats packed), the slab 2 x 16n, the line
// scratch 16 (n + n/16), X1 2 x C x 272, G C x 272: 222.0 KB at 256^2 (one
// block an SM; a non-portable cluster of 16), 111.0 KB at 128^2 (two blocks
// an SM). Per-image nu and step counts are read from device arrays;
// `order` maps the cluster index to the image (the wrapper sorts longest
// first, so the clusters that start last run the shortest trajectories).
// Frames go straight into out[b, f] (vorticity (B, T, n, n) or fields
// (B, T, n, n, 3)); nothing else touches device memory but the forcing
// spectrum, the 1-D constants and w0, read through L2.
//
// What bounds it on the H100: a step is a latency chain of one cluster on
// n/16 SMs (six line transforms a lane, 48 DSMEM reads a lane, two cluster
// barriers), 8 warps an SM. At 256^2, B = 1, a step is ~62k SM cycles
// (~31 us): the packs and inverse y 20%, the X1 reads and inverse x 35%,
// forward x 8%, forward y with its G reads 14%, the update 11%, the two
// barriers 9% (profile_k1 part 4 reads clock64 per phase from a
// -DSNS_PHASE_CLOCKS build; PERF.md section 5). The FLOP bound is
// 3 x 5 n^2 log2 n^2 per image-step at 67 TFLOP/s (0.23 us at 256^2), so
// the kernel runs at a few percent of it; HBM carries only the frames.
// The card holds 7 clusters of 16 at 256^2 and 30 of 8 at 128^2.
// ===========================================================================

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kNotResident = -2;
constexpr int kCThreads = 256;   // 16 lines x 16 lanes
constexpr int kTile = 16 * 17;   // an exchange tile, row stride 17

__device__ __forceinline__ float2 c_add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 c_sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 c_scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// a * exp(-+2 pi i k / 16), k < 8 (compile-time after unrolling); INV takes
// the conjugate twiddle. k = 0 and k = 4 cost no multiply.
template <bool INV>
__device__ __forceinline__ float2 twist16(float2 a, int k) {
  constexpr float c1 = 0.923879532511286756f;  // cos(pi/8)
  constexpr float s1 = 0.382683432365089772f;  // sin(pi/8)
  constexpr float h = 0.707106781186547524f;   // cos(pi/4)
  float c, s;  // exp(-2 pi i k/16) = c - i s
  switch (k) {
    case 0: return a;
    case 4: return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 5: c = -s1; s = c1; break;
    case 6: c = -h; s = h; break;
    default: c = -c1; s = s1; break;  // 7
  }
  if (INV) s = -s;
  // (a.x + i a.y)(c - i s)
  return make_float2(a.x * c + a.y * s, a.y * c - a.x * s);
}

template <int R>
__host__ __device__ constexpr int rev_bits(int i) {
  int r = 0;
  for (int b = 1; b < R; b <<= 1) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

// R-point DFT (R = 8 or 16) of registers, natural order in and out:
// radix-2 decimation in time, the input read in bit-reversed order.
template <int R, bool INV>
__device__ __forceinline__ void dft_regs(float2 (&v)[R]) {
  float2 a[R];
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = v[rev_bits<R>(i)];
#pragma unroll
  for (int len = 2; len <= R; len <<= 1) {
#pragma unroll
    for (int i = 0; i < R; i += len) {
#pragma unroll
      for (int k = 0; k < len / 2; ++k) {
        const float2 x = a[i + k];
        const float2 y = twist16<INV>(a[i + k + len / 2], k * (16 / len));
        a[i + k] = c_add(x, y);
        a[i + k + len / 2] = c_sub(x, y);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = a[i];
}

__device__ __forceinline__ int lpad(int i) { return i + (i >> 4); }

// the value at `p` (this block's shared memory) in block `rank` of the
// cluster: mapa + ld.shared::cluster on the card
__device__ __forceinline__ float2 ld_peer(const cg::cluster_group& cluster, const float2* p,
                                          int rank) {
#ifdef __CUDA_ARCH__
  (void)cluster;
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm("mapa.shared::cluster.u32 %0, %0, %1;" : "+r"(a) : "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
#else
  return *cluster.map_shared_rank(const_cast<float2*>(p), rank);
#endif
}

// One line of n = 16R points, transformed by the 16 lanes of a half-warp.
// In: lane t holds v[m] = x[t + 16m], m < R. Out: lane k1 < R holds
// o[k2] = X[k1 + R k2], k2 < 16 (unnormalised; INV: exp(+2 pi i jk/n)).
// `ls` is the line's scratch (lpad layout), `tw` the twiddle table
// tw[16 k1 + t] = exp(-2 pi i t k1 / n) (lane t reads a contiguous row: no
// bank conflict). Both syncs are the half-warp's (__syncwarp).
template <int N, bool INV>
__device__ __forceinline__ void line_fft(float2 (&v)[N / 16], float2 (&o)[16], float2* ls,
                                         const float2* tw, int t) {
  constexpr int R = N / 16;
  dft_regs<R, INV>(v);
#pragma unroll
  for (int k1 = 0; k1 < R; ++k1) {
    float2 w = tw[16 * k1 + t];
    if (INV) w.y = -w.y;
    ls[lpad(t + 16 * k1)] = k1 == 0 ? v[k1] : cmul(v[k1], w);
  }
  __syncwarp();
  if (t < R) {
#pragma unroll
    for (int j = 0; j < 16; ++j) o[j] = ls[lpad(j + 16 * t)];
    dft_regs<16, INV>(o);
  }
  __syncwarp();
}

}  // namespace

namespace {

struct CArgs {
  int B, S, inc, fields, dealias;
  float dt, drag, inv_n2;
  const float* w0;     // (B, n, n)
  const float* nu;     // (B)
  const int* steps;    // (B) inner steps per snapshot
  const int* order;    // (B) cluster index -> image
  const float* kxd;    // (n) derivative wavenumbers, Nyquist zeroed
  const float* k2v;    // (n) true k^2 per axis
  const float* de;     // (n) 2/3-rule mask per axis
  const float2* Fk;    // (n, n) forcing spectrum, kx-major, or null
  const float2* tw;    // (n) tw[16 k1 + t] = exp(-2 pi i t k1 / n)
  float* out;          // (B, S + inc, n, n, 1 or 3)
};

// Shared-memory layout of one block (complex64 units), the same in every
// block of a cluster so that map_shared_rank finds a peer's buffers.
template <int N>
struct CSmem {
  static constexpr int C = N / 16;          // blocks in the cluster
  static constexpr int LP = N + N / 16;     // a line of scratch, lpad layout
  static constexpr int TW = 0;              // (N) twiddles, [k1][t]
  static constexpr int IK2 = TW + N;        // (16, N) floats: 1/|k|^2 / n^2 of the slab
  static constexpr int VEC = IK2 + 8 * N;   // (3, N) floats: kxd, k2v, de
  static constexpr int WS = VEC + 2 * N;    // (16, N) w_hat slab, a line per kx
  static constexpr int NP = WS + 16 * N;    // (16, N) AB2 history
  static constexpr int LS = NP + 16 * N;    // (16, LP) line scratch
  static constexpr int X1 = LS + 16 * LP;   // (2, C, kTile) y -> x exchange
  static constexpr int G = X1 + 2 * C * kTile;  // (C, kTile) x -> y exchange
  static constexpr int TOTAL = G + C * kTile;
  static constexpr int BYTES = TOTAL * 8;
  static_assert(BYTES <= 232448, "shared memory");
};

enum PackMode { PK_STEP = 0, PK_VORT = 1, PK_UV = 2, PK_DUV = 3 };
enum PhysMode { PH_STEP = 0, PH_VORT = 1, PH_UV = 2, PH_DUV = 3, PH_PRESS = 4 };
enum SpecMode { SP_INIT = 0, SP_BOOT = 1, SP_STEP = 2, SP_PRESS = 3 };

// Phase clocks for profile_k1 (built with -DSNS_PHASE_CLOCKS only): thread
// 0 of block 0 of the first cluster adds the SM cycles of each phase of
// every step to sns_phase_cycles[k], read back by sns_phase_clocks.
#ifdef SNS_PHASE_CLOCKS
__device__ unsigned long long sns_phase_cycles[16];
#define SNS_PHASE_START unsigned long long sns_t_ = clock64()
#define SNS_PHASE(k)                                                       \
  if (tid == 0 && blockIdx.y == 0 && rank == 0) {                          \
    const unsigned long long c_ = clock64();                               \
    sns_phase_cycles[k] += c_ - sns_t_;                                    \
    sns_t_ = c_;                                                           \
  }
#else
#define SNS_PHASE_START
#define SNS_PHASE(k)
#endif

template <int N>
__global__ void __launch_bounds__(kCThreads, N <= 128 ? 2 : 1)
sns_cluster_kernel(const CArgs a) {
  using L = CSmem<N>;
  constexpr int R = N / 16;
  extern __shared__ __align__(16) float2 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = a.order[blockIdx.y];
  const int tid = threadIdx.x;
  const int l = tid >> 4;         // this half-warp's line
  const int t = tid & 15;         // lane in the line
  float2* TW = sm + L::TW;
  float2* WS = sm + L::WS + l * N;   // this line's slab rows
  float2* NPS = sm + L::NP + l * N;
  float2* ls = sm + L::LS + l * L::LP;
  float2* X1 = sm + L::X1;
  float2* G = sm + L::G;

  const float nu = a.nu[b];
  const int steps = a.steps[b];
  const int T = a.S + a.inc;
  const int ch = a.fields ? 3 : 1;
  const int kx = 16 * rank + l;      // the line's spectral column
  const int y = 16 * rank + l;       // the line's physical row
  const float kxv = __ldg(a.kxd + kx);
  const float k2x = __ldg(a.k2v + kx);
  const float dex = __ldg(a.de + kx);
  const float hdt = 0.5f * a.dt;
  float* IK2 = reinterpret_cast<float*>(sm + L::IK2) + l * N;  // this line's 1/|k|^2 / n^2
  float* KXD = reinterpret_cast<float*>(sm + L::VEC);
  float* K2V = KXD + N;
  float* DE = K2V + N;

  for (int i = tid; i < N; i += kCThreads) {
    TW[i] = a.tw[i];
    KXD[i] = a.kxd[i];
    K2V[i] = a.k2v[i];
    DE[i] = a.de[i];
  }
  __syncthreads();
  // the slab's 1/|k|^2 (0 at the zero mode), with the inverse transform's
  // 1/n^2: one division a point for the whole call
  for (int e = t; e < N; e += 16) {
    const float k2 = K2V[e] + k2x;
    IK2[e] = (k2 > 0.f ? 1.f / k2 : 0.f) * a.inv_n2;
  }
  __syncwarp();
  SNS_PHASE_START;

  float2 v[R], o[16], o1[16];

  // this block's tile of plane p of X1 in peer m, row l: 16 values, x = 16m + t
  auto x1_peer = [&](int p, int m) {
    return ld_peer(cluster, X1 + (p * L::C + rank) * kTile + l * 17 + t, m);
  };
  auto g_peer = [&](int m) { return ld_peer(cluster, G + rank * kTile + l * 17 + t, m); };
  // o (lanes t < R, index t + R k2) -> v (every lane, index t + 16 m),
  // through the line scratch; for N = 256 the two are the same points
  auto redistribute = [&](float2 (&src)[16]) {
    if constexpr (R == 16) {
#pragma unroll
      for (int m = 0; m < R; ++m) v[m] = src[m];
    } else {
      if (t < R) {
#pragma unroll
        for (int k2 = 0; k2 < 16; ++k2) ls[lpad(t + R * k2)] = src[k2];
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < R; ++m) v[m] = ls[lpad(t + 16 * m)];
      __syncwarp();
    }
  };
  // a line of spectral values along ky (o, lanes t < R) -> X1 plane p
  auto put_x1 = [&](int p, float2 (&src)[16]) {
    if (t < R) {
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        const int yy = t + R * k2;
        X1[(p * L::C + (yy >> 4)) * kTile + (yy & 15) * 17 + l] = src[k2];
      }
    }
  };
  // a row of spectral values along kx (o, lanes t < R) -> G
  auto put_g = [&](float2 (&src)[16]) {
    if (t < R) {
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        const int xx = t + R * k2;
        G[(xx >> 4) * kTile + (xx & 15) * 17 + l] = src[k2];
      }
    }
  };
  auto frame_ptr = [&](int f) {
    return a.out + ((long long)b * T + f) * N * N * ch + (long long)y * N * ch;
  };

  // 1. packs from the slab, inverse FFT along ky, into X1 (planes p < np)
  auto inv_y = [&](int mode, int np) {
    for (int p = 0; p < np; ++p) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int ky = t + 16 * m;
        const float2 w = WS[ky];
        const float kyv = KXD[ky];
        const float ik = IK2[ky];
        const float pr = w.x * ik, pi = w.y * ik;   // psi, scaled
        float2 q;
        if (mode == PK_VORT) {
          q = c_scale(w, a.inv_n2);
        } else if (mode == PK_DUV) {
          // (kx + i ky)(-ky psi) and (kx + i ky)(kx psi)
          const float f = p == 0 ? -kyv : kxv;
          const float tr = f * pr, ti = f * pi;
          q = make_float2(kxv * tr - kyv * ti, kxv * ti + kyv * tr);
        } else if (p == 0) {   // PK_STEP, PK_UV: (kx + i ky) psi
          q = make_float2(kxv * pr - kyv * pi, kxv * pi + kyv * pr);
        } else {               // PK_STEP: (-ky + i kx) w_hat, scaled
          q = make_float2((-kyv * w.x - kxv * w.y) * a.inv_n2,
                          (kxv * w.x - kyv * w.y) * a.inv_n2);
        }
        v[m] = q;
      }
      line_fft<N, true>(v, o, ls, TW, t);
      put_x1(p, o);
    }
  };


  // 2. the rows: X1 tiles from every peer, inverse FFT along x, then by
  // mode: the product's forward FFT into G (PH_STEP, PH_DUV) or frame f's
  // channels (PH_VORT, PH_UV, PH_PRESS)
  auto phys = [&](int mode, int f) {
    const bool two = mode == PH_STEP || mode == PH_DUV;
    float2 v1[R];
#pragma unroll
    for (int m = 0; m < R; ++m) v[m] = x1_peer(0, m);
    if (two) {
#pragma unroll
      for (int m = 0; m < R; ++m) v1[m] = x1_peer(1, m);
    }
    if (mode == PH_STEP) SNS_PHASE(3);  // exchange: X1 reads issued
    line_fft<N, true>(v, o, ls, TW, t);
    if (two) {
#pragma unroll
      for (int m = 0; m < R; ++m) v[m] = v1[m];
      line_fft<N, true>(v, o1, ls, TW, t);
    }
    if (mode == PH_STEP) SNS_PHASE(4);  // inverse x
    if (two) {
      // u w_x + v w_y, or rhs_p = 2 (u_x v_y - u_y v_x) (o = u_x + i u_y,
      // o1 = v_x + i v_y); then the forward FFT along x into G
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        const float r = mode == PH_STEP ? o[k2].x * o1[k2].x + o[k2].y * o1[k2].y
                                        : 2.f * (o[k2].x * o1[k2].y - o[k2].y * o1[k2].x);
        o[k2] = make_float2(r, 0.f);
      }
      redistribute(o);
      if (mode == PH_STEP) SNS_PHASE(5);  // product
      line_fft<N, false>(v, o, ls, TW, t);
      put_g(o);
      if (mode == PH_STEP) SNS_PHASE(6);  // forward x, G writes
    } else if (t < R) {
      float* fp = frame_ptr(f);
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        const int xx = t + R * k2;
        if (mode == PH_VORT) {
          fp[xx] = o[k2].x;
        } else if (mode == PH_UV) {
          fp[xx * 3] = o[k2].x;
          fp[xx * 3 + 1] = o[k2].y;
        } else {
          fp[xx * 3 + 2] = o[k2].x;
        }
      }
    }
  };

  // 3. the columns: G tiles from every peer, forward FFT along ky, then by
  // mode: w_hat = it (SP_INIT); the right-hand side into the history
  // (SP_BOOT) and the CN+AB2 update (SP_STEP); or p_hat = -R_hat / |k|^2
  // and its inverse FFT along ky into X1 plane 0 (SP_PRESS)
  auto spec = [&](int mode) {
#pragma unroll
    for (int m = 0; m < R; ++m) v[m] = g_peer(m);
    if (mode == SP_STEP) SNS_PHASE(8);  // exchange: G reads issued
    line_fft<N, false>(v, o, ls, TW, t);
    if (mode == SP_STEP) SNS_PHASE(9);  // forward y
    if (mode == SP_PRESS) {
      if (t < R) {
#pragma unroll
        for (int k2 = 0; k2 < 16; ++k2) {
          o[k2] = c_scale(o[k2], -IK2[t + R * k2]);
        }
      }
      redistribute(o);
      line_fft<N, true>(v, o, ls, TW, t);
      put_x1(0, o);
      return;
    }
    if (t < R) {
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        const int ky = t + R * k2;
        if (mode == SP_INIT) {
          WS[ky] = o[k2];
          continue;
        }
        float2 av = o[k2];
        if (a.dealias) av = c_scale(av, DE[ky] * dex);
        const float2 w = WS[ky];
        float rr = -av.x, ri = -av.y;
        if (a.Fk != nullptr) {
          const float2 fh = a.Fk[(long long)kx * N + ky];
          rr += fh.x;
          ri += fh.y;
        }
        if (a.drag != 0.f) {
          rr -= a.drag * w.x;
          ri -= a.drag * w.y;
        }
        if (mode == SP_STEP) {
          const float2 np = NPS[ky];
          const float nuk2 = nu * (K2V[ky] + k2x);
          const float vn = 1.f - hdt * nuk2;
          const float vd = 1.f / (1.f + hdt * nuk2);
          WS[ky] = make_float2((w.x * vn + a.dt * (1.5f * rr - 0.5f * np.x)) * vd,
                               (w.y * vn + a.dt * (1.5f * ri - 0.5f * np.y)) * vd);
        }
        NPS[ky] = make_float2(rr, ri);
      }
    }
    __syncwarp();  // the slab line is read by every lane next
    if (mode == SP_STEP) SNS_PHASE(10);  // update
  };

  auto step = [&](int mode) {
    if (mode == SP_STEP) SNS_PHASE(0);  // the loop, and a snapshot's frame
    inv_y(PK_STEP, 2);
    if (mode == SP_STEP) SNS_PHASE(1);  // packs, inverse y, X1 writes
    cluster.sync();  // A: X1 of every block
    if (mode == SP_STEP) SNS_PHASE(2);  // barrier A
    phys(PH_STEP, 0);
    cluster.sync();  // B: G of every block
    if (mode == SP_STEP) SNS_PHASE(7);  // barrier B
    spec(mode);
  };
  // frame f of the current state; ends on a barrier, so that the next
  // step's X1 writes wait until every peer has read this block's X1
  auto frame = [&](int f) {
    if (!a.fields) {
      inv_y(PK_VORT, 1);
      cluster.sync();
      phys(PH_VORT, f);
      cluster.sync();
      return;
    }
    inv_y(PK_UV, 1);
    cluster.sync();
    phys(PH_UV, f);
    cluster.sync();  // every peer done with X1 (u + i v)
    inv_y(PK_DUV, 2);
    cluster.sync();
    phys(PH_DUV, f);
    cluster.sync();  // G (R_hat rows) of every block
    spec(SP_PRESS);
    cluster.sync();
    phys(PH_PRESS, f);
    cluster.sync();
  };

  // w_hat = fft2(w0): the rows of w0, forward along x, into G
  {
    const float* src = a.w0 + (long long)b * N * N + (long long)y * N;
#pragma unroll
    for (int m = 0; m < R; ++m) v[m] = make_float2(__ldg(src + t + 16 * m), 0.f);
    line_fft<N, false>(v, o, ls, TW, t);
    put_g(o);
  }
  cluster.sync();  // every block has started and written G
  spec(SP_INIT);
  step(SP_BOOT);  // forward-Euler bootstrap: history = rhs(w_hat0)
  if (a.inc) {
    if (a.fields) {
      frame(0);
    } else {
      const float* src = a.w0 + (long long)b * N * N + (long long)y * N;
      float* fp = frame_ptr(0);
      for (int x = t; x < N; x += 16) fp[x] = __ldg(src + x);
    }
  }
  for (int s = 0; s < a.S; ++s) {
    for (int it = 0; it < steps; ++it) step(SP_STEP);
    frame(s + a.inc);
  }
  cluster.sync();  // no block leaves while a peer may still read it
}

// The kernel of n^2: its launch configuration, and how many of its
// clusters the card holds at once (0: none), asked once.
template <int N>
int sns_configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int B, cudaStream_t st,
                  int* resident) {
  using L = CSmem<N>;
  static int cached = -1;
  cfg = {};
  cfg.gridDim = dim3(L::C, B > 0 ? B : 1, 1);
  cfg.blockDim = dim3(kCThreads, 1, 1);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cached < 0) {
    cudaError_t e = cudaFuncSetAttribute(sns_cluster_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e == cudaSuccess && L::C > 8)
      e = cudaFuncSetAttribute(sns_cluster_kernel<N>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&cached, sns_cluster_kernel<N>, &cfg);
    if (e != cudaSuccess) {
      cached = -1;
      return (int)e;
    }
  }
  *resident = cached;
  return 0;
}

template <int N>
int sns_launch(const CArgs& a, cudaStream_t st, int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int resident = 0;
  const int rc = sns_configure<N>(cfg, attr, a.B, st, &resident);
  if (rc != 0) return rc;
  if (max_clusters != nullptr) *max_clusters = resident;
  if (resident == 0) return kNotResident;
  if (a.B == 0) return 0;
  return (int)cudaLaunchKernelEx(&cfg, sns_cluster_kernel<N>, a);
}

int sns_dispatch(const CArgs& a, int n, cudaStream_t st, int* max_clusters) {
  switch (n) {
    case 128: return sns_launch<128>(a, st, max_clusters);
    case 256: return sns_launch<256>(a, st, max_clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The whole trajectory of every image in one launch: w_hat = fft2(w0),
// the forward-Euler bootstrap of the history, frame 0 (w0, or its fields)
// when `inc`, then per snapshot steps[b] CN+AB2 steps with nu[b] and the
// frame into out[b, s + inc]. `order` (B) maps cluster j to its image.
// Returns kNotResident (-2) when the card cannot hold one cluster.
int sns_traj(const float* w0, const float* nu, const int* steps, const int* order,
             const float* kxd, const float* k2v, const float* de, const void* Fk,
             const void* tw, int B, int n, int S, int inc, int fields, float dt, float drag,
             int dealias, float* out, void* stream, int* launched) {
  CArgs a;
  a.B = B;
  a.S = S;
  a.inc = inc;
  a.fields = fields;
  a.dealias = dealias;
  a.dt = dt;
  a.drag = drag;
  a.inv_n2 = 1.f / ((float)n * (float)n);
  a.w0 = w0;
  a.nu = nu;
  a.steps = steps;
  a.order = order;
  a.kxd = kxd;
  a.k2v = k2v;
  a.de = de;
  a.Fk = static_cast<const float2*>(Fk);
  a.tw = static_cast<const float2*>(tw);
  a.out = out;
  if (launched != nullptr) *launched = 0;
  const int rc = sns_dispatch(a, n, static_cast<cudaStream_t>(stream), nullptr);
  if (rc != 0) return rc;
  const cudaError_t e = cudaGetLastError();
  if (launched != nullptr && e == cudaSuccess) *launched = B > 0 ? 1 : 0;
  return (int)e;
}

// How many clusters of the n^2 kernel the card holds at once (0: none).
int sns_max_active_clusters(int n, int* clusters) {
  CArgs a = {};
  *clusters = 0;
  return sns_dispatch(a, n, nullptr, clusters);
}

#ifdef SNS_PHASE_CLOCKS
// Copy the 16 phase counters to `host` (and zero them when `reset`).
int sns_phase_clocks(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, sns_phase_cycles, sizeof(unsigned long long) * 16);
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[16] = {};
    e = cudaMemcpyToSymbol(sns_phase_cycles, zero, sizeof(zero));
  }
  return (int)e;
}
#endif

}  // extern "C"
