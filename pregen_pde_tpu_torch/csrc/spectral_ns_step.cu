// Hand-written CN+AB2 pseudo-spectral vorticity stepper for Hopper (sm_90a).
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
