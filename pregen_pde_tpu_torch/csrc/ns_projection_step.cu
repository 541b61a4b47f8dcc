// Hand-written Chorin projection stepper for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   pregen_pde_tpu/solvers/ns_projection_pallas.py::build_batched_traj
// (kernel body `make_kernel`), whose meaning is ProjectionSolver.step
// iterated as in make_trajectory_fn, with the direct (DCT eigen) pressure
// solve. One step on (u, v), per image, with u_max per image:
//   u*, v*  = (q + dt (-(u q_x + v q_y) + nu lap q)) pen,  pen = 1/(1 + dt mask/eta)
//             (MUSCL van Leer or first-order upwind advection, edge-
//             replicated shifts), then the BCs
//   rhs     = -(Dx u* + Dy v* - [x == 0] inlet u_max / dx) / dt   (zero-ghost D)
//   p       = CY^T ((CY rhs CX^T) / denom) CX    (p_hat[0,0] = 0 for the cavity)
//   u, v    = BC(u* - dt Gx p, v* - dt Gy p) pen  (channel: Gx = -2p/dx at x = n-1)
// Channel: DCT-II along y (CY), DCT-IV along x (CX); cavity: DCT-II on both.
// The left multiply acts along y, the right along x.
//
// Design. The TPU kernel keeps u, v, p, both bases and the denominator
// resident in VMEM for the whole loop; at 128^2 that is 192 KB of state plus
// 128 KB of bases per image group, more than an SM's 227 KB of shared memory.
// Here a step is a chain of seven launches on the caller's stream, looped
// over `steps` by the C entry point:
//   1. predictor: one thread per point, stencil reads through the L1/L2
//      cache (MUSCL needs a 2-cell halo), pen from the runtime dt, BCs;
//   2. divergence with the inlet-flux fix -> rhs (it reads BC'd neighbours
//      of u*, v*, so it is a launch of its own);
//   3.-6. four batched shared-memory tiled SGEMMs (32 x 32 output tiles):
//      T = rhs CX^T; R = (CY T) / denom; T = R CX; p = CY^T T;
//   7. correction, BCs and pen.
// A snapshot is one more launch that writes (u, v, p) into frame s.
// dt, u_max, nu, eta and the step count are runtime arguments, so one build
// serves every horizon bucket, CFL sub-bucket and dt/2 retry.
//
// Precision: one float32 CUDA-core solve with float32 accumulation. The TPU
// kernel's bf16 solve plus one refinement step exists only because Mosaic
// lacks a 3-pass matmul; plain float32 gives the same divergence floor. The
// cavity's rhs mean is not subtracted here: the constant vector is the DCT-II
// zero mode, orthogonal to every other basis vector, and p_hat[0,0] is set
// to 0, so the mean changes nothing but roundoff.
//
// What bounds a step on the H100: the four (n x n)(n x n) products per image
// (16.8 MFLOP at 128^2) on CUDA cores through shared memory (the inner loop
// issues five shared loads for four FMAs), and at small batch the seven
// launches (latency bound: 16 GEMM blocks per image at 128^2). The state is
// seven planes (u, v, u*, v*, rhs, T, p), 14 MB at 128^2 and batch 32, so it
// stays in the 50 MB L2. A later PR can fuse the divergence into the first
// GEMM's tile loads and the predictor into the correction, register-tile the
// GEMMs (or run them on tensor cores with a refinement that keeps the
// floor), capture the step in a CUDA graph, or keep the 128^2 state resident
// in a thread-block cluster's distributed shared memory (ROADMAP.md).
//
// Grids: n a multiple of 32, 32 <= n <= 256. Kernels launch on the caller's
// stream, never synchronise and allocate nothing; every entry point returns
// cudaGetLastError() and reports how many kernels it enqueued (`launched`).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;       // GEMM output tile (kTile x kTile), k step
constexpr int kGemmThreads = 256;
constexpr int kPointThreads = 256;

struct Step {
  int B, n;
  int channel;                  // 1 = channel (FPO), 0 = cavity (LDC)
  int muscl;                    // 1 = MUSCL (van Leer), 0 = first-order upwind
  float dt, nu, eta, dx, dx2;   // dx2 = dx*dx rounded once from double
  const float* mask;            // (B, n, n)
  const float* umax;            // (B)
  const float* inlet;           // (n) unit parabolic profile
  const float* U;               // (B, n, n) state
  const float* V;
  float* US;                    // (B, n, n) predictor output u*, v*
  float* VS;
};

__device__ __forceinline__ float ld(const float* q, int n, int y, int x) {
  y = min(max(y, 0), n - 1);
  x = min(max(x, 0), n - 1);
  return __ldg(q + y * n + x);
}

// van Leer slope of the point with neighbours (qm, q, qp)
__device__ __forceinline__ float vl_slope(float qm, float q, float qp) {
  const float a = qp - q;
  const float b = q - qm;
  const float ab = a * b;
  return ab > 0.f ? 2.f * ab / (a + b) : 0.f;
}

// upwind derivative of plane q at (y, x) along x (ax = 1) or y (ax = 0)
// w.r.t. the carrier velocity vel; edge-replicated neighbours
__device__ float grad_adv(const float* q, int n, int y, int x, int ax, float vel,
                          int muscl, float dx) {
  const int dy = ax ? 0 : 1;
  const int dxi = ax ? 1 : 0;
  const float q0 = ld(q, n, y, x);
  const float qm1 = ld(q, n, y - dy, x - dxi);
  const float qp1 = ld(q, n, y + dy, x + dxi);
  const float a = qp1 - q0;
  const float b = q0 - qm1;
  if (!muscl) return vel > 0.f ? b / dx : a / dx;
  // slopes of the clamped neighbours i-1 and i+1 (edge replication of the
  // slope field = the slope at the clamped index)
  const int i = ax ? x : y;
  const int im = max(i - 1, 0);
  const int ip = min(i + 1, n - 1);
  float s_m1, s_p1;
  if (ax) {
    s_m1 = vl_slope(ld(q, n, y, im - 1), ld(q, n, y, im), ld(q, n, y, im + 1));
    s_p1 = vl_slope(ld(q, n, y, ip - 1), ld(q, n, y, ip), ld(q, n, y, ip + 1));
  } else {
    s_m1 = vl_slope(ld(q, n, im - 1, x), ld(q, n, im, x), ld(q, n, im + 1, x));
    s_p1 = vl_slope(ld(q, n, ip - 1, x), ld(q, n, ip, x), ld(q, n, ip + 1, x));
  }
  const float slope = vl_slope(qm1, q0, qp1);
  if (vel > 0.f) return (b + 0.5f * (slope - s_m1)) / dx;
  return (a - 0.5f * (s_p1 - slope)) / dx;
}

__device__ __forceinline__ float laplacian(const float* q, int n, int y, int x, float dx2) {
  return (ld(q, n, y + 1, x) + ld(q, n, y - 1, x) + ld(q, n, y, x + 1) +
          ld(q, n, y, x - 1) - 4.f * ld(q, n, y, x)) / dx2;
}

__device__ __forceinline__ float pen_at(const Step& s, const float* mask, int y, int x) {
  return 1.f / (1.f + s.dt * mask[y * s.n + x] / s.eta);
}

// (u*, v*) before the BCs: the explicit update times pen
__device__ void predict_point(const Step& s, const float* u, const float* v,
                              const float* mask, int y, int x, float& us, float& vs) {
  const int n = s.n;
  const float uu = ld(u, n, y, x);
  const float vv = ld(v, n, y, x);
  const float adv_u = uu * grad_adv(u, n, y, x, 1, uu, s.muscl, s.dx) +
                      vv * grad_adv(u, n, y, x, 0, vv, s.muscl, s.dx);
  const float adv_v = uu * grad_adv(v, n, y, x, 1, uu, s.muscl, s.dx) +
                      vv * grad_adv(v, n, y, x, 0, vv, s.muscl, s.dx);
  const float pen = pen_at(s, mask, y, x);
  us = (uu + s.dt * (-adv_u + s.nu * laplacian(u, n, y, x, s.dx2))) * pen;
  vs = (vv + s.dt * (-adv_v + s.nu * laplacian(v, n, y, x, s.dx2))) * pen;
}

// 1. predictor + BCs, in apply_velocity_bc's set order (corners match)
__global__ void predictor_kernel(Step s) {
  const int n = s.n;
  const long long npt = (long long)s.B * n * n;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < npt;
       t += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(t / ((long long)n * n));
    const int yx = (int)(t - (long long)b * n * n);
    const int y = yx / n;
    const int x = yx - y * n;
    const long long off = (long long)b * n * n;
    const float* u = s.U + off;
    const float* v = s.V + off;
    const float* mask = s.mask + off;
    const float um = s.umax[b];
    float us = 0.f, vs = 0.f;
    if (s.channel) {
      if (y == 0 || y == n - 1) {           // walls, set last
      } else if (x == 0) {                  // inlet
        us = s.inlet[y] * um;
      } else {                              // outflow copies column n-2
        predict_point(s, u, v, mask, y, x == n - 1 ? n - 2 : x, us, vs);
      }
    } else {
      if (y == n - 1) {                     // moving lid, set last
        us = um;
      } else if (y == 0 || x == 0 || x == n - 1) {
      } else {
        predict_point(s, u, v, mask, y, x, us, vs);
      }
    }
    s.US[t] = us;
    s.VS[t] = vs;
  }
}

// 2. rhs = -div / dt, flux-form divergence with zero ghosts and the inlet fix
__global__ void divergence_kernel(Step s, float* R) {
  const int n = s.n;
  const long long npt = (long long)s.B * n * n;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < npt;
       t += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(t / ((long long)n * n));
    const int yx = (int)(t - (long long)b * n * n);
    const int y = yx / n;
    const int x = yx - y * n;
    const float u0 = s.US[t];
    const float v0 = s.VS[t];
    const float uw = x > 0 ? s.US[t - 1] : 0.f;
    const float vs = y > 0 ? s.VS[t - n] : 0.f;
    float div = (u0 - uw) / s.dx + (v0 - vs) / s.dx;
    if (s.channel && x == 0) div = div - s.inlet[y] * s.umax[b] / s.dx;
    R[t] = -div / s.dt;
  }
}

enum Epilogue { EPI_STORE = 0, EPI_DENOM = 1 };

// 3.-6. C[b] = A[b] . Bm[b] for row-major n x n matrices; a batch stride of 0
// broadcasts a constant basis. 32 x 32 output tile per block, 256 threads,
// each thread one row and four columns (c, c+8, c+16, c+24); k in steps of
// 32 through padded shared tiles (no bank conflicts on the loads or reads).
// EPI_DENOM divides by denom and zeroes the [0,0] mode when zero_mode.
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, long long sA, const float* __restrict__ Bm,
            long long sB, float* __restrict__ C, int n, int epilogue,
            const float* __restrict__ denom, int zero_mode) {
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Bs[kTile][kTile + 1];
  const int t = threadIdx.x;
  const int r = t >> 3;
  const int c = t & 7;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  A += blockIdx.z * sA;
  Bm += blockIdx.z * sB;
  C += (long long)blockIdx.z * n * n;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < n; k0 += kTile) {
    for (int e = t; e < kTile * kTile; e += kGemmThreads) {
      const int rr = e >> 5;
      const int kk = e & 31;
      As[rr][kk] = A[(long long)(i0 + rr) * n + k0 + kk];
      Bs[rr][kk] = Bm[(long long)(k0 + rr) * n + j0 + kk];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const float a = As[r][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(a, Bs[k][c + 8 * j], acc[j]);
    }
    __syncthreads();
  }
  const int row = i0 + r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = j0 + c + 8 * j;
    float val = acc[j];
    if (epilogue == EPI_DENOM) {
      val = val / denom[row * n + col];
      if (zero_mode && row == 0 && col == 0) val = 0.f;
    }
    C[(long long)row * n + col] = val;
  }
}

// corrected velocity at (y, x) before the BCs: q* - dt G p
__device__ __forceinline__ void correct_point(const Step& s, const float* P, long long off,
                                              int y, int x, float& uc, float& vc) {
  const int n = s.n;
  const float* p = P + off;
  const float p0 = p[y * n + x];
  float gx;
  if (s.channel && x == n - 1) {
    gx = -2.f * p0 / s.dx;                  // outlet: p = 0 half a cell out
  } else {
    gx = (p[y * n + min(x + 1, n - 1)] - p0) / s.dx;
  }
  const float gy = (p[min(y + 1, n - 1) * n + x] - p0) / s.dx;
  uc = s.US[off + y * n + x] - s.dt * gx;
  vc = s.VS[off + y * n + x] - s.dt * gy;
}

// 7. correction, BCs, pen -> the new state (U, V are written here only)
__global__ void correction_kernel(Step s, const float* P, float* U, float* V) {
  const int n = s.n;
  const long long npt = (long long)s.B * n * n;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < npt;
       t += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(t / ((long long)n * n));
    const long long off = (long long)b * n * n;
    const int yx = (int)(t - off);
    const int y = yx / n;
    const int x = yx - y * n;
    const float um = s.umax[b];
    float uc = 0.f, vc = 0.f;
    if (s.channel) {
      if (y == 0 || y == n - 1) {
      } else if (x == 0) {
        uc = s.inlet[y] * um;
      } else {
        correct_point(s, P, off, y, x == n - 1 ? n - 2 : x, uc, vc);
      }
    } else {
      if (y == n - 1) {
        uc = um;
      } else if (y == 0 || x == 0 || x == n - 1) {
      } else {
        correct_point(s, P, off, y, x, uc, vc);
      }
    }
    const float pen = pen_at(s, s.mask + off, y, x);
    U[t] = uc * pen;
    V[t] = vc * pen;
  }
}

// rest + BCs (make_trajectory_fn's initial state): U, V, P = BC(0, 0), 0
__global__ void init_kernel(int B, int n, int channel, const float* umax,
                            const float* inlet, float* U, float* V, float* P) {
  const long long npt = (long long)B * n * n;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < npt;
       t += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(t / ((long long)n * n));
    const int yx = (int)(t - (long long)b * n * n);
    const int y = yx / n;
    const int x = yx - y * n;
    float u = 0.f;
    if (channel) {
      // the outflow copy of column n-2 is 0 at rest
      if (y > 0 && y < n - 1 && x == 0) u = inlet[y] * umax[b];
    } else if (y == n - 1) {
      u = umax[b];
    }
    U[t] = u;
    V[t] = 0.f;
    P[t] = 0.f;
  }
}

// frame: out[b * img_stride + (y * n + x) * 3 + {0, 1, 2}] = (u, v, p)
__global__ void frame_kernel(int B, int n, const float* U, const float* V, const float* P,
                             float* out, long long img_stride) {
  const long long npt = (long long)B * n * n;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < npt;
       t += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(t / ((long long)n * n));
    const long long yx = t - (long long)b * n * n;
    float* o = out + b * img_stride + yx * 3;
    o[0] = U[t];
    o[1] = V[t];
    o[2] = P[t];
  }
}

int point_blocks(int B, int n) {
  const long long npt = (long long)B * n * n;
  const long long blocks = (npt + kPointThreads - 1) / kPointThreads;
  return (int)(blocks < 65535 ? blocks : 65535);
}

int gemm(const float* A, long long sA, const float* Bm, long long sB, float* C, int B,
         int n, int epilogue, const float* denom, int zero_mode, cudaStream_t st) {
  const dim3 grid(n / kTile, n / kTile, B);
  gemm_kernel<<<grid, kGemmThreads, 0, st>>>(A, sA, Bm, sB, C, n, epilogue, denom,
                                             zero_mode);
  return 1;
}

int finish(int n_launched, int* launched) {
  const cudaError_t e = cudaGetLastError();
  if (launched != nullptr) *launched = e == cudaSuccess ? n_launched : 0;
  return (int)e;
}

}  // namespace

extern "C" {

// U, V, P = rest + BCs, and frame 0 of `out`.
int nsp_init(void* U, void* V, void* P, const float* umax, const float* inlet, int B,
             int n, int channel, float* out, long long img_stride, void* stream,
             int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = point_blocks(B, n);
  float* u = static_cast<float*>(U);
  float* v = static_cast<float*>(V);
  float* p = static_cast<float*>(P);
  init_kernel<<<blocks, kPointThreads, 0, st>>>(B, n, channel, umax, inlet, u, v, p);
  frame_kernel<<<blocks, kPointThreads, 0, st>>>(B, n, u, v, p, out, img_stride);
  return finish(2, launched);
}

// `steps` projection steps in place on (U, V, P), then (u, v, p) into the
// frame at `out`. US, VS, R, T are scratch planes.
int nsp_advance(void* U, void* V, void* US, void* VS, void* R, void* T, void* P,
                const float* mask, const float* umax, const float* inlet,
                const float* cy, const float* cyT, const float* cx, const float* cxT,
                const float* denom, int B, int n, int channel, int muscl, int steps,
                float dt, float nu, float eta, float dx, float dx2, float* out,
                long long img_stride, void* stream, int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Step s;
  s.B = B;
  s.n = n;
  s.channel = channel;
  s.muscl = muscl;
  s.dt = dt;
  s.nu = nu;
  s.eta = eta;
  s.dx = dx;
  s.dx2 = dx2;
  s.mask = mask;
  s.umax = umax;
  s.inlet = inlet;
  s.U = static_cast<const float*>(U);
  s.V = static_cast<const float*>(V);
  s.US = static_cast<float*>(US);
  s.VS = static_cast<float*>(VS);
  float* r = static_cast<float*>(R);
  float* tt = static_cast<float*>(T);
  float* p = static_cast<float*>(P);
  const long long plane = (long long)n * n;
  const int blocks = point_blocks(B, n);
  const int zero_mode = channel ? 0 : 1;
  int k = 0;
  for (int i = 0; i < steps; ++i) {
    predictor_kernel<<<blocks, kPointThreads, 0, st>>>(s);
    divergence_kernel<<<blocks, kPointThreads, 0, st>>>(s, r);
    k += 2;
    k += gemm(r, plane, cxT, 0, tt, B, n, EPI_STORE, nullptr, 0, st);   // rhs CX^T
    k += gemm(cy, 0, tt, plane, r, B, n, EPI_DENOM, denom, zero_mode, st);  // p_hat
    k += gemm(r, plane, cx, 0, tt, B, n, EPI_STORE, nullptr, 0, st);    // p_hat CX
    k += gemm(cyT, 0, tt, plane, p, B, n, EPI_STORE, nullptr, 0, st);   // p
    correction_kernel<<<blocks, kPointThreads, 0, st>>>(s, p, static_cast<float*>(U),
                                                         static_cast<float*>(V));
    ++k;
  }
  frame_kernel<<<blocks, kPointThreads, 0, st>>>(B, n, s.U, s.V, p, out, img_stride);
  return finish(k + 1, launched);
}

}  // extern "C"
