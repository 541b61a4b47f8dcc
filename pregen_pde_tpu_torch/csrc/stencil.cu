// Hand-written periodic stencil kernels for Hopper (sm_90a): the 5-point
// Laplacian (K5a) and the fused Heun step of the heat / diffusion-reaction
// equation (K5b).
//
// Replaces the Pallas TPU kernels of pregen_pde_tpu/ops/stencil.py:
//   K5a laplacian_pallas (body _lap_kernel):
//       lap = (up + down + left + right - 4 u) * inv_dx2,
//       up = roll(u, 1, axis 0), down = roll(u, n-1, axis 0),
//       left = roll(u, 1, axis 1), right = roll(u, n-1, axis 1);
//   K5b heat_step_pallas (body _heat_step_kernel), one Heun step of
//       u_t = D lap u + k u (1 - u^2):
//       k1 = rhs(u), k2 = rhs(u + dt k1), u + (dt/2) (k1 + k2),
//       rhs(u) = D lap u [+ k u (1 - u^2) when k != 0].
// The arithmetic follows those bodies in float32, in the same order; the
// kernel and its plain version differ only where nvcc contracts a multiply
// and an add into one FMA.
//
// What bounds them on the H100: both are single passes over memory. K5a
// reads and writes one float a point (6 FLOP); K5b the same with about 25
// FLOP a point. At the heat main path's shape (B = 32, 128^2) one pass moves
// 4.2 MB, about 1.25 us at 3.35 TB/s: below the cost of a launch, so at
// that size both are launch bound.
//
// Design. The TPU kernels hold the whole (n, n) image in VMEM and shift it
// with pltpu.roll. An SM's 227 KB of shared memory cannot hold an image
// beyond about 160^2 twice, so here the image is tiled, and the periodic
// shift becomes index arithmetic (wrapped indices), not data movement:
//   K5a: one thread per output point over (B, n, n); the neighbours are
//        read through the read-only cache, which serves the reuse between
//        neighbouring threads.
//   K5b: one launch a step. A block owns a kTX x kTY output tile, loads u
//        on the tile plus a two-cell halo into shared memory, computes k1
//        and u1 = u + dt k1 on the tile plus a one-cell halo (the second
//        stage needs u1 at the four neighbours), then k2 and the update on
//        the tile. Nothing intermediate goes to device memory: one read and
//        one write a point a step, as on the TPU. heat_advance loops the
//        steps in C over ping-pong buffers and writes the last step also
//        into a snapshot frame of the caller's (B, S+1, n, n) output, so
//        Python is entered once a snapshot, not once a step.
// Any n >= 1 works: the ragged edge tiles are masked, and every index is
// wrapped modulo n. A later PR can keep the whole 128^2 image resident in
// one block's shared memory for all the steps of a snapshot (one launch a
// snapshot), or capture the step loop in a CUDA graph (ROADMAP.md).
//
// Kernels launch on the caller's stream, never synchronise and allocate
// nothing; every entry point returns cudaGetLastError() and reports how many
// kernels it enqueued (`launched`).

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;   // output tile width (x, the contiguous axis)
constexpr int kTY = 16;   // output tile height
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// K5a: one thread per output point
__global__ void laplacian_kernel(const float* __restrict__ u, float* __restrict__ out,
                                 int n, float inv_dx2) {
  const int x = blockIdx.x * kThreadsX + threadIdx.x;
  const int y = blockIdx.y * kThreadsY + threadIdx.y;
  if (x >= n || y >= n) return;
  const long long plane = (long long)n * n;
  const float* ub = u + blockIdx.z * plane;
  const int ym = y == 0 ? n - 1 : y - 1;
  const int yp = y == n - 1 ? 0 : y + 1;
  const int xm = x == 0 ? n - 1 : x - 1;
  const int xp = x == n - 1 ? 0 : x + 1;
  const float c = __ldg(ub + y * n + x);
  const float up = __ldg(ub + ym * n + x);
  const float down = __ldg(ub + yp * n + x);
  const float left = __ldg(ub + y * n + xm);
  const float right = __ldg(ub + y * n + xp);
  out[blockIdx.z * plane + y * n + x] = (up + down + left + right - 4.f * c) * inv_dx2;
}

struct Heat {
  int n;
  float dt, half_dt, diff, react, inv_dx2;
};

// rhs at the centre c of a 5-point star in shared memory
template <bool kReact>
__device__ __forceinline__ float rhs(const Heat& h, float up, float down, float left,
                                     float right, float c) {
  const float lap = (up + down + left + right - 4.f * c) * h.inv_dx2;
  float r = h.diff * lap;
  if (kReact) r = r + h.react * c * (1.f - c * c);
  return r;
}

// K5b: one Heun step on a kTX x kTY tile. `frame` (may be null) receives a
// copy of the result at image stride `frame_stride`.
template <bool kReact>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
heat_step_kernel(const float* __restrict__ u, float* __restrict__ nxt,
                 float* __restrict__ frame, long long frame_stride, Heat h) {
  __shared__ float su[kTY + 4][kTX + 4];   // u, two-cell halo
  __shared__ float sk[kTY + 2][kTX + 2];   // k1, one-cell halo
  __shared__ float s1[kTY + 2][kTX + 2];   // u1 = u + dt k1, one-cell halo
  const int n = h.n;
  const long long plane = (long long)n * n;
  const float* ub = u + blockIdx.z * plane;
  const int tx0 = blockIdx.x * kTX;
  const int ty0 = blockIdx.y * kTY;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  constexpr int kThreads = kThreadsX * kThreadsY;

  for (int i = tid; i < (kTY + 4) * (kTX + 4); i += kThreads) {
    const int ly = i / (kTX + 4);
    const int lx = i - ly * (kTX + 4);
    const int gy = wrap(ty0 + ly - 2, n);
    const int gx = wrap(tx0 + lx - 2, n);
    su[ly][lx] = __ldg(ub + gy * n + gx);
  }
  __syncthreads();
  for (int i = tid; i < (kTY + 2) * (kTX + 2); i += kThreads) {
    const int ly = i / (kTX + 2);
    const int lx = i - ly * (kTX + 2);
    const float c = su[ly + 1][lx + 1];
    const float k1 = rhs<kReact>(h, su[ly][lx + 1], su[ly + 2][lx + 1], su[ly + 1][lx],
                                 su[ly + 1][lx + 2], c);
    sk[ly][lx] = k1;
    s1[ly][lx] = c + h.dt * k1;
  }
  __syncthreads();
  for (int ly = threadIdx.y; ly < kTY; ly += kThreadsY) {
    const int lx = threadIdx.x;
    const int gy = ty0 + ly;
    const int gx = tx0 + lx;
    if (gy >= n || gx >= n) continue;
    const float k2 = rhs<kReact>(h, s1[ly][lx + 1], s1[ly + 2][lx + 1], s1[ly + 1][lx],
                                 s1[ly + 1][lx + 2], s1[ly + 1][lx + 1]);
    const float r = su[ly + 2][lx + 2] + h.half_dt * (sk[ly + 1][lx + 1] + k2);
    const int yx = gy * n + gx;
    nxt[blockIdx.z * plane + yx] = r;
    if (frame != nullptr) frame[blockIdx.z * frame_stride + yx] = r;
  }
}

int finish(int n_launched, int* launched) {
  const cudaError_t e = cudaGetLastError();
  if (launched != nullptr) *launched = e == cudaSuccess ? n_launched : 0;
  return (int)e;
}

int invalid(int* launched) {
  if (launched != nullptr) *launched = 0;
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out = periodic 5-point Laplacian of u, both (B, n, n) contiguous.
int stencil_laplacian(const float* u, float* out, int B, int n, float inv_dx2, void* stream,
                      int* launched) {
  if (B < 1 || B > 65535 || n < 1) return invalid(launched);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kThreadsX - 1) / kThreadsX, (n + kThreadsY - 1) / kThreadsY, B);
  laplacian_kernel<<<grid, dim3(kThreadsX, kThreadsY), 0, st>>>(u, out, n, inv_dx2);
  return finish(1, launched);
}

// `steps` >= 1 Heun steps from u (read only): step 1 writes a, step 2 b,
// step 3 a, ...; the result lies in a when `steps` is odd, else in b. The
// last step also writes into `frame` (may be null) at image stride
// `frame_stride`. u, a and b are (B, n, n) contiguous; the reaction term is
// compiled in only when react != 0.
int stencil_heat_advance(const float* u, float* a, float* b, float* frame,
                         long long frame_stride, int B, int n, int steps, float dt,
                         float half_dt, float diff, float react, float inv_dx2, void* stream,
                         int* launched) {
  if (B < 1 || B > 65535 || n < 1 || steps < 1) return invalid(launched);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Heat h{n, dt, half_dt, diff, react, inv_dx2};
  const dim3 grid((n + kTX - 1) / kTX, (n + kTY - 1) / kTY, B);
  const dim3 block(kThreadsX, kThreadsY);
  const float* cur = u;
  for (int i = 0; i < steps; ++i) {
    float* dst = (i % 2 == 0) ? a : b;
    float* f = i == steps - 1 ? frame : nullptr;
    if (react != 0.f) {
      heat_step_kernel<true><<<grid, block, 0, st>>>(cur, dst, f, frame_stride, h);
    } else {
      heat_step_kernel<false><<<grid, block, 0, st>>>(cur, dst, f, frame_stride, h);
    }
    cur = dst;
  }
  return finish(steps, launched);
}

}  // extern "C"
