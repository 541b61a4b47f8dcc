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
// kernels and their plain versions differ only where nvcc contracts a
// multiply and an add into one FMA.
//
// K5a, two kernels, one launch a call either way. What bounds it is the
// bytes: u read once and the result written once (8 bytes a point; 1.25 us
// for (32, 128^2) at 3.35 TB/s), against 6 FLOP a point.
//   The row route (laplacian_rows_kernel; n = 128, 256 or 512, 16-byte
//   aligned): one pass over memory that reads each row once. A warp owns
//   an image row as float4 columns (lane L holds columns 4 (L + 32 c) ..
//   +3 of chunk c, V = n / 128 chunks), so the left and right neighbours
//   come by one __shfl each, lane 31's value sent to lane 0 carrying the
//   wrap (and lane 0's to lane 31). A warp streams a band of R rows of one
//   image (R = 2 at 128^2, 1 above): it holds the rows above, here and
//   below in registers, the band and its two halo rows loaded at once, so
//   a row is read once as the band's and once as a neighbour's halo, the
//   halo reads hitting L2. Blocks of four warps, a grid of at most one wave
//   of the SMs, striding over the bands. Bands of 4 and 8 rows (fewer
//   halo reads, fewer warps in flight) were no faster at B = 1, 8, 32
//   (variants.py), where a kernel's fixed cost is about that of the work
//   at (32, 128^2) (chip_smoke.py phase 23).
//   The general route (laplacian_kernel; any other n): one thread per
//   output point, the five neighbours through the read-only cache, which
//   serves the reuse between neighbouring threads.
//
// K5b, the trajectory (stencil_heat_trajectory): the heat generator runs
// S snapshots of `inner` Heun steps (20 x 500 at 128^2). One step of a
// (32, 128^2) batch moves 4.2 MB, about 1.25 us at 3.35 TB/s, while a launch
// costs ~6 us, so a launch a step is launch bound. Here the whole
// trajectory is ONE launch: each image stays on chip for all S x inner
// steps and only the frames (frame 0 = u0, then one a snapshot) go to
// device memory. What bounds it then is the FLOP: 19 a point a step at
// k = 0 (1.49 ms for the 128^2 main path's 32 x 10,000 image-steps on the
// float32 cores at 67 TFLOP/s).
//   Layout: an image is a cluster of CS blocks (CS in {1, 2, 4, 8}), block q
//   owning a band of ceil(n / CS) rows. Each thread owns a patch of kR = 8
//   rows by kV = 4 columns and keeps u, k1 and u1 of it in registers, so
//   the stencil's neighbours inside the patch are register reads. Only a
//   patch's edges are exchanged: its top and bottom rows (float4) through
//   shared memory, and its left and right columns through warp shuffles
//   when a warp holds one whole row of patches (n in 125..128: the warp's
//   32 lanes are the row's 32 patches, so the periodic wrap is lane 31 to
//   lane 0), else through shared memory. The band's first and last rows
//   come from the neighbouring blocks' shared memory over DSMEM (from the
//   block itself when CS = 1). Two barriers a step: after u1's edges are
//   out, and after the new u's. With whole patches (n a multiple of 4,
//   bands of whole patch rows) and shuffles, a thread computes the six
//   interior rows of its patch between its arrival at a cluster barrier and
//   its wait there, so the barrier's latency hides behind them; one block
//   an image (CS = 1) takes __syncthreads instead, cheaper still.
//   CS is the smallest cluster whose band fits (one block at 128^2, four at
//   256^2): at 128^2 one block an image took 1.34-1.36 us a step at B = 1,
//   8 and 32, clusters of 2-8 blocks 1.85-2.19 us (their barriers), on an
//   H100 (chip_smoke.py phase 23).
//   Any n works whose band fits 512 threads in a cluster of at most 8
//   (n <= 320 or so, the ragged edge masked); larger n take the tiled
//   kernel below, a launch a step.
//
// K5b, one step (stencil_heat_advance, the tiled route): a block owns a
// kTX x kTY output tile, loads u on the tile plus a two-cell halo into
// shared memory, computes k1 and u1 = u + dt k1 on the tile plus a
// one-cell halo, then k2 and the update on the tile: one read and one write
// a point a step. heat_advance loops the steps in C over ping-pong buffers
// and writes the last step also into a snapshot frame.
//
// Kernels launch on the caller's stream, never synchronise and allocate
// nothing; every entry point returns cudaGetLastError() and reports how many
// kernels it enqueued (`launched`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTX = 32;   // output tile width (x, the contiguous axis)
constexpr int kTY = 16;   // output tile height
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// K5a, the general route: one thread per output point
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

// K5a, the row route: a band of R rows of one image a warp, V float4 chunks
// a row, R V = kLapBand float4 rows (R at least 1; bands of 4 and 8 were no
// faster at 128^2, variants.py)
constexpr int kLapBand = 2;
constexpr int kLapWarps = 4;

template <int V>
__global__ void __launch_bounds__(32 * kLapWarps)
laplacian_rows_kernel(const float* __restrict__ u, float* __restrict__ out, int n, long long bands,
                      float inv_dx2) {
  constexpr int R = kLapBand / V > 0 ? kLapBand / V : 1;
  const int lane = threadIdx.x & 31;
  const int per_image = n / R;
  for (long long band = (long long)blockIdx.x * kLapWarps + (threadIdx.x >> 5); band < bands;
       band += (long long)gridDim.x * kLapWarps) {
    const long long img = band / per_image;
    const int y0 = (int)(band - img * per_image) * R;
    const long long plane = (long long)n * n;
    const float4* ub = reinterpret_cast<const float4*>(u + img * plane) + lane;
    float4* ob = reinterpret_cast<float4*>(out + img * plane) + lane;
    // rows y0 - 1 .. y0 + R, the first and last wrapped
    float4 r[R + 2][V];
#pragma unroll
    for (int k = 0; k < R + 2; ++k) {
      int y = y0 - 1 + k;
      y = y < 0 ? y + n : y >= n ? y - n : y;
#pragma unroll
      for (int c = 0; c < V; ++c) r[k][c] = __ldg(ub + (long long)y * (n / 4) + 32 * c);
    }
#pragma unroll
    for (int k = 1; k <= R; ++k)
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float4 up = r[k - 1][c], x = r[k][c], dn = r[k + 1][c];
        // column 4 (L + 32 c) - 1 is lane L - 1's .w; lane 0's is lane 31's of
        // chunk c - 1 (the wrap at c = 0), which lane 31 sends; the same on
        // the right with lane 0 sending chunk c + 1's .x to lane 31
        const float left = __shfl_sync(0xffffffffu, lane == 31 ? r[k][(c + V - 1) % V].w : x.w,
                                       (lane + 31) & 31);
        const float right = __shfl_sync(0xffffffffu, lane == 0 ? r[k][(c + 1) % V].x : x.x,
                                        (lane + 1) & 31);
        float4 o;
        o.x = (up.x + dn.x + left + x.y - 4.f * x.x) * inv_dx2;
        o.y = (up.y + dn.y + x.x + x.z - 4.f * x.y) * inv_dx2;
        o.z = (up.z + dn.z + x.y + x.w - 4.f * x.z) * inv_dx2;
        o.w = (up.w + dn.w + x.z + right - 4.f * x.w) * inv_dx2;
        ob[(long long)(y0 + k - 1) * (n / 4) + 32 * c] = o;
      }
  }
}

// blocks of the row route: the bands' blocks, at most one wave of the SMs
template <int V>
cudaError_t launch_laplacian_rows(const float* u, float* out, int B, int n, float inv_dx2,
                                  cudaStream_t st) {
  constexpr int R = kLapBand / V > 0 ? kLapBand / V : 1;
  static int wave = 0;  // blocks in one wave, asked once
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, laplacian_rows_kernel<V>,
                                                        32 * kLapWarps, 0);
    if (e != cudaSuccess) return e;
    wave = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long bands = (long long)B * (n / R);
  const long long need = (bands + kLapWarps - 1) / kLapWarps;
  const unsigned grid = (unsigned)(need < wave ? need : wave);
  laplacian_rows_kernel<V><<<grid, 32 * kLapWarps, 0, st>>>(u, out, n, bands, inv_dx2);
  return cudaSuccess;
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

// ---- K5b: the resident trajectory -------------------------------------------

constexpr int kR = 8;             // rows of a thread's patch
constexpr int kV = 4;             // columns of a thread's patch (one float4)
constexpr int kMaxThreads = 512;  // u, k1 and u1 of 32 points in registers
constexpr int kMaxCluster = 8;

struct Traj {
  const float* u0;  // (B, n, n)
  float* out;       // (B, S + 1, n, n): frame 0 = u0, then one a snapshot
  int S, inner;
  int rows;      // rows of a band: block q of an image owns [q rows, min((q + 1) rows, n))
  int npx, npy;  // patches across a row; patch rows of a full band
  Heat h;
};

// The band barrier in two halves: arrive once this thread's edges are out
// and its reads of the other set are done; wait before reading the
// neighbours' edges. Between the two a thread computes the rows of its
// patch that need no exchange. A cluster's barrier (barrier.cluster) cost
// ~0.8 us a step more than __syncthreads at one block an image on an H100,
// so one block an image uses __syncthreads at the wait and no arrive.
template <int CS>
__device__ __forceinline__ void band_arrive() {
  if constexpr (CS > 1) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
template <int CS>
__device__ __forceinline__ void band_wait() {
  if constexpr (CS > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  else __syncthreads();
}

// the same shared array of cluster block `rank` (of this block when CS = 1)
template <int CS, typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  if constexpr (CS == 1) return p;
  else return cg::this_cluster().map_shared_rank(p, rank);
}

// r[j] for a runtime j < kV, without indexing registers at run time
__device__ __forceinline__ float pick(const float (&r)[kV], int j) {
  float v = r[0];
#pragma unroll
  for (int jj = 1; jj < kV; ++jj)
    if (jj == j) v = r[jj];
  return v;
}

__device__ __forceinline__ float4 pick_row(const float (&x)[kR][kV], int i) {
  float4 v = make_float4(x[0][0], x[0][1], x[0][2], x[0][3]);
#pragma unroll
  for (int ii = 1; ii < kR; ++ii)
    if (ii == i) v = make_float4(x[ii][0], x[ii][1], x[ii][2], x[ii][3]);
  return v;
}

// What a thread knows of its patch: where it lies and what is valid. With
// kFull (n a multiple of kV, every band a multiple of kR rows) every patch
// is whole and the valid counts are constants.
struct Patch {
  int px, pxl, pxr;  // patch column and its left and right neighbours (periodic)
  int pidx, row0;    // index among the band's patches, first row in the band
  int mx, my;        // valid columns and rows
};

// A patch's edges into one set of exchange arrays: its top and bottom rows
// (the last valid one), and without shuffles its left and right columns.
template <bool kShfl, bool kFull>
__device__ __forceinline__ void put_edges(const float (&x)[kR][kV], const Patch& pt, int npx,
                                          float4* ET, float4* EB, float* EL, float* ER) {
  const int mx = kFull ? kV : pt.mx, my = kFull ? kR : pt.my;
  ET[pt.pidx] = pick_row(x, 0);
  EB[pt.pidx] = pick_row(x, my - 1);
  if (!kShfl) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      EL[(pt.row0 + i) * npx + pt.px] = x[i][0];
      ER[(pt.row0 + i) * npx + pt.px] = pick(x[i], mx - 1);
    }
  }
}

// One Heun stage over rows [I0, I1) of the patch x (u or u1), with the
// patch's neighbour rows up / dn (read only by rows 0 and my - 1) and its
// neighbour columns from shuffles or EL / ER. Stage 0: k = rhs(x),
// y = x + dt k (u1). Stage 1: y += half_dt (k + rhs(x)).
template <int STAGE, bool kReact, bool kShfl, bool kFull, int I0, int I1>
__device__ __forceinline__ void heun_rows(const float (&x)[kR][kV], float (&k)[kR][kV],
                                          float (&y)[kR][kV], const Heat& h, const Patch& pt,
                                          int npx, const float4* up, const float4* dn,
                                          const float* EL, const float* ER) {
  const int lane = threadIdx.x & 31;
  const int mx = kFull ? kV : pt.mx, my = kFull ? kR : pt.my;
  float upv[kV], dnv[kV];
  if (I0 == 0) {
    const float4 t = *up;
    upv[0] = t.x, upv[1] = t.y, upv[2] = t.z, upv[3] = t.w;
  }
  if (I1 == kR || !kFull) {
    const float4 t = *dn;
    dnv[0] = t.x, dnv[1] = t.y, dnv[2] = t.z, dnv[3] = t.w;
  }
#pragma unroll
  for (int i = I0; i < I1; ++i) {
    float lft, rgt;
    if (kShfl) {  // the warp is one row of 32 patches: lane - 1 and lane + 1, periodic
      lft = __shfl_sync(0xffffffffu, pick(x[i], mx - 1), (lane + 31) & 31);
      rgt = __shfl_sync(0xffffffffu, x[i][0], (lane + 1) & 31);
    } else {
      lft = ER[(pt.row0 + i) * npx + pt.pxl];
      rgt = EL[(pt.row0 + i) * npx + pt.pxr];
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float c = x[i][j];
      const float u_ = i > 0 ? x[i > 0 ? i - 1 : 0][j] : upv[j];
      const float d_ = i + 1 < my ? x[i + 1 < kR ? i + 1 : i][j] : dnv[j];
      const float l_ = j > 0 ? x[i][j > 0 ? j - 1 : 0] : lft;
      const float r_ = j + 1 < mx ? x[i][j + 1 < kV ? j + 1 : j] : rgt;
      const float r = rhs<kReact>(h, u_, d_, l_, r_, c);
      if (STAGE == 0) {
        k[i][j] = r;
        y[i][j] = c + h.dt * r;
      } else {
        y[i][j] = y[i][j] + h.half_dt * (k[i][j] + r);
      }
    }
  }
}

// A whole stage between the previous arrive and the next: with whole
// patches and shuffles the interior rows first (no exchange), then the
// wait, then the first and last rows; else the wait, then every row.
template <int CS, int STAGE, bool kReact, bool kShfl, bool kFull>
__device__ __forceinline__ void heun_stage(bool active, const float (&x)[kR][kV],
                                           float (&k)[kR][kV], float (&y)[kR][kV], const Heat& h,
                                           const Patch& pt, int npx, const float4* up,
                                           const float4* dn, const float* EL, const float* ER) {
  if constexpr (kShfl && kFull) {
    if (active) heun_rows<STAGE, kReact, kShfl, kFull, 1, kR - 1>(x, k, y, h, pt, npx, up, dn, EL, ER);
    band_wait<CS>();
    if (active) {
      heun_rows<STAGE, kReact, kShfl, kFull, 0, 1>(x, k, y, h, pt, npx, up, dn, EL, ER);
      heun_rows<STAGE, kReact, kShfl, kFull, kR - 1, kR>(x, k, y, h, pt, npx, up, dn, EL, ER);
    }
  } else {
    band_wait<CS>();
    if (active) heun_rows<STAGE, kReact, kShfl, kFull, 0, kR>(x, k, y, h, pt, npx, up, dn, EL, ER);
  }
}

// The whole trajectory of image blockIdx.x / CS: S snapshots of `inner`
// Heun steps, u resident in registers, the frames written from here.
template <int CS, bool kReact, bool kShfl, bool kFull>
__global__ void __launch_bounds__(kMaxThreads, 1) heat_traj_kernel(const Traj p) {
  extern __shared__ float4 smem4[];
  const int n = p.h.n, npx = p.npx, npy = p.npy;
  int q = 0;
  if constexpr (CS > 1) q = (int)cg::this_cluster().block_rank();
  const int img = blockIdx.x / CS;
  const int qp = (q + CS - 1) % CS, qn = (q + 1) % CS;  // the bands above and below
  const int rows_q = min(p.rows, n - q * p.rows);
  const int npy_q = (rows_q + kR - 1) / kR;
  const int npy_p = (min(p.rows, n - qp * p.rows) + kR - 1) / kR;
  const int t = threadIdx.x, py = t / npx;
  const bool active = py < npy_q;
  Patch pt;
  pt.px = t % npx;
  pt.pxl = (pt.px + npx - 1) % npx;
  pt.pxr = (pt.px + 1) % npx;
  pt.pidx = py * npx + pt.px;
  pt.row0 = py * kR;
  pt.mx = min(kV, n - kV * pt.px);
  pt.my = active ? min(kR, rows_q - pt.row0) : 1;
  const int c0 = kV * pt.px, g0 = q * p.rows + pt.row0;  // the patch's first column and row

  // two sets of exchange arrays: set 0 holds u's edges, set 1 u1's
  const int pe = npy * npx, le = npy * kR * npx;
  float4* ET[2] = {smem4, smem4 + 2 * pe};
  float4* EB[2] = {smem4 + pe, smem4 + 3 * pe};
  float* f = reinterpret_cast<float*>(smem4 + 4 * pe);
  float* EL[2] = {f, f + 2 * le};
  float* ER[2] = {f + le, f + 3 * le};
  // the rows above the patch's first and below its last: this band's
  // patches, or the last / first patch row of the neighbouring band
  const float4* up[2];
  const float4* dn[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    up[s] = py > 0 ? EB[s] + pt.pidx - npx : peer<CS>(EB[s], qp) + (npy_p - 1) * npx + pt.px;
    dn[s] = py + 1 < npy_q ? ET[s] + pt.pidx + npx : peer<CS>(ET[s], qn) + pt.px;
  }

  const long long plane = (long long)n * n;
  const float* ub = p.u0 + img * plane;
  float* ob = p.out + img * (p.S + 1) * plane;
  float u[kR][kV], k1[kR][kV], u1[kR][kV];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const bool ok = active && i < pt.my && j < pt.mx;
      u[i][j] = ok ? __ldg(ub + (long long)(g0 + i) * n + c0 + j) : 0.f;
    }
  auto frame = [&](int s) {
    if (!active) return;
    float* fr = ob + s * plane;
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kV; ++j)
        if (i < pt.my && j < pt.mx) fr[(long long)(g0 + i) * n + c0 + j] = u[i][j];
  };
  frame(0);
  if (active) put_edges<kShfl, kFull>(u, pt, npx, ET[0], EB[0], EL[0], ER[0]);
  band_arrive<CS>();
  for (int s = 1; s <= p.S; ++s) {
    for (int it = 0; it < p.inner; ++it) {
      // u1 = u + dt rhs(u); every read of u1's set (the last stage) is done
      heun_stage<CS, 0, kReact, kShfl, kFull>(active, u, k1, u1, p.h, pt, npx, up[0], dn[0], EL[0],
                                          ER[0]);
      if (active) put_edges<kShfl, kFull>(u1, pt, npx, ET[1], EB[1], EL[1], ER[1]);
      band_arrive<CS>();
      // u += half_dt (k1 + rhs(u1)); every read of u's set is done
      heun_stage<CS, 1, kReact, kShfl, kFull>(active, u1, k1, u, p.h, pt, npx, up[1], dn[1], EL[1],
                                          ER[1]);
      if (active) put_edges<kShfl, kFull>(u, pt, npx, ET[0], EB[0], EL[0], ER[0]);
      band_arrive<CS>();
    }
    frame(s);
  }
  band_wait<CS>();  // no block leaves while a peer may still read its edges
}

// The resident kernel's layout for n in clusters of cs blocks; false when
// a band does not fit.
struct TrajPlan {
  int cs, rows, npx, npy, threads, smem;
  bool shfl, full;
};

bool plan_traj(int n, int cs, TrajPlan& tp) {
  tp.cs = cs;
  tp.rows = (n + cs - 1) / cs;
  tp.npx = (n + kV - 1) / kV;
  tp.npy = (tp.rows + kR - 1) / kR;
  tp.shfl = tp.npx == 32;
  tp.full = n % kV == 0 && tp.rows % kR == 0 && (n - (cs - 1) * tp.rows) % kR == 0;
  tp.threads = (tp.npx * tp.npy + 31) / 32 * 32;
  tp.smem = 2 * 2 * tp.npy * tp.npx * 16 + (tp.shfl ? 0 : 2 * 2 * tp.npy * kR * tp.npx * 4);
  return (cs - 1) * tp.rows < n && tp.npx * tp.npy <= kMaxThreads && tp.smem <= 227 * 1024;
}

// cluster = 0: the smallest cluster whose band fits, else that size
int choose_cluster(int n, int cluster, TrajPlan& tp) {
  if (n < 1) return 0;
  for (int cs = 1; cs <= kMaxCluster; cs *= 2)
    if ((cluster == 0 || cluster == cs) && plan_traj(n, cs, tp)) return cs;
  return 0;
}

template <int CS, bool kReact, bool kShfl, bool kFull>
cudaError_t launch_traj(const Traj& p, const TrajPlan& tp, int B, cudaStream_t st) {
  auto kern = heat_traj_kernel<CS, kReact, kShfl, kFull>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       tp.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * CS, 1, 1);
  cfg.blockDim = dim3(tp.threads, 1, 1);
  cfg.dynamicSmemBytes = tp.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, p);
}

template <int CS, bool kReact>
cudaError_t launch_traj_r(const Traj& p, const TrajPlan& tp, int B, cudaStream_t st) {
  if (tp.shfl && tp.full) return launch_traj<CS, kReact, true, true>(p, tp, B, st);
  if (tp.shfl) return launch_traj<CS, kReact, true, false>(p, tp, B, st);
  if (tp.full) return launch_traj<CS, kReact, false, true>(p, tp, B, st);
  return launch_traj<CS, kReact, false, false>(p, tp, B, st);
}

template <int CS>
cudaError_t launch_traj_cs(const Traj& p, const TrajPlan& tp, int B, cudaStream_t st) {
  if (p.h.react != 0.f) return launch_traj_r<CS, true>(p, tp, B, st);
  return launch_traj_r<CS, false>(p, tp, B, st);
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

// out = periodic 5-point Laplacian of u, both (B, n, n) contiguous: the row
// route for n = 128, 256, 512 with both 16-byte aligned, else the general
// route; one launch either way.
int stencil_laplacian(const float* u, float* out, int B, int n, float inv_dx2, void* stream,
                      int* launched) {
  if (B < 1 || B > 65535 || n < 1) return invalid(launched);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (aligned && n == 128) e = launch_laplacian_rows<1>(u, out, B, n, inv_dx2, st);
  else if (aligned && n == 256) e = launch_laplacian_rows<2>(u, out, B, n, inv_dx2, st);
  else if (aligned && n == 512) e = launch_laplacian_rows<4>(u, out, B, n, inv_dx2, st);
  else {
    const dim3 grid((n + kThreadsX - 1) / kThreadsX, (n + kThreadsY - 1) / kThreadsY, B);
    laplacian_kernel<<<grid, dim3(kThreadsX, kThreadsY), 0, st>>>(u, out, n, inv_dx2);
  }
  if (e != cudaSuccess) {
    if (launched != nullptr) *launched = 0;
    return (int)e;
  }
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

// The cluster size the resident trajectory kernel takes for n (cluster = 0:
// its default, else that size if it fits), 0 when it cannot hold the image.
int stencil_heat_resident_cluster(int n, int cluster) {
  TrajPlan tp;
  return choose_cluster(n, cluster, tp);
}

// The heat trajectory in ONE launch: out (B, S+1, n, n) gets u0 as frame 0
// and the state after each of S snapshots of `inner` Heun steps; u0 (B, n,
// n) is only read. cluster as in stencil_heat_resident_cluster; an n it
// cannot hold is refused (the caller takes the tiled route).
int stencil_heat_trajectory(const float* u0, float* out, int B, int n, int S, int inner,
                            float dt, float half_dt, float diff, float react, float inv_dx2,
                            int cluster, void* stream, int* launched) {
  TrajPlan tp;
  const int cs = choose_cluster(n, cluster, tp);
  if (cs == 0 || B < 1 || B > 65535 || S < 0 || inner < 1) return invalid(launched);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Traj p{u0, out, S, inner, tp.rows, tp.npx, tp.npy,
               Heat{n, dt, half_dt, diff, react, inv_dx2}};
  cudaError_t e;
  switch (cs) {
    case 1: e = launch_traj_cs<1>(p, tp, B, st); break;
    case 2: e = launch_traj_cs<2>(p, tp, B, st); break;
    case 4: e = launch_traj_cs<4>(p, tp, B, st); break;
    default: e = launch_traj_cs<8>(p, tp, B, st); break;
  }
  if (e != cudaSuccess) {
    if (launched != nullptr) *launched = 0;
    return (int)e;
  }
  return finish(1, launched);
}

}  // extern "C"
