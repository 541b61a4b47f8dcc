// Hand-written Chorin projection stepper for Hopper (sm_90a): one
// cluster-resident launch per call.
//
// Replaces the Pallas TPU kernel
//   pregen_pde_tpu/solvers/ns_projection_pallas.py::build_batched_traj
// (kernel body `make_kernel`), whose meaning is ProjectionSolver.step
// iterated as in make_trajectory_fn, with the direct (DCT eigen) pressure
// solve. One step on (u, v), per image b, with its own u_max, dt and step
// count:
//   u*, v*  = (q + dt (-(u q_x + v q_y) + nu lap q)) pen,  pen = 1/(1 + dt mask/eta)
//             (MUSCL van Leer or first-order upwind advection, edge-
//             replicated shifts), then the BCs
//   rhs     = -(Dx u* + Dy v* - [x == 0] inlet u_max / dx) / dt   (zero-ghost D)
//   p       = CY^T ((CY rhs CX^T) / denom) CX    (p_hat[0,0] = 0 for the cavity)
//   u, v    = BC(u* - dt Gx p, v* - dt Gy p) pen  (channel: Gx = -2p/dx at x = n-1)
// Channel: DCT-II along y (CY), DCT-IV along x (CX); cavity: DCT-II on both.
// The left multiply acts along y, the right along x.
//
// Design. The TPU kernel keeps (u, v, p) resident in VMEM for the whole
// loop and writes to HBM once per snapshot. One SM's 227 KB cannot hold a
// 128^2 image with its scratch, so here each image is held by a thread-block
// cluster of n/16 blocks: block r owns rows y0 = 16r .. 16r+15 of every
// plane (u and v with halo rows and ghost columns, u*, v*, pen, rhs/R split
// into hi and lo, T1, T2, p) and its rows of CY and CY^T, all in dynamic
// shared memory (104 KB at n = 128, 206 KB at n = 256). The cluster loops
// over all snapshots and steps of its image in the kernel and writes frame
// 0 and each (u, v, p) frame straight into out[b, s] (or into channels 0:3
// of a caller's 6-channel contract, at the row the caller gives image b);
// nothing else goes to device memory. A call is ONE launch: grid (n/16, B),
// cluster (n/16, 1, 1), so images with different dt and step counts share it and an image that
// goes non-finite touches no other. A block has 512 threads (one block an
// SM) while the batch fits the card at once, and at n <= 128 256 threads
// (two blocks an SM, twice the clusters resident) when it does not.
//
// A step, with its cluster barriers (cluster.sync(): arrive.release +
// wait.acquire), four in all:
//   1. halo: rows y0-3 .. y0-1, y0+16, y0+17 of u, v copied from the
//      neighbours' shared memory (DSMEM) into the local halo rows;
//      predictor + BCs -> u*, v* on the own rows, and v* on row y0-1
//      (computed twice in the cluster, so the divergence needs no
//      barrier); divergence -> rhs; T1 = rhs CX^T, local             | B
//   2. R = (CY T1) / denom over T1 gathered from every block (DSMEM; the
//      rows of T1 are the product's k dimension); T2 = R CX, local    | C
//   3. p = CY^T T2, T2 gathered the same way                        | D
//   4. correction + BCs + pen -> u, v (row y0+16 of p over DSMEM)   | E
// T1 and T2 are separate buffers because a peer may still read T1 while
// this block writes T2; R reuses rhs (read only locally). Every hazard on a
// buffer a peer reads is separated by at least one of B-E; a last cluster
// barrier keeps every block alive until its peers are done reading it.
// Why a gather and not a transpose of ownership: each warp reads the B
// fragments of its own output tiles straight from the peer's shared memory
// into registers, a few k-steps ahead of the multiply, so the products need
// no staging buffer and no block barrier; the x-direction products read
// their B fragments from the bases in L2 the same way.
//
// The four DCT products on tensor cores at float32 accuracy: a block's 16
// rows are exactly the M of mma.sync.aligned.m16n8k8 (TF32; wgmma's 64-row
// tile does not fit a 16-row slice). Each operand is split a = a_hi + a_lo,
// a_hi = rna.tf32(a), a_lo = rna.tf32(a - a_hi), and the product is
// a_hi b_hi + (a_lo b_hi + a_hi b_lo) in float32 accumulators (3xTF32; the
// two terms in brackets in a register set of their own). The rounding is
// cvt.rna.tf32's, done with an add and a mask: the cvt instruction issues
// at a quarter of the ALU rate and bounded the products. rhs and R are
// split once by the threads that write them, the B operands as they are
// loaded. Warp w owns the 8-column tiles w, w + warps, ...; the B operands
// (the bases in L2, T1 and T2 in the peers) are kept in fragment order, so
// a warp reads a tile's two k-steps as one 512-byte load, and A's row
// stride n+4 makes its fragment loads conflict-free.
//
// The predictor: each thread walks down one column over a strip of rows,
// keeping the column's five rows and three y slopes in registers (one load
// and one van Leer slope a row a plane). The ghost columns and the halo
// rows beyond the image hold copies of its edge, so no index is clamped.
//
// Precision: the chain's float32 solve, rebuilt as 3xTF32 (about float32's
// 24 bits per product; a single TF32 pass keeps three digits, far above
// the pressure solve's floor). The cavity's rhs mean is not subtracted: the
// constant vector is the DCT-II zero mode, orthogonal to every other basis
// vector, and p_hat[0,0] is set to 0, so the mean changes nothing but
// roundoff. The stencils multiply by the float32 reciprocals of dx, dx^2,
// dt and denom where the plain version divides (within an ulp), and the van
// Leer quotient is __fdividef (2 ulp): an IEEE division takes a slow path
// for a zero numerator, which the masked flow has at every solid cell.
//
// What bounds a step on the H100: a step is latency bound, one cluster's
// serial chain of phases on n/16 SMs; the four products take about half of
// it, the predictor and the four cluster barriers (with the wait for the
// slowest block) most of the rest (profile_k2 part 4 reads clock64 per
// phase from a -DNSP_PHASE_CLOCKS build; PERF.md section 5). The work
// bound is the products' 8 n^3 FLOP per image-step (16.8 MFLOP at 128^2;
// 3x that on the tensor cores). Device memory is touched only for the
// bases (from L2) and the frames.
//
// Grids: n a multiple of 32, 32 <= n <= 256; n > 128 needs a non-portable
// cluster of up to 16 blocks, and nsp_traj returns kNotResident when the
// card cannot hold one such cluster (cudaOccupancyMaxActiveClusters = 0).
// The kernel launches on the caller's stream, never synchronises and
// allocates nothing; nsp_traj returns cudaGetLastError() and reports the
// kernels it enqueued (`launched`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 16;      // rows of an image a block owns
constexpr int kNotResident = -2;

struct Args {
  int B, S;                     // images, snapshots
  int channel;                  // 1 = channel (FPO), 0 = cavity (LDC)
  int muscl;                    // 1 = MUSCL (van Leer), 0 = first-order upwind
  float nu, eta, dx, dx2;       // dx2 = dx*dx rounded once from double
  float inv_dx, inv_dx2;        // their float32 reciprocals
  const float* mask;            // (B, n, n)
  const float* umax;            // (B)
  const float* dt;              // (B) float32
  const int* steps;             // (B) inner steps per snapshot
  const float* inlet;           // (n) unit parabolic profile
  const float* cy;              // (n, n) bases, read from L2
  const float* cyT;
  const float4* cx_frag;         // CX, CX^T in fragment order (BasisB)
  const float4* cxT_frag;
  const float* inv_denom;       // (n, n): 1/denom, rounded once from float64
  float* out;                   // (rows, S+1, n, n, out_c): (u, v, p) in channels 0:3
  const int* out_rows;          // (B) the row of out image b writes; null: row b
  int out_c;                    // channels of out (>= 3): its channel stride
};

// Shared-memory layout of one block (floats), the same in every block of a
// cluster so that map_shared_rank finds a peer's planes at the same offset.
template <int N>
struct Smem {
  static constexpr int C = N / kRows;      // blocks in the cluster
  static constexpr int SA = N + 4;         // row stride of the A operands
  static constexpr int TILES = N / 8;      // 8-column output tiles
  static constexpr int W = N + 4;          // row stride of U, V (ghost columns)
  static constexpr int U = 0;                  // (21, W): rows y0-3 .. y0+17
  static constexpr int V = U + 21 * W;
  static constexpr int VSUP = V + 21 * W;      // (N): v* of row y0-1
  static constexpr int PENUP = VSUP + N;       // (N): pen of row y0-1
  static constexpr int US = PENUP + N;         // (16, N)
  static constexpr int VS = US + kRows * N;
  static constexpr int PEN = VS + kRows * N;
  static constexpr int P = PEN + kRows * N;
  static constexpr int T1 = P + kRows * N;     // 16 x N, fragment order:
  static constexpr int T2 = T1 + kRows * N;    // the peers' B operands
  static constexpr int RH = T2 + kRows * N;    // (16, SA) x 2: rhs, then R,
  static constexpr int RL = RH + kRows * SA;   //   split into hi and lo
  static constexpr int CYR = RL + kRows * SA;  // (16, SA): rows of CY
  static constexpr int CYTR = CYR + kRows * SA;  // rows of CY^T
  static constexpr int FLOATS = CYTR + kRows * SA;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(N % 32 == 0 && N >= 32 && N <= 256, "n");
  static_assert(BYTES <= 232448, "shared memory");
};

// ---- tensor cores: 3xTF32 m16n8k8 -----------------------------------------

// cvt.rna.tf32.f32 done on the integer pipe: add half of the 13 dropped
// bits to the magnitude and clear them (round to nearest, ties away from
// zero). The cvt instruction itself issues at a quarter of the ALU rate and
// was what bounded the products (PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B operands in fragment order: for the k-pair kp (k = 16kp .. 16kp+15),
// the 8-column tile j and lane = 4g + t, one float4 holds
//   (B[16kp+t][8j+g], B[16kp+t+4][8j+g], B[16kp+8+t][8j+g], B[16kp+12+t][8j+g]),
// the lane's B fragments of the two k-steps of the pair, so a warp reads a
// tile's k-pair as one coalesced 512-byte load.
__host__ __device__ constexpr int frag_index(int r, int c) {
  // element (r, c) of a 16-row slab: its float in the fragment-ordered slab
  return (((c >> 3) * 32 + (c & 7) * 4 + (r & 3)) << 2) + ((r >> 3) << 1) + ((r >> 2) & 1);
}

__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// A global basis in fragment order (the wrapper lays it out), read through
// L2 (x-direction products): k-pair kp is rows 16kp .. 16kp+15.
template <int N>
struct BasisB {
  const float4* f;
  __device__ __forceinline__ float4 operator()(int kp, int tile, int lane) const {
    return __ldg(f + (kp * (N / 8) + tile) * 32 + lane);
  }
  __device__ __forceinline__ int kcol(int kp) const { return 16 * kp; }
};

// T gathered over DSMEM (y-direction products): k-pair i is peer q = (rank +
// i) mod C's fragment-ordered 16-row slab, so the blocks of a cluster start
// on different peers.
template <int N>
struct PeerB {
  uint32_t slab;  // shared-window address of this block's slab
  int rank;
  __device__ __forceinline__ int peer(int kp) const { return (rank + kp) % Smem<N>::C; }
  __device__ __forceinline__ float4 operator()(int kp, int tile, int lane) const {
    return ld_cluster_v4(mapa(slab + ((tile * 32 + lane) << 4), peer(kp)));
  }
  __device__ __forceinline__ int kcol(int kp) const { return 16 * peer(kp); }
};

// acc = A (16 x N in shared memory, stride SA) . B (N x N from `ld`) for this
// warp's tiles. No block barrier: every warp reads its own B fragments
// straight into registers, kDepth k-pairs ahead of the multiply, and A from
// shared memory. The hi.hi products and the two correction products
// accumulate in separate registers (two independent mma chains) and are
// summed at the end.
// A operands: the lane's m16n8k8 A fragment of columns k .. k+7, split.
// Raw float32 rows in shared memory, split here (the rows of CY, CY^T)...
template <int N>
struct ARaw {
  const float* a;
  __device__ __forceinline__ void operator()(int k, int g, int t, uint32_t ah[4],
                                             uint32_t al[4]) const {
    const float* q = a + k + t;
    split_tf32(q[g * Smem<N>::SA], ah[0], al[0]);
    split_tf32(q[(g + 8) * Smem<N>::SA], ah[1], al[1]);
    split_tf32(q[g * Smem<N>::SA + 4], ah[2], al[2]);
    split_tf32(q[(g + 8) * Smem<N>::SA + 4], ah[3], al[3]);
  }
};

// ... or split once by their producer into hi and lo planes (rhs and R),
// so the eight warps that read them do not each split them again
template <int N>
struct ASplit {
  const float* hi;
  const float* lo;
  __device__ __forceinline__ void operator()(int k, int g, int t, uint32_t ah[4],
                                             uint32_t al[4]) const {
    const int o[4] = {g * Smem<N>::SA + k + t, (g + 8) * Smem<N>::SA + k + t,
                      g * Smem<N>::SA + k + t + 4, (g + 8) * Smem<N>::SA + k + t + 4};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ah[j] = __float_as_uint(hi[o[j]]);
      al[j] = __float_as_uint(lo[o[j]]);
    }
  }
};

__device__ __forceinline__ void store_split(float* hi, float* lo, int i, float v) {
  const uint32_t h = tf32_rna(v);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(tf32_rna(v - __uint_as_float(h)));
}

template <int N, int T, class LoadA, class LoadB>
__device__ __forceinline__ void product(const LoadA& lda, const LoadB& ld, float acc[][4],
                                        int warp, int lane) {
  using L = Smem<N>;
  constexpr int kWarps = T / 32;
  constexpr int TPW = (L::TILES + kWarps - 1) / kWarps;
  constexpr int KP = N / 16;
  constexpr int kDepth = KP < 2 ? KP : 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  float small[TPW][4];
  float4 bq[kDepth][TPW];
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    small[i][0] = small[i][1] = small[i][2] = small[i][3] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
#pragma unroll
    for (int i = 0; i < TPW; ++i)
      if (warp + kWarps * i < L::TILES) bq[d][i] = ld(d, warp + kWarps * i, lane);
#pragma unroll
  for (int kp = 0; kp < KP; ++kp) {
    float4 b[TPW];
#pragma unroll
    for (int i = 0; i < TPW; ++i) b[i] = bq[kp % kDepth][i];
    if (kp + kDepth < KP) {
#pragma unroll
      for (int i = 0; i < TPW; ++i)
        if (warp + kWarps * i < L::TILES) bq[kp % kDepth][i] = ld(kp + kDepth, warp + kWarps * i, lane);
    }
    const int k0 = ld.kcol(kp);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t ah[4], al[4];
      lda(k0 + 8 * h, g, t, ah, al);
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        if (warp + kWarps * i < L::TILES) {  // warp-uniform
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(h ? b[i].z : b[i].x, bh0, bl0);
          split_tf32(h ? b[i].w : b[i].y, bh1, bl1);
          mma_tf32(small[i], al, bh0, bh1);
          mma_tf32(small[i], ah, bl0, bl1);
          mma_tf32(acc[i], ah, bh0, bh1);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += small[i][j];
}

// 1/denom at this lane's accumulator positions of rows row0 .. row0+15,
// loaded before R's product so that its latency hides behind it
template <int N, int T>
__device__ __forceinline__ void load_inv_denom(const float* inv_denom, int row0, int warp,
                                               int lane, float dv[][4]) {
  using L = Smem<N>;
  constexpr int kWarps = T / 32;
  constexpr int TPW = (L::TILES + kWarps - 1) / kWarps;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tile = warp + kWarps * i;
    if (tile >= L::TILES) continue;
    const int col = tile * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* d = inv_denom + (long long)(row0 + (lane >> 2) + 8 * h) * N + col;
      dv[i][2 * h] = __ldg(d);
      dv[i][2 * h + 1] = __ldg(d + 1);
    }
  }
}

// the accumulators into a (16, stride) plane, or into a fragment-ordered
// slab when stride is 0 (T1, T2: the peers' B operands); R's epilogue
// (dv != nullptr) multiplies by 1/denom, zeroes the cavity's [0, 0] mode
// and stores R split into dst (hi) and lo
template <int N, int T>
__device__ __forceinline__ void store_acc(float acc[][4], float* dst, int stride, int warp,
                                          int lane, float (*dv)[4] = nullptr, int row0 = 0,
                                          bool zero_mode = false, float* lo = nullptr) {
  using L = Smem<N>;
  constexpr int kWarps = T / 32;
  constexpr int TPW = (L::TILES + kWarps - 1) / kWarps;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tile = warp + kWarps * i;
    if (tile >= L::TILES) continue;
    const int col = tile * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      float v0 = acc[i][2 * h];
      float v1 = acc[i][2 * h + 1];
      if (dv != nullptr) {
        v0 = v0 * dv[i][2 * h];
        v1 = v1 * dv[i][2 * h + 1];
        if (zero_mode && row0 + r == 0 && col == 0) v0 = 0.f;
      }
      if (stride == 0) {
        dst[frag_index(r, col)] = v0;
        dst[frag_index(r, col + 1)] = v1;
      } else if (lo != nullptr) {
        store_split(dst, lo, r * stride + col, v0);
        store_split(dst, lo, r * stride + col + 1, v1);
      } else {
        dst[r * stride + col] = v0;
        dst[r * stride + col + 1] = v1;
      }
    }
  }
}

// ---- the stencils -----------------------------------------------------------

// u and v are held with three halo rows above the block's rows and two
// below, and two ghost columns on each side (row stride W = N + 4): global
// (y, x) lives at local [(y - y0 + 3) W + x + 2]. Rows and columns beyond
// the image hold copies of its edge, so every shift of the stencils is a
// fixed offset and no index is clamped: edge replication of the field, and
// of the van Leer slope field (the slope of an edge cell and of a ghost
// cell beyond it are both 0).
template <int N>
struct Ext {
  const float* q;  // the point
  __device__ __forceinline__ float operator()(int dy, int dx) const {
    return q[dy * Smem<N>::W + dx];
  }
};

// van Leer slope of the point with neighbours (qm, q, qp)
__device__ __forceinline__ float vl_slope(float qm, float q, float qp) {
  const float a = qp - q;
  const float b = q - qm;
  const float ab = a * b;
  return ab > 0.f ? __fdividef(2.f * ab, a + b) : 0.f;
}

// upwind derivative of plane q at the point along x w.r.t. the carrier
// velocity vel (along y: Column::grad_y)
template <int N>
__device__ __forceinline__ float grad_x(const Ext<N>& q, float vel, int muscl, float inv_dx) {
  const float q0 = q(0, 0);
  const float qm1 = q(0, -1);
  const float qp1 = q(0, 1);
  const float a = qp1 - q0;
  const float b = q0 - qm1;
  if (!muscl) return (vel > 0.f ? b : a) * inv_dx;
  const float s_m1 = vl_slope(q(0, -2), qm1, q0);
  const float s_p1 = vl_slope(q0, qp1, q(0, 2));
  const float slope = vl_slope(qm1, q0, qp1);
  if (vel > 0.f) return (b + 0.5f * (slope - s_m1)) * inv_dx;
  return (a - 0.5f * (s_p1 - slope)) * inv_dx;
}

// One column of a plane seen by a thread that walks down it: rows r-2 ..
// r+2 and the van Leer slopes along y at r-1, r, r+1 (slopes only for
// MUSCL). Each step down loads one row and computes one slope.
template <int N>
struct Column {
  const float* q;  // the column at row r
  float m2, m1, c, p1, p2, sm1, s0, sp1;
  __device__ __forceinline__ void init(const float* at, int muscl) {
    constexpr int W = Smem<N>::W;
    q = at;
    m2 = q[-2 * W];
    m1 = q[-W];
    c = q[0];
    p1 = q[W];
    p2 = q[2 * W];
    if (muscl) {
      sm1 = vl_slope(m2, m1, c);
      s0 = vl_slope(m1, c, p1);
      sp1 = vl_slope(c, p1, p2);
    }
  }
  __device__ __forceinline__ void advance(int muscl) {
    q += Smem<N>::W;
    m2 = m1;
    m1 = c;
    c = p1;
    p1 = p2;
    p2 = q[2 * Smem<N>::W];
    if (muscl) {
      sm1 = s0;
      s0 = sp1;
      sp1 = vl_slope(c, p1, p2);
    }
  }
  // the upwind derivative along y w.r.t. the carrier velocity vel
  __device__ __forceinline__ float grad_y(float vel, int muscl, float inv_dx) const {
    const float a = p1 - c;
    const float b = c - m1;
    if (!muscl) return (vel > 0.f ? b : a) * inv_dx;
    if (vel > 0.f) return (b + 0.5f * (s0 - sm1)) * inv_dx;
    return (a - 0.5f * (sp1 - s0)) * inv_dx;
  }
  __device__ __forceinline__ float laplacian(float inv_dx2) const {
    return (p1 + m1 + q[1] + q[-1] - 4.f * c) * inv_dx2;
  }
};

// (u*, v*) at the point before the BCs: the explicit update times pen
template <int N>
__device__ __forceinline__ void predict_point(const Args& s, float dt, const Column<N>& u,
                                              const Column<N>& v, float pen, float& us,
                                              float& vs) {
  const Ext<N> ux{u.q};
  const Ext<N> vx{v.q};
  const float uu = u.c;
  const float vv = v.c;
  const float adv_u = uu * grad_x<N>(ux, uu, s.muscl, s.inv_dx) +
                      vv * u.grad_y(vv, s.muscl, s.inv_dx);
  const float adv_v = uu * grad_x<N>(vx, uu, s.muscl, s.inv_dx) +
                      vv * v.grad_y(vv, s.muscl, s.inv_dx);
  us = (uu + dt * (-adv_u + s.nu * u.laplacian(s.inv_dx2))) * pen;
  vs = (vv + dt * (-adv_v + s.nu * v.laplacian(s.inv_dx2))) * pen;
}

// pen = 1/(1 + dt mask/eta) at (y, x) of image offset img
template <int N>
__device__ __forceinline__ float pen_at(const Args& s, float dt, long long img, int y, int x) {
  return 1.f / (1.f + dt * __ldg(s.mask + img + (long long)y * N + x) / s.eta);
}

// ---- the kernel ---------------------------------------------------------------

// Phase clocks for profile_k2 (built with -DNSP_PHASE_CLOCKS only): block
// 0 of image 0 adds the SM cycles of each phase of every step to
// nsp_phase_cycles[k], read back by nsp_phase_clocks. Otherwise nothing.
#ifdef NSP_PHASE_CLOCKS
__device__ unsigned long long nsp_phase_cycles[16];
#define NSP_PHASE_START unsigned long long nsp_t_ = clock64()
#define NSP_PHASE(k)                                                       \
  if (tid == 0 && b == 0 && rank == 0) {                                   \
    const unsigned long long c_ = clock64();                               \
    nsp_phase_cycles[k] += c_ - nsp_t_;                                    \
    nsp_t_ = c_;                                                           \
  }
#else
#define NSP_PHASE_START
#define NSP_PHASE(k)
#endif

// T threads a block: 256 with two blocks an SM (n <= 128), or 512 with one;
// either way <= 128 registers a thread
template <int N, int T>
__global__ void __launch_bounds__(T, 512 / T)
nsp_cluster_kernel(const Args s) {
  using L = Smem<N>;
  constexpr int kThreads = T;
  static_assert(T >= N, "a thread a column in the predictor");
  // the predictor's strips: T / N threads down each column, kStrip rows each
  constexpr int kStrips = T / N;
  constexpr int kStrip = (kRows + 1 + kStrips - 1) / kStrips;
  constexpr int TPW = (L::TILES + T / 32 - 1) / (T / 32);
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int y0 = rank * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long img = (long long)b * N * N;

  float* U = smem + L::U;
  float* V = smem + L::V;
  float* VSUP = smem + L::VSUP;
  float* PENUP = smem + L::PENUP;
  float* US = smem + L::US;
  float* VS = smem + L::VS;
  float* PEN = smem + L::PEN;
  float* P = smem + L::P;
  float* T1 = smem + L::T1;
  float* T2 = smem + L::T2;
  float* RH = smem + L::RH;
  float* RL = smem + L::RL;
  float* CYR = smem + L::CYR;
  float* CYTR = smem + L::CYTR;

  const float dt = s.dt[b];
  const float inv_dt = 1.f / dt;
  const int steps = s.steps[b];
  const float um = s.umax[b];

  // own row r, column x of u and v, and the ghost copies of an edge column
  auto set_uv = [&](float* Up, float* Vp, int r, int x, float u, float v) {
    float* pu = Up + (r + 3) * L::W + x + 2;
    float* pv = Vp + (r + 3) * L::W + x + 2;
    pu[0] = u;
    pv[0] = v;
    if (x == 0 || x == N - 1) {
      const int d = x == 0 ? -1 : 1;
      pu[d] = pu[2 * d] = u;
      pv[d] = pv[2 * d] = v;
    }
  };

  // rest + BCs (make_trajectory_fn's initial state), pen, the basis rows
  for (int e = tid; e < kRows * N; e += kThreads) {
    const int r = e / N;
    const int x = e - r * N;
    const int y = y0 + r;
    float u = 0.f;
    if (s.channel) {
      // the outflow copy of column n-2 is 0 at rest
      if (y > 0 && y < N - 1 && x == 0) u = __ldg(s.inlet + y) * um;
    } else if (y == N - 1) {
      u = um;
    }
    set_uv(U, V, r, x, u, 0.f);
    P[e] = 0.f;
    PEN[e] = pen_at<N>(s, dt, img, y, x);
    if (r == 0 && y > 0) PENUP[x] = pen_at<N>(s, dt, img, y - 1, x);
    CYR[r * L::SA + x] = __ldg(s.cy + (long long)y * N + x);
    CYTR[r * L::SA + x] = __ldg(s.cyT + (long long)y * N + x);
  }
  float acc[TPW][4];
  float dv[TPW][4];

  const long long row = s.out_rows != nullptr ? __ldg(s.out_rows + b) : b;
  auto write_frame = [&](int f) {
    float* o = s.out + (((row * (s.S + 1) + f) * N + y0) * N) * s.out_c;
    for (int e = tid; e < kRows * N * 3; e += kThreads) {
      const int pt = e / 3;
      const int c = e - pt * 3;
      const int r = pt / N;
      const int x = pt - r * N;
      const int i = (r + 3) * L::W + x + 2;
      o[pt * s.out_c + c] = c == 0 ? U[i] : (c == 1 ? V[i] : P[pt]);
    }
  };
  // rows y0-3 .. y0-1, y0+16, y0+17 of u, v (ghost columns included) from
  // their owners; beyond the image, copies of its edge row
  auto fill_halo = [&]() {
    for (int e = tid; e < 5 * L::W; e += kThreads) {
      const int h = e / L::W;
      const int x = e - h * L::W;
      const int lr = h < 3 ? h : h + kRows;        // local row 0-2, 19, 20
      const int y = min(max(y0 - 3 + lr, 0), N - 1);
      const int q = y / kRows;
      const int off = (y - q * kRows + 3) * L::W + x;
      U[lr * L::W + x] = *cluster.map_shared_rank(U + off, q);
      V[lr * L::W + x] = *cluster.map_shared_rank(V + off, q);
    }
  };

  __syncthreads();
  write_frame(0);
  cluster.sync();
  fill_halo();
  __syncthreads();

  const bool zero_mode = !s.channel && rank == 0;
  const uint32_t t1_addr = static_cast<uint32_t>(__cvta_generic_to_shared(T1));
  const uint32_t t2_addr = static_cast<uint32_t>(__cvta_generic_to_shared(T2));
  const float* p_down = rank + 1 < L::C ? cluster.map_shared_rank(P, rank + 1) : nullptr;

  NSP_PHASE_START;
  for (int f = 1; f <= s.S; ++f) {
    for (int it = 0; it < steps; ++it) {
      NSP_PHASE(0);  // the snapshot's frame, the loop
      // 1. predictor + BCs, in apply_velocity_bc's set order (corners match),
      // on the own rows and, for the divergence, on row y0-1 (v* only kept).
      // Thread tid walks down column tid mod N over one strip of rows.
      {
        const int x = tid % N;
        const int rb0 = -1 + (tid / N) * kStrip;
        const int rb = rank > 0 ? rb0 : max(rb0, 0);
        const int re = min(rb0 + kStrip, kRows);
        // the outflow column copies the prediction at column n-2
        const int xx = s.channel && x == N - 1 ? N - 2 : x;
        Column<N> cu, cv;
        if (tid < kStrips * N && rb < re) {
          cu.init(U + (rb + 3) * L::W + xx + 2, s.muscl);
          cv.init(V + (rb + 3) * L::W + xx + 2, s.muscl);
        }
        for (int r = rb; tid < kStrips * N && r < re; ++r) {
          if (r > rb) {
            cu.advance(s.muscl);
            cv.advance(s.muscl);
          }
          const int y = y0 + r;
          float us = 0.f, vs = 0.f;
          const bool walls = s.channel ? (y == 0 || y == N - 1)
                                       : (y == 0 || y == N - 1 || x == 0 || x == N - 1);
          if (!s.channel && y == N - 1) {
            us = um;                              // moving lid, set last
          } else if (walls) {
          } else if (s.channel && x == 0) {
            us = __ldg(s.inlet + y) * um;         // inlet
          } else {
            const float pen = r >= 0 ? PEN[r * N + xx] : PENUP[xx];
            predict_point<N>(s, dt, cu, cv, pen, us, vs);
          }
          if (r >= 0) {
            US[r * N + x] = us;
            VS[r * N + x] = vs;
          } else {
            VSUP[x] = vs;
          }
        }
      }
      __syncthreads();

      NSP_PHASE(1);  // predictor
      // 2. rhs = -div / dt, flux-form divergence with zero ghosts and the
      // inlet fix; then T1 = rhs CX^T
      for (int e = tid; e < kRows * N; e += kThreads) {
        const int r = e / N;
        const int x = e - r * N;
        const int y = y0 + r;
        const float u0 = US[e];
        const float v0 = VS[e];
        const float uw = x > 0 ? US[e - 1] : 0.f;
        const float vsn = r > 0 ? VS[e - N] : (y > 0 ? VSUP[x] : 0.f);
        float div = (u0 - uw) * s.inv_dx + (v0 - vsn) * s.inv_dx;
        if (s.channel && x == 0) div = div - __ldg(s.inlet + y) * um * s.inv_dx;
        store_split(RH, RL, r * L::SA + x, -div * inv_dt);
      }
      __syncthreads();
      NSP_PHASE(2);  // divergence
      product<N, T>(ASplit<N>{RH, RL}, BasisB<N>{s.cxT_frag}, acc, warp, lane);
      store_acc<N, T>(acc, T1, 0, warp, lane);
      NSP_PHASE(3);  // T1 = rhs CX^T
      cluster.sync();  // B: T1 of every block
      NSP_PHASE(4);  // barrier B

      // 3. R = (CY T1) / denom over the gathered T1, then T2 = R CX
      load_inv_denom<N, T>(s.inv_denom, y0, warp, lane, dv);
      product<N, T>(ARaw<N>{CYR}, PeerB<N>{t1_addr, rank}, acc, warp, lane);
      store_acc<N, T>(acc, RH, L::SA, warp, lane, dv, y0, zero_mode, RL);
      NSP_PHASE(5);  // R = (CY T1) / denom
      __syncthreads();
      product<N, T>(ASplit<N>{RH, RL}, BasisB<N>{s.cx_frag}, acc, warp, lane);
      store_acc<N, T>(acc, T2, 0, warp, lane);
      NSP_PHASE(6);  // T2 = R CX
      cluster.sync();  // C: T2 of every block
      NSP_PHASE(7);  // barrier C

      // 4. p = CY^T T2
      product<N, T>(ARaw<N>{CYTR}, PeerB<N>{t2_addr, rank}, acc, warp, lane);
      store_acc<N, T>(acc, P, N, warp, lane);
      NSP_PHASE(8);  // p = CY^T T2
      cluster.sync();  // D: p of every block
      NSP_PHASE(9);  // barrier D

      // 5. correction, BCs, pen -> the new state (own rows of U, V)
      for (int e = tid; e < kRows * N; e += kThreads) {
        const int r = e / N;
        const int x = e - r * N;
        const int y = y0 + r;
        float uc = 0.f, vc = 0.f;
        const bool interior = s.channel ? (y > 0 && y < N - 1 && x > 0)
                                        : (y > 0 && y < N - 1 && x > 0 && x < N - 1);
        if (s.channel && !(y == 0 || y == N - 1) && x == 0) {
          uc = __ldg(s.inlet + y) * um;
        } else if (!s.channel && y == N - 1) {
          uc = um;
        } else if (interior) {
          // corrected velocity at (y, xx) before the BCs: q* - dt G p
          const int xx = s.channel && x == N - 1 ? N - 2 : x;
          const int i = r * N + xx;
          const float p0 = P[i];
          const float gx = s.channel && xx == N - 1
                               ? -2.f * p0 * s.inv_dx   // outlet: p = 0 half a cell out
                               : (P[r * N + min(xx + 1, N - 1)] - p0) * s.inv_dx;
          float pn;                                 // p at (y + 1, xx), clamped
          if (r + 1 < kRows) pn = P[i + N];
          else if (y + 1 < N) pn = p_down[xx];
          else pn = p0;
          const float gy = (pn - p0) * s.inv_dx;
          uc = US[i] - dt * gx;
          vc = VS[i] - dt * gy;
        }
        const float pen = PEN[e];
        set_uv(U, V, r, x, uc * pen, vc * pen);
      }
      NSP_PHASE(10);  // correction
      cluster.sync();  // E: u, v of every block
      NSP_PHASE(11);  // barrier E
      fill_halo();
      __syncthreads();
      NSP_PHASE(12);  // halo
    }
    write_frame(f);
  }
  cluster.sync();  // no block leaves while a peer may still read its planes
}

// The kernel of n^2 with T threads a block: its launch configuration, and
// how many of its clusters the card holds (0: none), asked once.
template <int N, int T>
int configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int B, cudaStream_t st,
              int* resident) {
  using L = Smem<N>;
  static int cached = -1;
  cfg = {};
  cfg.gridDim = dim3(L::C, B > 0 ? B : 1, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cached < 0) {
    cudaError_t e = cudaFuncSetAttribute(nsp_cluster_kernel<N, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e == cudaSuccess && L::C > 8)
      e = cudaFuncSetAttribute(nsp_cluster_kernel<N, T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&cached, nsp_cluster_kernel<N, T>, &cfg);
    if (e != cudaSuccess) {
      cached = -1;
      return (int)e;
    }
  }
  *resident = cached;
  return 0;
}

// n <= 128: 512 threads a block (one block an SM, the shortest step) while
// the batch fits the card at once, else 256 (two blocks an SM: twice the
// clusters resident); n > 128 leaves room for one block an SM: 512.
template <int N>
int launch(const Args& a, cudaStream_t st, int* max_clusters) {
  constexpr bool kTwoAnSm = 2 * (Smem<N>::BYTES + 1024) <= 233472;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int wide = 0, narrow = 0;
  int rc = configure<N, 512>(cfg, attr, a.B, st, &wide);
  if (rc != 0) return rc;
  if constexpr (kTwoAnSm) {
    rc = configure<N, 256>(cfg, attr, a.B, st, &narrow);
    if (rc != 0) return rc;
  }
  if (max_clusters != nullptr) *max_clusters = wide > narrow ? wide : narrow;
  if (wide == 0 && narrow == 0) return kNotResident;
  if (a.B == 0) return 0;
  if constexpr (kTwoAnSm) {
    if (a.B > wide && narrow > 0) return (int)cudaLaunchKernelEx(&cfg, nsp_cluster_kernel<N, 256>, a);
  }
  configure<N, 512>(cfg, attr, a.B, st, &wide);
  return (int)cudaLaunchKernelEx(&cfg, nsp_cluster_kernel<N, 512>, a);
}

int dispatch(const Args& a, int n, cudaStream_t st, int* max_clusters) {
  switch (n) {
    case 32: return launch<32>(a, st, max_clusters);
    case 64: return launch<64>(a, st, max_clusters);
    case 96: return launch<96>(a, st, max_clusters);
    case 128: return launch<128>(a, st, max_clusters);
    case 160: return launch<160>(a, st, max_clusters);
    case 192: return launch<192>(a, st, max_clusters);
    case 224: return launch<224>(a, st, max_clusters);
    case 256: return launch<256>(a, st, max_clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The whole trajectory of every image: frame 0 (rest + BCs) and, per
// snapshot, steps[b] projection steps at dt[b], then (u, v, p) into
// channels 0:3 of out[row, s] (out_c channels a point; row = out_rows[b],
// or b when out_rows is null; the other channels are left alone). One
// launch.
int nsp_traj(const float* mask, const float* umax, const float* dt, const int* steps,
             const float* inlet, const float* cy, const float* cyT, const float* cx_frag,
             const float* cxT_frag, const float* inv_denom, int B, int n, int channel, int muscl,
             int S, float nu, float eta, float dx, float dx2, float* out, const int* out_rows,
             int out_c, void* stream, int* launched) {
  Args a;
  a.B = B;
  a.S = S;
  a.channel = channel;
  a.muscl = muscl;
  a.nu = nu;
  a.eta = eta;
  a.dx = dx;
  a.dx2 = dx2;
  a.inv_dx = 1.f / dx;
  a.inv_dx2 = 1.f / dx2;
  a.mask = mask;
  a.umax = umax;
  a.dt = dt;
  a.steps = steps;
  a.inlet = inlet;
  a.cy = cy;
  a.cyT = cyT;
  a.cx_frag = reinterpret_cast<const float4*>(cx_frag);
  a.cxT_frag = reinterpret_cast<const float4*>(cxT_frag);
  a.inv_denom = inv_denom;
  a.out = out;
  a.out_rows = out_rows;
  a.out_c = out_c;
  if (launched != nullptr) *launched = 0;
  const int rc = dispatch(a, n, static_cast<cudaStream_t>(stream), nullptr);
  if (rc != 0) return rc;
  const cudaError_t e = cudaGetLastError();
  if (launched != nullptr && e == cudaSuccess) *launched = B > 0 ? 1 : 0;
  return (int)e;
}

// How many clusters of the n^2 kernel the card holds at once (0: none).
int nsp_max_active_clusters(int n, int* clusters) {
  Args a = {};
  *clusters = 0;
  return dispatch(a, n, nullptr, clusters);
}

#ifdef NSP_PHASE_CLOCKS
// Copy the 16 phase counters to `host` (and zero them when `reset`).
int nsp_phase_clocks(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, nsp_phase_cycles, sizeof(unsigned long long) * 16);
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[16] = {};
    e = cudaMemcpyToSymbol(nsp_phase_cycles, zero, sizeof(zero));
  }
  return (int)e;
}
#endif

}  // extern "C"
