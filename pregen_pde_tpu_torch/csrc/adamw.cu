// Hand-written AdamW for Hopper (sm_90a): the global-norm clip and the
// update of every leaf of a model, in two launches a step.
//
// No TPU kernel corresponds to it. The JAX package leaves optax's update
// to XLA, which fuses it into the jitted train step, and its bucketed
// option (pregen_pde_tpu/training/fused_optim.py) is jnp, not Pallas. The
// same arithmetic as torch _foreach calls (training/optim.py's CPU route)
// is some forty calls, each a chain of multi-tensor launches and a dozen of
// them allocating a tensor a leaf: for scOT-B's 1,580 leaves ~13 ms of the
// card and ~0.1 s of the host a step. These kernels take two launches and
// allocate nothing.
//
// What bounds it: bytes. The update reads p, g, m, v and writes p, m, v,
// 28 bytes an element (4.42 GB at scOT-B's 157.7 M parameters, 1.32 ms at
// 3.35 TB/s), and the norm reads g once more (0.19 ms), against ~20 FLOP
// an element.
//
// Work lists, built once by the wrapper (ops/adamw.py): a row per leaf (the
// p, m and v addresses, the group's index, the decay flag) and a row per
// chunk (leaf, first element, length; at most kChunk elements, never across
// a leaf's end), so block b takes chunk b with no search. The gradients'
// addresses change every step (backward allocates them anew): the wrapper
// copies them to `grads` before the launches, a null address standing for
// a leaf with no gradient, read as zeros.
//
// Launch 1 (adamw_sumsq_kernel, only with a clip): each block writes its
// chunk's sum of g^2 (float32, fma) to partials[b]; the last block to
// finish (a ticket counter, after a __threadfence) adds the partials in
// double in a fixed order, so the norm does not depend on which block is
// last, writes the norm and the clip's divisor and factor, and resets the
// counter for the next step.
// Launch 2 (adamw_update_kernel): each block updates its chunk, g clipped
// as training/optim.py's _foreach route does (divided by
// where(norm < clip, 1, norm), then multiplied by where(norm < clip, 1,
// clip), so a NaN norm makes every update NaN), then
//   m' = (1 - b1) g + b1 m,   v' = (1 - b2) (g g) + b2 v,
//   u = (m' * (1/bc1)) / (sqrt(v' * (1/bc2)) + eps),   u += wd p where the
//   leaf decays,   p += (-lr) u,
// each operation rounded once, in that order, with __f*_rn intrinsics, so
// nvcc contracts nothing into an FMA: the _foreach route's roundings on the
// card (each of its calls is one IEEE operation in float32, its scalars
// rounded to float32; torch's _foreach_div by a scalar multiplies by the
// reciprocal taken in double, as 1/bc1 and 1/bc2 are here), so p, m and v
// come out bit-equal to it whenever the clip does not engage; when it
// does, only the norm's order of summation differs.
// float4 loads and stores where the chunk's four addresses are 16-byte
// aligned (a leaf's chunks start at multiples of kChunk), the ragged tail
// and unaligned leaves element by element.
//
// The learning rates of the groups (at most kMaxGroups) and the step's
// bias corrections are kernel arguments: nothing is read from the host
// during the launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 8;

struct Leaf {
  float* p;
  float* m;
  float* v;
  int group;
  int decay;
};

struct Chunk {
  int leaf;
  int start;
  int len;
};

struct Scalars {
  float neg_lr[kMaxGroups];
  float b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, wd;
};

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

template <typename T>
__device__ T block_sum(T x, T* shared) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) shared[warp] = x;
  __syncthreads();
  x = threadIdx.x < kThreads / 32 ? shared[threadIdx.x] : T(0);
  if (warp == 0)
    for (int o = kThreads / 64; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;  // the total in thread 0
}

__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const Chunk* __restrict__ chunks, const float* const* __restrict__ grads,
                   float* __restrict__ partials, float* __restrict__ out,
                   unsigned int* __restrict__ ticket, int n_chunks, float clip) {
  __shared__ float red[kThreads / 32];
  __shared__ double red64[kThreads / 32];
  __shared__ bool last;
  const Chunk c = chunks[blockIdx.x];
  const float* g = grads[c.leaf];
  float s = 0.f;
  if (g != nullptr) {
    g += c.start;
    int i0 = 0;
    if (aligned16(g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const int n4 = c.len >> 2;
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const float4 x = __ldg(g4 + i);
        s = __fmaf_rn(x.x, x.x, s);
        s = __fmaf_rn(x.y, x.y, s);
        s = __fmaf_rn(x.z, x.z, s);
        s = __fmaf_rn(x.w, x.w, s);
      }
      i0 = n4 << 2;
    }
    for (int i = i0 + threadIdx.x; i < c.len; i += kThreads) {
      const float x = __ldg(g + i);
      s = __fmaf_rn(x, x, s);
    }
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(n_chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  double t = 0.0;
  for (int i = threadIdx.x; i < n_chunks; i += kThreads)
    t += static_cast<double>(__ldcg(partials + i));
  t = block_sum(t, red64);
  if (threadIdx.x == 0) {
    const float norm = static_cast<float>(sqrt(t));
    const bool keep = norm < clip;
    out[0] = norm;
    out[1] = keep ? 1.f : norm;
    out[2] = keep ? 1.f : clip;
    *ticket = 0u;
  }
}

struct Moments {
  float p, m, v;
};

__device__ __forceinline__ Moments adamw_one(float g, float p, float m, float v, float div,
                                             float mul, bool clip, bool decay, float neg_lr,
                                             const Scalars& k) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, div), mul);
  const float m1 = __fadd_rn(__fmul_rn(g, k.omb1), __fmul_rn(m, k.b1));
  const float v1 = __fadd_rn(__fmul_rn(__fmul_rn(g, g), k.omb2), __fmul_rn(v, k.b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v1, k.inv_bc2)), k.eps);
  float u = __fdiv_rn(__fmul_rn(m1, k.inv_bc1), denom);
  if (decay) u = __fadd_rn(u, __fmul_rn(p, k.wd));
  return {__fadd_rn(p, __fmul_rn(u, neg_lr)), m1, v1};
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const Chunk* __restrict__ chunks, const Leaf* __restrict__ leaves,
                    const float* const* __restrict__ grads, const float* __restrict__ clip_out,
                    const Scalars k) {
  const Chunk c = chunks[blockIdx.x];
  const Leaf leaf = leaves[c.leaf];
  const float* g = grads[c.leaf];
  const bool clip = clip_out != nullptr;
  const float div = clip ? clip_out[1] : 1.f, mul = clip ? clip_out[2] : 1.f;
  const bool decay = leaf.decay != 0 && k.wd != 0.f;
  const float neg_lr = k.neg_lr[leaf.group];
  float* p = leaf.p + c.start;
  float* m = leaf.m + c.start;
  float* v = leaf.v + c.start;
  if (g != nullptr) g += c.start;
  int i0 = 0;
  if (aligned16(p) && aligned16(m) && aligned16(v) && aligned16(g)) {
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int n4 = c.len >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 gi = g4 != nullptr ? __ldg(g4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 pi = p4[i], mi = m4[i], vi = v4[i];
      const Moments a = adamw_one(gi.x, pi.x, mi.x, vi.x, div, mul, clip, decay, neg_lr, k);
      const Moments b = adamw_one(gi.y, pi.y, mi.y, vi.y, div, mul, clip, decay, neg_lr, k);
      const Moments e = adamw_one(gi.z, pi.z, mi.z, vi.z, div, mul, clip, decay, neg_lr, k);
      const Moments d = adamw_one(gi.w, pi.w, mi.w, vi.w, div, mul, clip, decay, neg_lr, k);
      p4[i] = make_float4(a.p, b.p, e.p, d.p);
      m4[i] = make_float4(a.m, b.m, e.m, d.m);
      v4[i] = make_float4(a.v, b.v, e.v, d.v);
    }
    i0 = n4 << 2;
  }
  for (int i = i0 + threadIdx.x; i < c.len; i += kThreads) {
    const Moments a = adamw_one(g != nullptr ? __ldg(g + i) : 0.f, p[i], m[i], v[i], div, mul,
                                clip, decay, neg_lr, k);
    p[i] = a.p;
    m[i] = a.m;
    v[i] = a.v;
  }
}

}  // namespace

extern "C" {

// One AdamW step over the leaves of `leaves` (n_leaves rows) as cut into
// `chunks` (n_chunks rows), the gradients' addresses in `grads` (device,
// n_leaves of them, 0 for none): with has_clip, launch 1 into `partials`
// (n_chunks floats) and `clip_out` (norm, divisor, factor; `ticket` 0 on
// entry and on return), then launch 2. neg_lr: n_groups values, -lr of each
// group; inv_bc1, inv_bc2: the reciprocals of the bias corrections.
// *launched: the kernels enqueued. Returns cudaGetLastError().
int adamw_step(const void* chunks, const void* leaves, const void* grads, float* partials,
               float* clip_out, unsigned int* ticket, int n_chunks, int has_clip, float clip,
               const float* neg_lr, int n_groups, float b1, float omb1, float b2, float omb2,
               float inv_bc1, float inv_bc2, float eps, float wd, void* stream,
               int* launched) {
  if (launched != nullptr) *launched = 0;
  if (n_chunks < 0 || n_groups < 1 || n_groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaGetLastError();
  Scalars k{};
  for (int i = 0; i < n_groups; ++i) k.neg_lr[i] = neg_lr[i];
  k.b1 = b1;
  k.omb1 = omb1;
  k.b2 = b2;
  k.omb2 = omb2;
  k.inv_bc1 = inv_bc1;
  k.inv_bc2 = inv_bc2;
  k.eps = eps;
  k.wd = wd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Chunk* c = static_cast<const Chunk*>(chunks);
  const float* const* g = static_cast<const float* const*>(grads);
  int n = 0;
  if (has_clip) {
    adamw_sumsq_kernel<<<n_chunks, kThreads, 0, st>>>(c, g, partials, clip_out, ticket,
                                                      n_chunks, clip);
    ++n;
  }
  adamw_update_kernel<<<n_chunks, kThreads, 0, st>>>(c, static_cast<const Leaf*>(leaves), g,
                                                     has_clip ? clip_out : nullptr, k);
  ++n;
  const cudaError_t e = cudaGetLastError();
  if (launched != nullptr) *launched = e == cudaSuccess ? n : 0;
  return (int)e;
}

// sizeof of the work lists' rows, for the wrapper to check its layout.
int adamw_row_bytes(int which) {
  return which == 0 ? (int)sizeof(Leaf) : which == 1 ? (int)sizeof(Chunk) : -1;
}

}  // extern "C"
