// Multi-tensor AdamW over f32 leaves: one launch updates every leaf's
// parameter p and both moments mu, nu from its gradient g, either in place
// (`adamw_kernel`) or into new storage p', mu', nu', leaving every tensor it
// was handed as it was (`adamw_out_kernel`: optax's `adamw` is a pure
// function). Both run one body; the in-place one is handed its inputs as
// its outputs.
//
// Replaces no TPU kernel. The JAX package trains with optax's `adamw`,
// whose per-leaf elementwise chain XLA fuses on its own; no
// `pl.pallas_call` computes it. The port's per-leaf loop
// (ops/optim.py:AdamW.update + apply_updates) runs the same chain as 16
// separate elementwise launches a leaf; this kernel takes all of them, for
// all leaves, into one launch that reads and writes each element once.
//
// Arithmetic: element for element what that loop computes on the card, so
// that p, mu and nu come out bitwise equal. Every operation is f32, in the
// loop's order, rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn: no FMA contraction, no fast math):
//
//     m  = (1-b1)*g + b1*mu
//     v  = (1-b2)*(g*g) + b2*nu
//     u  = (m * inv_bc1) / (sqrt(v * inv_bc2) + eps)
//     u  = u + wd*p
//     p  = p + (-lr)*u;   mu = m;   nu = v
//
// A division by a host scalar is a multiply by its f32 reciprocal
// (inv_bc1 = 1.0f / bc1, formed on the host), because that is what ATen's
// CUDA `div` does when its divisor is a CPU scalar; the division of two
// tensors stays a true division. Every scalar arrives rounded to f32 by the
// wrapper (ops/fused_adamw.py) exactly as ATen rounds a Python scalar.
//
// What bounds it on an H100 (3.35 TB/s): bytes. Each element reads p, g,
// mu, nu and writes p, mu, nu (out of place p', mu', nu', the same 28
// bytes), against ~40 f32 instructions (the IEEE divide and square root
// are short sequences). At the SSL model's 111,002,116 elements that is
// 3.108 GB, 0.928 ms at the HBM rate, while the instructions take ~0.15 ms.
// So the design keeps enough bytes in flight, moves every byte once, and
// leaves no SM idle at the end:
// - the leaves' elements, each leaf padded to a multiple of 4 and all
//   concatenated, are cut into chunks of kChunk elements; the wrapper lists
//   each chunk's (leaf, start, length) segments in a table on the device,
//   built once for a set of leaf sizes. In place the table also holds the
//   parameter and moment pointers, whose storage stays put, and is built
//   again only when a leaf moves. The gradients are new tensors every
//   step: their pointers travel in the kernel's parameter space
//   (`__grid_constant__`, read through the constant cache), so a step
//   copies nothing to the card and never waits for it. Out of place every
//   pointer is new storage every step (inputs, outputs and gradients), so
//   all seven of a leaf travel in the parameter space (at most
//   kMaxOutLeaves leaves), and the table holds the work alone;
// - a persistent grid (the resident blocks, from the occupancy API) claims
//   chunks from a counter at the table's end, one atomic a chunk, so that a
//   block on an SM the memory system serves faster takes more of them and
//   all blocks finish together (with an equal static share a block, the
//   card waited on its slowest SMs). The counter is never reset: a launch
//   makes exactly n_chunks + grid claims (one that fails a block), so the
//   wrapper passes the claims made before this launch as `base`;
// - 16-byte loads and stores (float4) of p, mu and nu where a leaf's
//   pointers (inputs and outputs) are 16-byte aligned, g by float4 where it
//   is aligned too and by four scalar loads where it is not (a gradient
//   that is a view into a data-parallel reduction's flat buffer); each
//   thread loads kUnroll groups of all four streams before it computes and
//   stores. Plain loads and stores: the evict-first hints (ld/st .cs) ran
//   slower;
// - a scalar loop takes a segment's last 0-3 elements, and the whole of a
//   segment whose p, mu or nu is not 16-byte aligned (the 1- and 3-element
//   leaves are such tails).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
// elements a chunk, one unrolled pass of a block: ops/fused_adamw.py:CHUNK
constexpr int kChunk = 4 * kUnroll * kThreads;
static_assert(kChunk == 2048, "ops/fused_adamw.py:CHUNK is 2048");
// 8 KB of gradient pointers in the parameter space (CUDA 12.1+ allows
// 32,764 bytes of kernel parameters); ops/fused_adamw.py:MAX_LEAVES
constexpr int kMaxLeaves = 1024;

struct Scalars {
  float b1, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, wd, neg_lr;
};

struct Args {
  // [p, mu, nu] pointer per leaf (3 L) | [leaf, start, length] per
  // segment (3 S) | the first segment of each chunk (n_chunks + 1) | the
  // claim counter
  long long* table;
  long long n_chunks, base;
  int n_leaves, n_segs;
  Scalars s;
  const float* g[kMaxLeaves];
};

// Out of place: 7 pointers a leaf in the parameter space, so fewer leaves;
// ops/fused_adamw.py:MAX_OUT_LEAVES
constexpr int kMaxOutLeaves = 576;

struct OutArgs {
  // [leaf, start, length] per segment (3 S) | the first segment of each
  // chunk (n_chunks + 1) | the claim counter
  long long* table;
  long long n_chunks, base;
  int n_leaves, n_segs;
  Scalars s;
  // [p, mu, nu, p', mu', nu', g] of each leaf; p, mu, nu, g only read
  float* ptrs[7 * kMaxOutLeaves];
};
static_assert(sizeof(OutArgs) <= 32764, "kernel parameters: 32,764 bytes");

__device__ __forceinline__ void adamw1(float& p, float g, float& m, float& v,
                                       const Scalars& s) {
  const float mn = __fadd_rn(__fmul_rn(s.one_minus_b1, g), __fmul_rn(s.b1, m));
  const float vn = __fadd_rn(__fmul_rn(s.one_minus_b2, __fmul_rn(g, g)),
                             __fmul_rn(s.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(vn, s.inv_bc2)), s.eps);
  float u = __fdiv_rn(__fmul_rn(mn, s.inv_bc1), den);
  u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, u));
  m = mn;
  v = vn;
}

__device__ __forceinline__ void adamw4(float4& p, const float4& g, float4& m,
                                       float4& v, const Scalars& s) {
  adamw1(p.x, g.x, m.x, v.x, s);
  adamw1(p.y, g.y, m.y, v.y, s);
  adamw1(p.z, g.z, m.z, v.z, s);
  adamw1(p.w, g.w, m.w, v.w, s);
}

template <bool kVecG>
__device__ __forceinline__ float4 load_g(const float* g, long long j) {
  if (kVecG) return reinterpret_cast<const float4*>(g)[j];
  const float* q = g + 4 * j;
  return make_float4(q[0], q[1], q[2], q[3]);
}

// n4 groups of 4 elements read from p, g, mu, nu and written to po, mo, vo
// (the same pointers in place); all 16-byte aligned, g when kVecG
template <bool kVecG>
__device__ __forceinline__ void groups(const float* p, const float* g,
                                       const float* mu, const float* nu,
                                       float* po, float* mo, float* vo,
                                       long long n4, const Scalars& s) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* m4 = reinterpret_cast<const float4*>(mu);
  const float4* v4 = reinterpret_cast<const float4*>(nu);
  float4* po4 = reinterpret_cast<float4*>(po);
  float4* mo4 = reinterpret_cast<float4*>(mo);
  float4* vo4 = reinterpret_cast<float4*>(vo);
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < n4; i += kUnroll * kThreads) {
    float4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * kThreads;
      rp[u] = p4[j];
      rg[u] = load_g<kVecG>(g, j);
      rm[u] = m4[j];
      rv[u] = v4[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * kThreads;
      adamw4(rp[u], rg[u], rm[u], rv[u], s);
      po4[j] = rp[u];
      mo4[j] = rm[u];
      vo4[j] = rv[u];
    }
  }
  for (; i < n4; i += kThreads) {
    float4 rp = p4[i], rm = m4[i], rv = v4[i];
    adamw4(rp, load_g<kVecG>(g, i), rm, rv, s);
    po4[i] = rp;
    mo4[i] = rm;
    vo4[i] = rv;
  }
}

// The chunks a block claims, until none is left; in place (Args: each
// leaf's p, mu, nu in the table) or out of place (OutArgs)
template <bool kOut, typename A>
__device__ __forceinline__ void claim_chunks(const A& a) {
  constexpr int kPtrs = kOut ? 0 : 3;   // pointers a leaf in the table
  const long long* leaves = a.table;
  const long long* segs = leaves + kPtrs * static_cast<long long>(a.n_leaves);
  const long long* first = segs + 3 * static_cast<long long>(a.n_segs);
  unsigned long long* counter =
      reinterpret_cast<unsigned long long*>(a.table + kPtrs * a.n_leaves +
                                            3 * a.n_segs + a.n_chunks + 1);
  const Scalars s = a.s;
  __shared__ long long claimed;
  for (;;) {
    if (threadIdx.x == 0)
      claimed = static_cast<long long>(atomicAdd(counter, 1ull)) - a.base;
    __syncthreads();
    const long long chunk = claimed;
    if (chunk >= a.n_chunks) break;
    const long long end = first[chunk + 1];
    for (long long k = first[chunk]; k < end; ++k) {
      const int leaf = static_cast<int>(segs[3 * k]);
      const long long start = segs[3 * k + 1], len = segs[3 * k + 2];
      float *p, *mu, *nu, *po, *mo, *vo;
      const float* g;
      if constexpr (kOut) {
        float* const* q = a.ptrs + 7 * leaf;
        p = q[0] + start;
        mu = q[1] + start;
        nu = q[2] + start;
        po = q[3] + start;
        mo = q[4] + start;
        vo = q[5] + start;
        g = q[6] + start;
      } else {
        p = reinterpret_cast<float*>(leaves[3 * leaf]) + start;
        mu = reinterpret_cast<float*>(leaves[3 * leaf + 1]) + start;
        nu = reinterpret_cast<float*>(leaves[3 * leaf + 2]) + start;
        po = p;
        mo = mu;
        vo = nu;
        g = a.g[leaf] + start;
      }
      long long done = 0;
      const uintptr_t state =
          reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(mu) |
          reinterpret_cast<uintptr_t>(nu) |
          (kOut ? reinterpret_cast<uintptr_t>(po) |
                      reinterpret_cast<uintptr_t>(mo) |
                      reinterpret_cast<uintptr_t>(vo)
                : 0);
      if (state % 16 == 0) {
        const long long n4 = len / 4;
        if (reinterpret_cast<uintptr_t>(g) % 16 == 0) {
          groups<true>(p, g, mu, nu, po, mo, vo, n4, s);
        } else {
          groups<false>(p, g, mu, nu, po, mo, vo, n4, s);
        }
        done = 4 * n4;
      }
      for (long long i = done + threadIdx.x; i < len; i += kThreads) {
        float pi = p[i], mi = mu[i], vi = nu[i];
        adamw1(pi, g[i], mi, vi, s);
        po[i] = pi;
        mo[i] = mi;
        vo[i] = vi;
      }
    }
    __syncthreads();   // every thread has read `claimed` before the next
  }
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const __grid_constant__ Args a) {
  claim_chunks<false>(a);
}

__global__ void __launch_bounds__(kThreads)
    adamw_out_kernel(const __grid_constant__ OutArgs a) {
  claim_chunks<true>(a);
}

// The launch's header in `a`; a CUDA error code for arguments the kernel
// cannot take
template <typename A>
int header(A& a, long long* table, int n_leaves, int max_leaves, int n_segs,
           long long n_chunks, int grid, long long base,
           const float* scalars) {
  if (table == nullptr || n_leaves <= 0 || n_leaves > max_leaves ||
      n_segs < 0 || n_chunks < 1 || grid <= 0 || base < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  memset(&a, 0, sizeof(a));
  a.table = table;
  a.n_chunks = n_chunks;
  a.base = base;
  a.n_leaves = n_leaves;
  a.n_segs = n_segs;
  memcpy(&a.s, scalars, sizeof(Scalars));
  return 0;
}

}  // namespace

// Resident blocks an SM of the in-place kernel, or of the out-of-place one
// when `out` is not 0 (the wrapper's grid is at most that times the SM
// count); a CUDA error code.
extern "C" int vst_fused_adamw_blocks_per_sm(int out, int* blocks) {
  if (out)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, adamw_out_kernel, kThreads, 0));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, adamw_kernel, kThreads, 0));
}

// One update of every leaf in place on `stream`. `table` is the device
// table laid out as Args::table says, its chunks kChunk elements each;
// `base` the claims its counter holds (the launches before this one, each
// n_chunks + grid); `grads` n_leaves host-side gradient pointers in the
// table's leaf order; `scalars` the nine floats of Scalars. Returns the
// launch's CUDA error code (0 when it was queued).
extern "C" int vst_fused_adamw_f32(long long* table, int n_leaves,
                                   int n_segs, long long n_chunks, int grid,
                                   long long base,
                                   const unsigned long long* grads,
                                   const float* scalars, void* stream) {
  Args a;
  const int err = header(a, table, n_leaves, kMaxLeaves, n_segs, n_chunks,
                         grid, base, scalars);
  if (err != 0) return err;
  for (int i = 0; i < n_leaves; ++i)
    a.g[i] = reinterpret_cast<const float*>(grads[i]);
  adamw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The same update into new storage: `table` as OutArgs::table says; `ptrs`
// 7 host-side pointers a leaf, [p, mu, nu, p', mu', nu', g], the outputs
// overlapping no input; at most kMaxOutLeaves leaves.
extern "C" int vst_fused_adamw_out_f32(long long* table, int n_leaves,
                                       int n_segs, long long n_chunks,
                                       int grid, long long base,
                                       const unsigned long long* ptrs,
                                       const float* scalars, void* stream) {
  OutArgs a;
  const int err = header(a, table, n_leaves, kMaxOutLeaves, n_segs,
                         n_chunks, grid, base, scalars);
  if (err != 0) return err;
  memcpy(a.ptrs, ptrs, sizeof(a.ptrs[0]) * 7 * n_leaves);
  adamw_out_kernel<<<grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
