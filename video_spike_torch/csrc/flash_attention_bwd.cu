// Fused multi-head self-attention, backward: dq, dk and dv of
// out = softmax(q kᵀ * scale) v over (B, S, H, D) bf16 inputs, from the
// forward's output and per-row log-sum-exp (flash_attention_fwd.cu), never
// storing an S x S tensor. Replaces no TPU kernel (see the forward's note).
//
// Three kernels on the caller's stream:
// 1. delta_kernel: Δ = rowsum(dO ∘ O) in f32 from the f32 dO and O, and dO
//    rounded to bf16 for the products (the port's dO arrives bf16-valued
//    through the output projection's cast, so that rounding is exact there);
// 2. bwd_kernel, one block per (key tile, batch x head): the block keeps its
//    K and V tile and dK, dV in registers and walks every query tile:
//      sᵀ = k qᵀ (recomputed), pᵀ = exp(sᵀ * scale - lse), dV += pᵀ dO with
//      pᵀ rounded to bf16, dpᵀ = v dOᵀ, dsᵀ = pᵀ ∘ (dpᵀ - Δ) in f32,
//      dK += dsᵀ q and dQ += ds k with ds rounded to bf16,
//    every product bf16 x bf16 with f32 accumulation. dQ's partial sums of
//    all key tiles meet in an f32 buffer (zeroed first) by 8-byte atomic
//    adds; dK = scale * dK and dV are written once, in bf16.
// 3. dq_kernel: the f32 dQ sum rounded to bf16.
// The one rounding the torch expression does not make is ds to bf16 before
// the dq and dk products.
//
// What bounds it on an H100: operations. Five products of S x S x D a head
// (the score recomputed, dV, dP, dK, dQ): at VideoMAE's decoder 6.0e11
// FLOPs a layer, 0.61 ms at 989 TFLOP/s, against 0.09 ms for the bytes.
// The design follows the forward's (flash_attention.cuh): each warp owns 16
// key rows, so sᵀ and dpᵀ are computed as k qᵀ and v dOᵀ and their C
// fragments are, lane for lane, the A operands of dV += pᵀ dO and
// dK += dsᵀ q; only ds goes through shared memory, once, for dQ. q, dO,
// lse and Δ of the next query tile load (cp.async) while this one is
// multiplied. At head dim 256 a group of 16 key rows is shared by
// kBwdSplitD warps, each keeping a quarter of dK and dV's columns (the
// whole of them would not fit a thread's 255 registers) and each computing
// sᵀ and dpᵀ in full.

#include "flash_attention.cuh"

namespace vst_flash {
namespace {

struct BwdArgs {
  const bf16 *q, *k, *v;
  Strides sq, sk, sv;
  const bf16* dout;     // (B, S, H, D) contiguous: dO rounded to bf16
  const float* lse;     // (B, H, S) contiguous
  const float* delta;   // (B, H, S) contiguous
  float* dq;            // (B, S, H, D) contiguous f32, zeroed
  bf16 *dk, *dv;        // (B, S, H, D) contiguous
  int S, H, n_tiles;    // key tiles a head
  float scale;
};

template <int D>
struct BwdShape {
  static constexpr int BN = Tiles<D>::kBwdN, BM = Tiles<D>::kBwdM;
  static constexpr int SD = Tiles<D>::kBwdSplitD;
  static constexpr int NW = BN / 16 * SD, kThreads = NW * 32;
  static constexpr int DS = D / SD;            // dK, dV columns a warp keeps
  static constexpr int LD = D + 8, LDS = BM + 8;
  static constexpr int RG = BM / 16;           // dQ: 16-row groups
  static constexpr int CG = NW / RG;           // dQ: column groups
  static constexpr int QC = D / CG;            // dQ: columns a warp
  static constexpr int QCH = QC < 64 ? QC : 64;   // ... in chunks of
  static constexpr int kBytes =
      (2 * BN * LD + 4 * BM * LD + BN * LDS) * static_cast<int>(sizeof(bf16)) +
      4 * BM * static_cast<int>(sizeof(float));
  static_assert(NW % RG == 0 && QC % QCH == 0 && QCH % 16 == 0 &&
                    DS % 16 == 0,
                "tile shapes");
};

// one 8-byte atomic add of (x, y) to p[0], p[1] (p 8-byte aligned); Hopper
// adds float2 in global memory as one operation
__device__ __forceinline__ void red_add2(float* p, float x, float y) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
}

template <int D>
__global__ void __launch_bounds__(BwdShape<D>::kThreads)
    bwd_kernel(const __grid_constant__ BwdArgs a) {
  using T = BwdShape<D>;
  constexpr int BN = T::BN, BM = T::BM, SD = T::SD, DS = T::DS;
  constexpr int LD = T::LD, LDS = T::LDS, kThreads = T::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;             // two stages of BM rows
  bf16* sO = sQ + 2 * BM * LD;         // dO, two stages
  bf16* sdS = sO + 2 * BM * LD;        // dsᵀ, [key][query]
  float* sL = reinterpret_cast<float*>(sdS + BN * LDS);   // two stages
  float* sDl = sL + 2 * BM;                                // two stages

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kr = warp / SD, ds = warp % SD;
  const int tile = blockIdx.x % a.n_tiles;
  const int bh = blockIdx.x / a.n_tiles;
  const int b = bh / a.H, h = bh % a.H;
  const int S = a.S;
  const int n0 = tile * BN;
  const long long row_stride = static_cast<long long>(a.H) * D;   // dO, dq, dk, dv
  const long long head0 = static_cast<long long>(b) * S * row_stride +
                          static_cast<long long>(h) * D;
  const bf16* q = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* k = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* v = a.v + b * a.sv.b + h * a.sv.h;
  const bf16* dout = a.dout + head0;
  const float* lse = a.lse + static_cast<long long>(bh) * S;
  const float* delta = a.delta + static_cast<long long>(bh) * S;

  auto load_query_tile = [&](int i, int st) {
    load_rows<BM, D, kThreads>(sQ + st * BM * LD, q, a.sq.s, i * BM, S);
    load_rows<BM, D, kThreads>(sO + st * BM * LD, dout, row_stride, i * BM,
                               S);
    for (int c = threadIdx.x; c < BM; c += kThreads) {
      const int row = i * BM + c;
      // a row past the end has lse = +inf: its p is 0
      sL[st * BM + c] = row < S ? lse[row] : -neg_inf();
      sDl[st * BM + c] = row < S ? delta[row] : 0.f;
    }
  };

  load_rows<BN, D, kThreads>(sK, k, a.sk.s, n0, S);
  load_rows<BN, D, kThreads>(sV, v, a.sv.s, n0, S);
  load_query_tile(0, 0);
  cp_async_commit();

  float dk[DS / 8][4], dv[DS / 8][4];
#pragma unroll
  for (int i = 0; i < DS / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const int key0 = n0 + kr * 16 + g;   // this lane's key rows: key0, key0 + 8

  const int n_query = (S + BM - 1) / BM;
  for (int i = 0; i < n_query; ++i) {
    const int st = i & 1;
    if (i + 1 < n_query) {
      load_query_tile(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sQs = sQ + st * BM * LD;
    const bf16* sOs = sO + st * BM * LD;
    const float* sLs = sL + st * BM;
    const float* sDs = sDl + st * BM;

    // sᵀ = k qᵀ: this warp's 16 keys x BM queries
    float p[BM / 8][4];
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4];
      ldsm_x4(ka, a_addr(sK, LD, kr * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < BM / 16; ++np) {
        uint32_t qb[4];
        ldsm_x4(qb, bn_addr(sQs, LD, np * 16, kk * 16, lane));
        mma(p[2 * np], ka, qb[0], qb[1]);
        mma(p[2 * np + 1], ka, qb[2], qb[3]);
      }
    }
    // pᵀ = exp(sᵀ * scale - lse); keys past the end 0
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const int key = key0 + (e >> 1) * 8;
        p[n][e] = key < S ? __expf(p[n][e] * a.scale - sLs[col]) : 0.f;
      }
    }

    // dpᵀ = v dOᵀ
    float dp[BM / 8][4];
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t va[4];
      ldsm_x4(va, a_addr(sV, LD, kr * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < BM / 16; ++np) {
        uint32_t ob[4];
        ldsm_x4(ob, bn_addr(sOs, LD, np * 16, kk * 16, lane));
        mma(dp[2 * np], va, ob[0], ob[1]);
        mma(dp[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // dV += pᵀ dO, pᵀ rounded to bf16 (this warp's DS columns)
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4];
      a_from_c(pa, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < DS / 16; ++np) {
        uint32_t ob[4];
        ldsm_x4_t(ob, bk_addr(sOs, LD, kk * 16, ds * DS + np * 16, lane));
        mma(dv[2 * np], pa, ob[0], ob[1]);
        mma(dv[2 * np + 1], pa, ob[2], ob[3]);
      }
    }

    // dsᵀ = pᵀ ∘ (dpᵀ - Δ), in f32 (into p)
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = p[n][e] * (dp[n][e] - sDs[n * 8 + 2 * t + (e & 1)]);
    }

    // dK += dsᵀ q, ds rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t da[4];
      a_from_c(da, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < DS / 16; ++np) {
        uint32_t qb[4];
        ldsm_x4_t(qb, bk_addr(sQs, LD, kk * 16, ds * DS + np * 16, lane));
        mma(dk[2 * np], da, qb[0], qb[1]);
        mma(dk[2 * np + 1], da, qb[2], qb[3]);
      }
    }

    // dsᵀ in bf16 to shared memory, [key][query]
    if (ds == 0) {
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
        const int col = n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(sdS + (kr * 16 + g) * LDS + col) =
            pack_bf16(p[n][0], p[n][1]);
        *reinterpret_cast<uint32_t*>(sdS + (kr * 16 + g + 8) * LDS + col) =
            pack_bf16(p[n][2], p[n][3]);
      }
    }
    __syncthreads();

    // dQ += scale * ds k: this warp's 16 query rows x QC columns, in chunks
    // of QCH, added into the f32 sum
    {
      const int rg = warp % T::RG, cg = warp / T::RG;
      const int qrow0 = i * BM + rg * 16 + g;
#pragma unroll
      for (int c0 = cg * T::QC; c0 < (cg + 1) * T::QC; c0 += T::QCH) {
        float acc[T::QCH / 8][4];
#pragma unroll
        for (int n = 0; n < T::QCH / 8; ++n)
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          uint32_t da[4];
          ldsm_x4_t(da, ak_addr(sdS, LDS, kk * 16, rg * 16, lane));
#pragma unroll
          for (int np = 0; np < T::QCH / 16; ++np) {
            uint32_t kb[4];
            ldsm_x4_t(kb, bk_addr(sK, LD, kk * 16, c0 + np * 16, lane));
            mma(acc[2 * np], da, kb[0], kb[1]);
            mma(acc[2 * np + 1], da, kb[2], kb[3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = qrow0 + 8 * r;
          if (row >= S) continue;
          float* dst = a.dq + head0 + row * row_stride + c0 + 2 * t;
#pragma unroll
          for (int n = 0; n < T::QCH / 8; ++n)
            red_add2(dst + n * 8, acc[n][2 * r] * a.scale,
                     acc[n][2 * r + 1] * a.scale);
        }
      }
    }
    __syncthreads();   // ds and this stage are read; both may be rewritten
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
    const long long off = head0 + key * row_stride + ds * DS + 2 * t;
#pragma unroll
    for (int n = 0; n < DS / 8; ++n) {
      *reinterpret_cast<uint32_t*>(a.dk + off + n * 8) =
          pack_bf16(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(a.dv + off + n * 8) =
          pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// Δ and dO in bf16 over `rows` = B S H rows of D, G threads a row
template <int D>
__global__ void __launch_bounds__(256)
    delta_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                 bf16* __restrict__ dob, float* __restrict__ delta,
                 long long rows, int S, int H) {
  constexpr int G = D / 4 < 32 ? D / 4 : 32;
  constexpr int V = D / (4 * G);   // float4 a thread
  const long long row = (blockIdx.x * 256LL + threadIdx.x) / G;
  const int j = threadIdx.x % G;
  float sum = 0.f;
  if (row < rows) {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const long long idx = row * D + (u * G + j) * 4;
      const float4 x = *reinterpret_cast<const float4*>(dout + idx);
      const float4 y = *reinterpret_cast<const float4*>(out + idx);
      sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      uint2 pk;
      pk.x = pack_bf16(x.x, x.y);
      pk.y = pack_bf16(x.z, x.w);
      *reinterpret_cast<uint2*>(dob + idx) = pk;
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && j == 0) {
    const long long bs = row / H;    // b S + s
    const long long b = bs / S, s = bs % S, h = row % H;
    delta[(b * H + h) * S + s] = sum;
  }
}

// n f32 -> bf16, n a multiple of 4
__global__ void __launch_bounds__(256)
    dq_kernel(const float* __restrict__ x, bf16* __restrict__ y, long long n4) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= n4) return;
  const float4 f = reinterpret_cast<const float4*>(x)[i];
  uint2 pk;
  pk.x = pack_bf16(f.x, f.y);
  pk.y = pack_bf16(f.z, f.w);
  reinterpret_cast<uint2*>(y)[i] = pk;
}

struct Buffers {
  const float *out, *dout;
  bf16* dob;
  const float* lse;
  float *delta, *dq_sum;
  bf16 *dq, *dk, *dv;
};

template <int D>
int launch(BwdArgs a, const Buffers& buf, int B, void* stream_) {
  using T = BwdShape<D>;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long rows = static_cast<long long>(B) * a.S * a.H;
  cudaError_t err = cudaMemsetAsync(buf.dq_sum, 0, rows * D * sizeof(float),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int G = D / 4 < 32 ? D / 4 : 32;
  delta_kernel<D><<<static_cast<unsigned>((rows * G + 255) / 256), 256, 0,
                    stream>>>(buf.dout, buf.out, buf.dob, buf.delta, rows,
                              a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.n_tiles = (a.S + T::BN - 1) / T::BN;
  a.dout = buf.dob;
  a.lse = buf.lse;
  a.delta = buf.delta;
  a.dq = buf.dq_sum;
  a.dk = buf.dk;
  a.dv = buf.dv;
  bwd_kernel<D><<<static_cast<unsigned>(B * a.H * a.n_tiles), T::kThreads,
                  T::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = rows * D / 4;
  dq_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, stream>>>(
      buf.dq_sum, buf.dq, n4);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int attrs(int* out) {
  cudaFuncAttributes f;
  cudaError_t err = cudaFuncGetAttributes(&f, bwd_kernel<D>);
  out[0] = f.numRegs;
  out[1] = static_cast<int>(f.localSizeBytes);
  out[2] = BwdShape<D>::kBytes;
  out[3] = BwdShape<D>::kThreads;
  return static_cast<int>(err);
}

}  // namespace
}  // namespace vst_flash

using namespace vst_flash;

// Backward of B x H heads of S tokens, head dim D (32, 64 or 256), on
// `stream`. q, k, v and `strides` as the forward takes them; out (the
// forward's f32 output), dout (its f32 gradient), dq_sum (f32 scratch):
// (B, S, H, D) contiguous; dob (bf16 scratch), dq, dk, dv (bf16 results):
// (B, S, H, D) contiguous; lse (the forward's), delta (f32 scratch):
// (B, H, S) contiguous. Returns the first failed launch's CUDA error code
// (0 when all four were queued).
extern "C" int vst_flash_attention_bwd(
    int D, const void* q, const void* k, const void* v,
    const long long* strides, const void* out, const void* dout, void* dob,
    const void* lse, void* delta, void* dq_sum, void* dq, void* dk, void* dv,
    int B, int S, int H, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.S = S;
  a.H = H;
  a.scale = scale;
  const Buffers buf = {static_cast<const float*>(out),
                       static_cast<const float*>(dout),
                       static_cast<bf16*>(dob),
                       static_cast<const float*>(lse),
                       static_cast<float*>(delta),
                       static_cast<float*>(dq_sum),
                       static_cast<bf16*>(dq),
                       static_cast<bf16*>(dk),
                       static_cast<bf16*>(dv)};
  switch (D) {
    case 32: return launch<32>(a, buf, B, stream);
    case 64: return launch<64>(a, buf, B, stream);
    case 256: return launch<256>(a, buf, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers a thread, local (spill) bytes a thread, dynamic shared bytes
// and threads a block of the backward's main kernel for head dim D, into
// out[0..3].
extern "C" int vst_flash_attention_bwd_attrs(int D, int* out) {
  switch (D) {
    case 32: return attrs<32>(out);
    case 64: return attrs<64>(out);
    case 256: return attrs<256>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
