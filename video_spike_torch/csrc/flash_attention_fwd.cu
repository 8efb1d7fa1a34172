// Fused multi-head self-attention, forward: softmax(q kᵀ * scale) v over
// (B, S, H, D) bf16 inputs, f32 out, without writing the S x S scores.
// The backward is flash_attention_bwd.cu; the wrapper, its routing and a
// plain PyTorch version of both kernels' arithmetic are in
// ops/attention.py.
//
// Replaces no TPU kernel. The JAX package computes attention with XLA's
// einsum (video_spike_tpu/ops/attention.py: its Pallas fused attention was
// retired because it lost to the einsum on the TPU). The port's torch
// expression of the same math upcasts q, k and v to f32, so its products
// run on the CUDA cores, and writes the f32 score tensor of every head to
// device memory and reads it back several times. This kernel does the
// products on the tensor cores and keeps the scores on chip.
//
// Arithmetic (the configuration's bf16 with f32 accumulation):
// - s = (q . k) * scale: bf16 products, exact in f32, summed in f32 by the
//   tensor cores; scale = 1 / sqrt(D) as an f32 (the wrapper rounds it as
//   JAX does) applied in f32;
// - online softmax over key tiles: the running row max m and row sum l in
//   f32; p = exp(s - m) in f32, rounded to bf16 for p . v, which sums in
//   f32; l sums the f32 p. out = acc / l at the end, and the row's
//   log-sum-exp lse = m + log(l) is written for the backward. The torch
//   expression rounds the normalised probabilities to bf16 instead; this
//   rounds the unnormalised ones: the same precision at another point.
// - keys past the sequence's end score -inf; rows past it are not written.
//
// What bounds it on an H100: operations. At VideoMAE's decoder (64 clips x
// 6 heads x 1,568 tokens x 64) the two products are 2.4e11 FLOPs a layer,
// 0.25 ms at the 989 TFLOP/s bf16 peak, against 0.08 ms for q, k, v and the
// f32 output at 3.35 TB/s. So the design keeps the tensor cores fed:
// - one block per (query tile, batch x head), each of its warps owns 16
//   query rows and walks every key tile; the scores and the running
//   softmax stay in registers, and the score fragments are the A operand of
//   p . v (flash_attention.cuh) without a trip through shared memory;
// - K and V tiles in a two-stage shared-memory ring filled by cp.async, so
//   the next tile loads while this one is multiplied;
// - q, k and v are read in place through their strides (the packed qkv
//   projection's views, a row 3 H D apart), 16 bytes a thread.
// mma.sync (m16n8k16) and not wgmma: its C fragment is its own next A
// operand lane for lane, which wgmma's register-A form also allows but only
// with a warpgroup's 64-row tile and an asynchronous pipeline of its own;
// that is the next step for this kernel, not its first.

#include "flash_attention.cuh"

namespace vst_flash {
namespace {

struct FwdArgs {
  const bf16 *q, *k, *v;
  Strides sq, sk, sv;
  float* out;   // (B, S, H, D), contiguous
  float* lse;   // (B, H, S), contiguous
  int S, H, n_tiles;
  float scale;
};

template <int D>
constexpr int fwd_smem_bytes() {
  return (Tiles<D>::kFwdM + 4 * Tiles<D>::kFwdN) * (D + 8) *
         static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(Tiles<D>::kFwdM * 2)
    fwd_kernel(const __grid_constant__ FwdArgs a) {
  constexpr int BM = Tiles<D>::kFwdM, BN = Tiles<D>::kFwdN;
  constexpr int kThreads = BM * 2;   // a warp every 16 query rows
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LD;           // two stages of BN rows
  bf16* sV = sK + 2 * BN * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x % a.n_tiles;
  const int bh = blockIdx.x / a.n_tiles;
  const int b = bh / a.H, h = bh % a.H;
  const int S = a.S;
  const int m0 = tile * BM;
  const bf16* q = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* k = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* v = a.v + b * a.sv.b + h * a.sv.h;

  load_rows<BM, D, kThreads>(sQ, q, a.sq.s, m0, S);
  load_rows<BN, D, kThreads>(sK, k, a.sk.s, 0, S);
  load_rows<BN, D, kThreads>(sV, v, a.sv.s, 0, S);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float row_max[2] = {neg_inf(), neg_inf()};
  float row_sum[2] = {0.f, 0.f};   // this lane's share of the row sums

  const int n_keys = (S + BN - 1) / BN;
  for (int j = 0; j < n_keys; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_keys) {
      load_rows<BN, D, kThreads>(sK + (stage ^ 1) * BN * LD, k, a.sk.s,
                                 (j + 1) * BN, S);
      load_rows<BN, D, kThreads>(sV + (stage ^ 1) * BN * LD, v, a.sv.s,
                                 (j + 1) * BN, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sKs = sK + stage * BN * LD;
    const bf16* sVs = sV + stage * BN * LD;

    // s = q kᵀ: 16 query rows of this warp x BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, a_addr(sQ, LD, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, bn_addr(sKs, LD, np * 16, kk * 16, lane));
        mma(s[2 * np], qa, kb[0], kb[1]);
        mma(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // scale in f32, mask the keys past the end, update the running max
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BN + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = col < S ? s[nt][e] * a.scale : neg_inf();
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // every key tile holds at least one key, so mx is finite from here on
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = __expf(row_max[r] - mx[r]);   // 0 on the first tile
      row_max[r] = mx[r];
      row_sum[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mx[0]);
      s[nt][1] = __expf(s[nt][1] - mx[0]);
      s[nt][2] = __expf(s[nt][2] - mx[1]);
      s[nt][3] = __expf(s[nt][3] - mx[1]);
      row_sum[0] += s[nt][0] + s[nt][1];
      row_sum[1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // acc += p v, p rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, bk_addr(sVs, LD, kk * 16, dp * 16, lane));
        mma(acc[2 * dp], pa, vb[0], vb[1]);
        mma(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // this stage is read; the next load may overwrite it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / row_sum[r];
    float* o = a.out + ((static_cast<long long>(b) * S + row) * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(o + i * 8 + 2 * t) =
          make_float2(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    if (t == 0)
      a.lse[static_cast<long long>(bh) * S + row] =
          row_max[r] + logf(row_sum[r]);
  }
}

template <int D>
int launch(const FwdArgs& a, int rows, void* stream) {
  constexpr int bytes = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_kernel<D><<<rows * a.n_tiles, Tiles<D>::kFwdM * 2, bytes,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int attrs(int* out) {
  cudaFuncAttributes f;
  cudaError_t err = cudaFuncGetAttributes(&f, fwd_kernel<D>);
  out[0] = f.numRegs;
  out[1] = static_cast<int>(f.localSizeBytes);
  out[2] = fwd_smem_bytes<D>();
  out[3] = Tiles<D>::kFwdM * 2;
  return static_cast<int>(err);
}

}  // namespace
}  // namespace vst_flash

using namespace vst_flash;

// Forward of B x H heads of S tokens, head dim D (32, 64 or 256), on
// `stream`. q, k, v: bf16 with a contiguous last dim and the (batch,
// sequence, head) strides `strides[0..2]`, `[3..5]`, `[6..8]`, each 16-byte
// aligned with strides a multiple of 8; out: (B, S, H, D) f32 contiguous;
// lse: (B, H, S) f32 contiguous. Returns the launch's CUDA error code (0
// when it was queued).
extern "C" int vst_flash_attention_fwd(int D, const void* q, const void* k,
                                       const void* v,
                                       const long long* strides, void* out,
                                       void* lse, int B, int S, int H,
                                       float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.S = S;
  a.H = H;
  a.scale = scale;
  switch (D) {
    case 32:
      a.n_tiles = (S + Tiles<32>::kFwdM - 1) / Tiles<32>::kFwdM;
      return launch<32>(a, B * H, stream);
    case 64:
      a.n_tiles = (S + Tiles<64>::kFwdM - 1) / Tiles<64>::kFwdM;
      return launch<64>(a, B * H, stream);
    case 256:
      a.n_tiles = (S + Tiles<256>::kFwdM - 1) / Tiles<256>::kFwdM;
      return launch<256>(a, B * H, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers a thread, local (spill) bytes a thread, dynamic shared bytes
// and threads a block of the forward kernel for head dim D, into out[0..3].
extern "C" int vst_flash_attention_fwd_attrs(int D, int* out) {
  switch (D) {
    case 32: return attrs<32>(out);
    case 64: return attrs<64>(out);
    case 256: return attrs<256>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
