// Fused rank-B readout update with stochastic rounding into a bf16 weight:
//
//     W <- SR_bf16( f32(W) + xa^T @ dzc )
//
// W: bf16 (M, N) row-major, updated IN PLACE (the JAX step donates W, so the
// port keeps one 1 GB buffer instead of two); xa: f32 (B, M) row-major, read
// in that layout with strides (no transposed copy); dzc: f32 (B, N).
//
// Replaces the TPU kernel video_spike_tpu/ops/fused_readout.py:_fused_kernel
// (launched by _apply_scaled_outer_pallas) and computes exactly what
// _apply_scaled_outer_xla computes for a bf16 W: the rank-B f32 product, the
// f32 add, then the low 16 bits of a murmur3-finalizer hash of the absolute
// flat index row*N+col (uint32, wrapping), keyed by
// seed*0x9E3779B9 + (999983*0x85EBCA6B mod 2^32), added to the f32 pattern
// and truncated to bf16.
//
// Bound on this card: bytes. Per call it must read W and xa once and write W
// once: 2*M*N*2 + B*M*4 bytes (2.14 GB at M=1,966,080, N=256, B=16, about
// 0.64 ms at 3.35 TB/s). The arithmetic is B f32 FMAs plus ~10 integer ops
// per element (16.1 GFLOP of FMA at that shape), far below the card's rates.
//
// Design (simple and correct first; faster pipelining is later work):
// - a block keeps dzc (B*N f32, 16 KB at B=16, N=256) in shared memory for
//   its whole life and walks row tiles of kTileRows rows with a grid stride,
//   so dzc is read from L2 once per block, not once per tile;
// - per tile it stages xa[:, tile] (B*kTileRows f32) in shared memory with
//   coalesced loads along M;
// - each thread owns 8 consecutive columns of kRowsPerThread rows: it loads
//   W as 16-byte vectors first (so the loads are in flight during the FMAs),
//   keeps the B-term sums in registers, adds f32(W), hashes each element's
//   absolute index in native uint32, rounds, and stores 16-byte vectors;
// - any M is taken: rows past M read xa as 0 and are never stored.
// The host function checks nothing: the Python wrapper validates device,
// dtype, shape, contiguity, M > 0, N % 8 == 0 and the shared memory
// (B * (N + kTileRows) floats within the default 48 KB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 32;
constexpr int kRowsPerThread = 4;
constexpr int kMaxBlocks = 4096;
constexpr uint32_t kLeafConst = 0x3CBEBFA5u;  // (999983 * 0x85EBCA6B) mod 2^32

__device__ __forceinline__ uint32_t mix_bits(uint32_t flat, uint32_t key) {
  uint32_t x = flat + key;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// bf16 bits of SR(s): add the low 16 hash bits to the f32 pattern, truncate.
__device__ __forceinline__ uint32_t sr_bf16_bits(float s, uint32_t bits) {
  uint32_t raw = __float_as_uint(s);
  raw = (raw + (bits & 0xFFFFu)) & 0xFFFF0000u;
  return raw >> 16;
}

__device__ __forceinline__ float bf16_lo(uint32_t pair) {
  return __uint_as_float(pair << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xFFFF0000u);
}

__global__ void __launch_bounds__(kThreads)
apply_scaled_outer_bf16_kernel(uint16_t* __restrict__ w,
                               const float* __restrict__ xa,
                               const float* __restrict__ dzc,
                               long long m, int n, int b, uint32_t key) {
  extern __shared__ float smem[];
  float* dzc_s = smem;              // (b, n)
  float* xa_s = smem + b * n;       // (b, kTileRows)

  for (int i = threadIdx.x; i < b * n; i += blockDim.x) dzc_s[i] = dzc[i];

  const int col_groups = n / 8;
  const int items = col_groups * (kTileRows / kRowsPerThread);
  const long long n_tiles = (m + kTileRows - 1) / kTileRows;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    __syncthreads();  // previous tile's readers of xa_s are done
    for (int i = threadIdx.x; i < b * kTileRows; i += blockDim.x) {
      const int bb = i / kTileRows;
      const long long row = row0 + (i % kTileRows);
      xa_s[i] = row < m ? xa[(long long)bb * m + row] : 0.0f;
    }
    __syncthreads();

    for (int item = threadIdx.x; item < items; item += blockDim.x) {
      const int c0 = (item % col_groups) * 8;
      const int r0 = (item / col_groups) * kRowsPerThread;

      uint4 wv[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const long long row = row0 + r0 + r;
        if (row < m) {
          wv[r] = *reinterpret_cast<const uint4*>(w + row * n + c0);
        } else {
          wv[r] = make_uint4(0u, 0u, 0u, 0u);
        }
      }

      float acc[kRowsPerThread][8];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
      }
      for (int bb = 0; bb < b; ++bb) {
        const float4 d0 = *reinterpret_cast<const float4*>(dzc_s + bb * n + c0);
        const float4 d1 =
            *reinterpret_cast<const float4*>(dzc_s + bb * n + c0 + 4);
        const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float a = xa_s[bb * kTileRows + r0 + r];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a, d[j], acc[r][j]);
        }
      }

#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const long long row = row0 + r0 + r;
        if (row >= m) continue;
        const uint32_t flat0 = (uint32_t)row * (uint32_t)n + (uint32_t)c0;
        const uint32_t in[4] = {wv[r].x, wv[r].y, wv[r].z, wv[r].w};
        uint32_t out[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int j = 2 * p;
          const float s_lo = bf16_lo(in[p]) + acc[r][j];
          const float s_hi = bf16_hi(in[p]) + acc[r][j + 1];
          const uint32_t lo = sr_bf16_bits(s_lo, mix_bits(flat0 + j, key));
          const uint32_t hi = sr_bf16_bits(s_hi, mix_bits(flat0 + j + 1, key));
          out[p] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(w + row * n + c0) =
            make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
  }
}

}  // namespace

extern "C" int vst_apply_scaled_outer_bf16(void* w, const void* xa,
                                           const void* dzc, long long m,
                                           int n, int b, unsigned int seed,
                                           void* stream) {
  const uint32_t key = (uint32_t)seed * 0x9E3779B9u + kLeafConst;
  const long long n_tiles = (m + kTileRows - 1) / kTileRows;
  const int blocks = (int)(n_tiles < kMaxBlocks ? n_tiles : kMaxBlocks);
  const size_t smem = (size_t)(b * n + b * kTileRows) * sizeof(float);
  apply_scaled_outer_bf16_kernel<<<blocks, kThreads, smem,
                                   (cudaStream_t)stream>>>(
      static_cast<uint16_t*>(w), static_cast<const float*>(xa),
      static_cast<const float*>(dzc), m, n, b, key);
  return (int)cudaGetLastError();
}

extern "C" int vst_fused_readout_tile_rows(void) { return kTileRows; }
