// Device helpers shared by flash_attention_fwd.cu and flash_attention_bwd.cu:
// tile loads into shared memory (cp.async, zero-filled past the sequence's
// end), ldmatrix fragment loads and the m16n8k16 bf16 tensor-core product
// with f32 accumulation (mma.sync), and the tile shapes of each head dim.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): in a warp, lane =
// 4 g + t. A (16 x 16, row-major) is four registers of two bf16, a0 = (g,
// 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..); B (16 x
// 8, k x n) is two, b0 = (2t..2t+1, g), b1 = (2t+8.., g); the f32 sum C
// (16 x 8) is four, c0..c1 = (g, 2t..2t+1), c2..c3 = (g+8, 2t..). So the C
// fragments of two neighbouring 8-column tiles are, packed to bf16 pairs,
// the A fragment of a 16-deep product: a score tile computed in registers
// feeds the next product without a trip through shared memory.
//
// Shared-memory tiles are row-major with rows padded by 8 bf16 (16 bytes):
// the eight row addresses of one ldmatrix then fall in eight different
// 16-byte bank groups for every head dim used here (row strides of 80, 144
// and 528 bytes), so the loads are free of bank conflicts without a swizzle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vst_flash {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Tile shapes a head dim takes (the forward's query rows and key rows a
// block, the backward's key rows and query rows a block, and the backward's
// warps that split the head dim of one group of 16 key rows). Only the head
// dims the port's models use are instantiated: ops/attention.py:HEAD_DIMS.
template <int D>
struct Tiles;
template <>
struct Tiles<32> {
  static constexpr int kFwdM = 64, kFwdN = 64;
  static constexpr int kBwdN = 64, kBwdM = 64, kBwdSplitD = 1;
};
template <>
struct Tiles<64> {
  static constexpr int kFwdM = 128, kFwdN = 64;
  static constexpr int kBwdN = 64, kBwdM = 64, kBwdSplitD = 1;
};
template <>
struct Tiles<256> {
  static constexpr int kFwdM = 64, kFwdN = 32;
  static constexpr int kBwdN = 32, kBwdM = 64, kBwdSplitD = 4;
};

// Strides, in elements, of one (B, S, H, D) bf16 input whose last dim is
// contiguous: batch, sequence, head.
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows row0 .. row0 + R - 1 of one head (`g` points at its row 0, rows `ss`
// elements apart) into `s` (R rows of D + 8); rows at or past `seq` read as
// zeros.
template <int R, int D, int kThreads>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g,
                                          long long ss, int row0, int seq) {
  constexpr int kChunks = D / 8;   // 16-byte chunks a row
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < seq;
    cp_async16(s + r * (D + 8) + col,
               ok ? g + static_cast<long long>(row) * ss + col : g, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b, m16n8k16, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16-deep product from the f32 C fragments of the two
// 8-column tiles c0 (columns 0-7) and c1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Address of this lane's row for an ldmatrix.x4 of:
// - an A fragment (16 x 16 at row m0, column k0) of a row-major [m][k] tile
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int ld, int m0,
                                              int k0, int lane) {
  return s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}
// - the B fragments of two 8-column tiles (n0, n0 + 8; depth k0 .. k0+15) of
//   a tile stored [n][k] (non-transposed load)
__device__ __forceinline__ const bf16* bn_addr(const bf16* s, int ld, int n0,
                                               int k0, int lane) {
  return s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}
// - the B fragments of two 8-column tiles (n0, n0 + 8; depth k0 .. k0+15) of
//   a tile stored [k][n] (transposed load)
__device__ __forceinline__ const bf16* bk_addr(const bf16* s, int ld, int k0,
                                               int n0, int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}
// - an A fragment (16 x 16 at row m0, depth k0) of a tile stored [k][m]
//   (transposed load)
__device__ __forceinline__ const bf16* ak_addr(const bf16* s, int ld, int k0,
                                               int m0, int lane) {
  return s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
         ((lane >> 3) & 1) * 8;
}

}  // namespace vst_flash
