// Fused rank-B readout update with stochastic rounding into a bf16 weight:
//
//     W <- SR_bf16( f32(W) + xa^T @ dzc )
//
// W: bf16 (M, N) row-major, updated IN PLACE (the JAX step donates W, so the
// port keeps one 1 GB buffer instead of two); xa: f32 (B, M) row-major, read
// in that layout (no transposed copy); dzc: f32 (B, N). Any M, N, B >= 1.
//
// Replaces the TPU kernel video_spike_tpu/ops/fused_readout.py:161
// (_fused_kernel, launched by _apply_scaled_outer_pallas) and computes
// exactly what _apply_scaled_outer_xla computes for a bf16 W: the rank-B f32
// product (f32 FMAs on CUDA cores, b ascending from 0: no TF32, no tensor
// cores, so exact sums stay bitwise), the f32 add, then the low 16 bits of a
// murmur3-finalizer hash of the absolute flat index row*N+col (uint32,
// wrapping), keyed by seed*0x9E3779B9 + (999983*0x85EBCA6B mod 2^32), added
// to the f32 pattern and truncated to bf16.
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s of f32 FMA). A call must
// read W and xa once and write W once, 2*M*N*2 + B*M*4 bytes, and do
// 2*B*M*N flops. At the Linear shape (M = 1,966,080, N = 256): B = 16 moves
// 2.139 GB (0.639 ms) against 16.1 GFLOP (0.240 ms), bytes; at the probe's
// (M = 1,204,224, B = 8) 1.272 GB (0.380 ms), bytes; at the gathered batch
// of 4 data-parallel ranks, B = 64, 64.4 GFLOP (0.962 ms) against 2.517 GB
// (0.751 ms), the FMAs. Beside the B FMAs each weight costs ~13 integer
// and float instructions (hash, SR, bf16 unpack and pack), so at B = 16 the
// instruction work is as large as the byte work: the design hides the bytes
// behind the instructions and cuts the instructions.
//
// Design (one producer warp, eight consumer warps, a persistent grid):
// - the launch plan (tile TM x TN, ring depth, B-chunk, shared-memory bytes)
//   comes from the Python wrapper (ops/fused_readout.py:_launch_plan); the
//   host function below recomputes the layout and refuses a plan whose
//   bytes disagree;
// - one or two blocks an SM walk the tiles with a grid stride; a ring of
//   `stages` stages in dynamic shared memory (opted in up to 227 KB) holds
//   a W tile and its xa rows each, with a full and an empty mbarrier a
//   stage. The producer warp fills stages ahead with TMA bulk copies
//   (cp.async.bulk ... mbarrier::complete_tx): a W tile is one contiguous
//   run of TM*N*2 bytes when TN == N, one copy a row otherwise; xa is one
//   copy per factor row. So while the consumers compute a tile, the next
//   stages' bytes are in flight and no consumer instruction is spent on
//   loads from device memory;
// - dzc stays in shared memory for the block's life where it fits beside
//   the ring (stored with its 16-byte halves swizzled so that 8 column
//   groups read conflict-free); where it does not, each stage also carries
//   a chunk of B rows of dzc, and the tile's sums carry over the chunks in
//   registers (one item a thread) or in shared memory;
// - a consumer thread owns 4 rows x 8 columns and a warp 16 rows x 64
//   columns, so each dzc float4 serves 4 rows and each xa float4 8
//   columns; B is unrolled in chunks of 8; the epilogue reads W from the
//   stage, adds, rounds with the SR bits, and stores 16-byte vectors
//   straight to W, then the warp releases the stage;
// - the fused steps' tile (TM = 32, N = 256) has its own instances, in
//   which every shared-memory stride is a constant (each load of the
//   unrolled sums takes an immediate offset), and, for the fused steps' B
//   (8, 16, and 64 gathered from 4 data-parallel ranks) with dzc resident,
//   B too: the sums are then one straight-line block
//   with the SR hash of the item's elements placed between its factor
//   rows, so that the integer pipe's hash issues beside the FMA pipe's
//   sums instead of after them;
// - shapes that break an alignment take the same kernel by another code
//   path, chosen by shape: N % 8 != 0 (or W not 16-byte aligned) gives
//   single-column items with 2-byte stores, and the bytes of a contiguous
//   W tile past its last 16-byte boundary are read from W by the consumer
//   that writes them; M % 4 != 0 (or xa not 16-byte aligned) has the
//   producer warp load xa itself; a column-tiled W whose rows are not
//   16-byte aligned is loaded the same way.

#include <cuda_runtime.h>
#include <stdint.h>

// the launch plan, as ops/fused_readout.py:_CPlan lays it out
struct VstPlan {
  int tm, tn, stages, b_chunk, vec, w_mode, xa_tma, dzc_resident, acc_smem,
      smem_bytes, grid;
};

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kSmemMax = 232448;           // a block's opt-in limit, sm_90
constexpr int kR = 4;                      // the rows a consumer item owns
constexpr uint32_t kLeafConst = 0x3CBEBFA5u;  // (999983 * 0x85EBCA6B) mod 2^32

struct Params {
  uint16_t* w;
  const float* xa;
  const float* dzc;
  long long m;
  int n, b;
  uint32_t key;
  int tm, tn, stages, b_chunk, n_chunks, items, w_mode, xa_tma,
      dzc_resident, acc_smem, col_tiles;
  long long tiles;
  // byte offsets in dynamic shared memory, and within a stage
  uint32_t off_dzc, off_acc, off_ring, stage_bytes, off_xa, off_dzs;
};

inline uint64_t align128(uint64_t x) {
  return (x + 127u) & ~static_cast<uint64_t>(127u);
}

// ---- mbarriers and bulk copies (sm_90) -----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- the arithmetic --------------------------------------------------------

// position of column `col` in a swizzled dzc row: the two float4 halves of
// each 8-column group swap in every other run of 4 groups, so 8 consecutive
// groups' halves cover all 32 banks
__device__ __forceinline__ int swz(int col) {
  return col ^ (((col >> 5) & 1) << 2);
}

// low 16 bits of the murmur3 finalizer of x = flat + key
__device__ __forceinline__ uint32_t sr_bits(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return (x ^ (x >> 16)) & 0xFFFFu;
}

// two bf16 weights (a packed pair) plus their f32 updates and SR bits,
// rounded and packed again
__device__ __forceinline__ uint32_t sr_pair_bits(uint32_t pair, float u_lo,
                                                 float u_hi, uint32_t b_lo,
                                                 uint32_t b_hi) {
  const float lo = __uint_as_float(pair << 16) + u_lo;
  const float hi = __uint_as_float(pair & 0xFFFF0000u) + u_hi;
  return __byte_perm(__float_as_uint(lo) + b_lo, __float_as_uint(hi) + b_hi,
                     0x7632);
}

__device__ __forceinline__ uint16_t sr_one(uint16_t w, float u, uint32_t x) {
  const float s = __uint_as_float(static_cast<uint32_t>(w) << 16) + u;
  return static_cast<uint16_t>((__float_as_uint(s) + sr_bits(x)) >> 16);
}

// acc[r][j] += xa[b, r] * dzc[b, j] for one factor row b: x points at the
// item's rows of xa, d0 and d1 at the two halves of its 8-column group
__device__ __forceinline__ void fma_row8(float (&acc)[kR][8], const float* x,
                                         const float* d0, const float* d1) {
  const float4 lo = *reinterpret_cast<const float4*>(d0);
  const float4 hi = *reinterpret_cast<const float4*>(d1);
  const float dv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int q = 0; q < kR / 4; ++q) {
    const float4 a = *reinterpret_cast<const float4*>(x + 4 * q);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * q + r][j] = fmaf(av[r], dv[j], acc[4 * q + r][j]);
      }
    }
  }
}

__device__ __forceinline__ void fma_row1(float (&acc)[kR][1], const float* x,
                                         const float* d0, const float*) {
  const float dv = *d0;
#pragma unroll
  for (int q = 0; q < kR / 4; ++q) {
    const float4 a = *reinterpret_cast<const float4*>(x + 4 * q);
    acc[4 * q + 0][0] = fmaf(a.x, dv, acc[4 * q + 0][0]);
    acc[4 * q + 1][0] = fmaf(a.y, dv, acc[4 * q + 1][0]);
    acc[4 * q + 2][0] = fmaf(a.z, dv, acc[4 * q + 2][0]);
    acc[4 * q + 3][0] = fmaf(a.w, dv, acc[4 * q + 3][0]);
  }
}

// the item's sums over factor rows [0, nb) of a stage, in ascending order,
// 8 rows unrolled at a time. xs and ds are the row strides of xa and dzc;
// kXS / kDS, when not 0, fix them at compile time, so that every load of
// the unrolled steps takes an immediate offset
template <bool kVec, int kCW, int kXS, int kDS>
__device__ __forceinline__ void fma_chunk(float (&acc)[kR][kCW],
                                          const float* x, int x_stride,
                                          const float* d0, const float* d1,
                                          int d_stride, int nb) {
  const int xs = kXS > 0 ? kXS : x_stride;
  const int ds = kDS > 0 ? kDS : d_stride;
  int bi = 0;
  for (; bi + 8 <= nb; bi += 8) {
    const float* xb = x + bi * xs;
    const float* d0b = d0 + bi * ds;
    const float* d1b = d1 + bi * ds;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (kVec) {
        fma_row8(acc, xb + k * xs, d0b + k * ds, d1b + k * ds);
      } else {
        fma_row1(acc, xb + k * xs, d0b + k * ds, d1b + k * ds);
      }
    }
  }
  for (; bi < nb; ++bi) {
    if constexpr (kVec) {
      fma_row8(acc, x + bi * xs, d0 + bi * ds, d1 + bi * ds);
    } else {
      fma_row1(acc, x + bi * xs, d0 + bi * ds, d1 + bi * ds);
    }
  }
}

// ---- the two roles ---------------------------------------------------------

struct Tile {
  long long row0;
  int c0, rows, cols;
};

__device__ __forceinline__ Tile tile_at(const Params& p, long long t) {
  const long long rt = t / p.col_tiles;
  Tile tile;
  tile.row0 = rt * p.tm;
  tile.c0 = static_cast<int>(t - rt * p.col_tiles) * p.tn;
  const long long left = p.m - tile.row0;
  tile.rows = left < p.tm ? static_cast<int>(left) : p.tm;
  tile.cols = min(p.tn, p.n - tile.c0);
  return tile;
}

// one warp: for every (tile, B-chunk) unit, wait for its stage to be free,
// load what bulk copies cannot take, then post the bytes and the copies
template <bool kVec>
__device__ __forceinline__ void produce(const Params& p, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int lane) {
  int s = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tile = tile_at(p, t);
    for (int c = 0; c < p.n_chunks; ++c) {
      const int b0 = c * p.b_chunk;
      const int nb = min(p.b_chunk, p.b - b0);
      const bool last = c == p.n_chunks - 1;
      unsigned char* st = smem + p.off_ring + s * p.stage_bytes;
      uint16_t* w_st = reinterpret_cast<uint16_t*>(st);
      float* xa_st = reinterpret_cast<float*>(st + p.off_xa);
      float* dz_st = reinterpret_cast<float*>(st + p.off_dzs);
      mbar_wait(&empty[s], phase ^ 1u);

      if (!p.xa_tma) {
        for (int i = lane; i < nb * tile.rows; i += 32) {
          const int bi = i / tile.rows, r = i - bi * tile.rows;
          xa_st[bi * p.tm + r] = p.xa[(b0 + bi) * p.m + tile.row0 + r];
        }
      }
      if (!p.dzc_resident) {
        for (int i = lane; i < nb * tile.cols; i += 32) {
          const int bi = i / tile.cols, cc = i - bi * tile.cols;
          dz_st[bi * p.tn + (kVec ? swz(cc) : cc)] =
              p.dzc[static_cast<long long>(b0 + bi) * p.n + tile.c0 + cc];
        }
      }
      if (last && p.w_mode == 0) {
        for (int i = lane; i < tile.rows * tile.cols; i += 32) {
          const int r = i / tile.cols, cc = i - r * tile.cols;
          w_st[r * p.tn + cc] = p.w[(tile.row0 + r) * p.n + tile.c0 + cc];
        }
      }
      __threadfence_block();
      __syncwarp();

      uint32_t w_bytes = 0;
      if (last && p.w_mode == 1) {  // the tile's whole 16-byte runs
        w_bytes = (static_cast<uint32_t>(tile.rows) * p.n * 2u) & ~15u;
      } else if (last && p.w_mode == 2) {
        w_bytes = static_cast<uint32_t>(tile.rows * tile.cols) * 2u;
      }
      const uint32_t xa_bytes =
          p.xa_tma ? static_cast<uint32_t>(nb * tile.rows) * 4u : 0u;
      if (lane == 0) mbar_arrive_tx(&full[s], w_bytes + xa_bytes);
      __syncwarp();
      if (p.xa_tma) {
        for (int bi = lane; bi < nb; bi += 32) {
          bulk_copy(xa_st + bi * p.tm, p.xa + (b0 + bi) * p.m + tile.row0,
                    tile.rows * 4u, &full[s]);
        }
      }
      if (last && p.w_mode == 1 && lane == 0 && w_bytes) {
        bulk_copy(w_st, p.w + tile.row0 * p.n, w_bytes, &full[s]);
      } else if (last && p.w_mode == 2) {
        for (int r = lane; r < tile.rows; r += 32) {
          bulk_copy(w_st + r * p.tn, p.w + (tile.row0 + r) * p.n + tile.c0,
                    tile.cols * 2u, &full[s]);
        }
      }
      if (++s == p.stages) {
        s = 0;
        phase ^= 1u;
      }
    }
  }
}

// eight warps: for every unit, wait for its stage, take each owned item's
// sums over the stage's factor rows, and on a tile's last chunk round and
// store it; then release the stage (one arrival a warp). kTM and kN, when
// not 0, are the tile's rows and W's columns fixed at compile time (then
// TN == N == kN, and every stride below is a constant); kNB, when not 0,
// is B with dzc resident
template <bool kVec, int kTM, int kN, int kNB>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        const float* dzc_s, int ctid) {
  constexpr int kCW = kVec ? 8 : 1;
  const int tm = kTM > 0 ? kTM : p.tm;
  const int tn = kN > 0 ? kN : p.tn;
  const int n = kN > 0 ? kN : p.n;
  float acc[kR][kCW];
  float* acc_s = reinterpret_cast<float*>(smem + p.off_acc);
  const int col_blocks = kVec ? ((tn >> 3) + 7) >> 3 : (tn + 31) >> 5;
  int s = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tile = tile_at(p, t);
    // a contiguous tile's elements past its last 16-byte run stay in W
    const int tail_from =
        p.w_mode == 1
            ? static_cast<int>(
                  ((static_cast<uint32_t>(tile.rows) * n * 2u) & ~15u) >> 1)
            : 0x7FFFFFFF;
    for (int c = 0; c < p.n_chunks; ++c) {
      const int b0 = c * p.b_chunk;
      const int nb = min(p.b_chunk, p.b - b0);
      const bool last = c == p.n_chunks - 1;
      const unsigned char* st = smem + p.off_ring + s * p.stage_bytes;
      const uint16_t* w_st = reinterpret_cast<const uint16_t*>(st);
      const float* xa_st = reinterpret_cast<const float*>(st + p.off_xa);
      const float* dz = p.dzc_resident
                            ? dzc_s + b0 * n + tile.c0
                            : reinterpret_cast<const float*>(st + p.off_dzs);
      const int dz_stride = p.dzc_resident ? n : tn;
      mbar_wait(&full[s], phase);

      for (int i = ctid; i < p.items; i += kConsumers) {
        const int lane = i & 31, wb = i >> 5;
        int rg, col;  // the item's row group and first column in the tile
        if constexpr (kVec) {
          rg = (wb / col_blocks) * 4 + (lane >> 3);
          col = ((wb % col_blocks) * 8 + (lane & 7)) * 8;
        } else {
          rg = wb / col_blocks;
          col = (wb % col_blocks) * 32 + lane;
        }
        if (col >= tile.cols) continue;
        if (c == 0) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
#pragma unroll
            for (int j = 0; j < kCW; ++j) acc[r][j] = 0.0f;
          }
        } else if (p.acc_smem) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
#pragma unroll
            for (int j = 0; j < kCW; ++j) {
              acc[r][j] = acc_s[(r * kCW + j) * p.items + i];
            }
          }
        }
        // the item's first row: its W in the stage and in device memory,
        // and its first element's hashed index (uint32, wrapping)
        const int lr0 = rg * kR;
        const int gcol = tile.c0 + col;
        const long long row0 = tile.row0 + lr0;
        const uint32_t x0 =
            static_cast<uint32_t>(row0) * static_cast<uint32_t>(n) +
            static_cast<uint32_t>(gcol) + p.key;
        // the swizzled halves of the column group (vec): half 0 first in
        // groups 0-3 of every 8, half 1 first in groups 4-7
        const int o0 = kVec ? (((col >> 5) & 1) << 2) : 0;
        const float* x = xa_st + rg * kR;
        const float* d0 = dz + col + o0;
        const float* d1 = dz + col + (o0 ^ 4);
        // the SR bits of the item's elements (vec), a function of the index
        // alone; with B fixed at compile time (kNB) the sums are one
        // straight-line block, and after factor row k come the bits of the
        // item's elements [k * E / B, (k + 1) * E / B), so that the integer
        // pipe's hash issues between the FMA pipe's sums
        uint32_t bits[kR][kCW];
        if constexpr (kNB > 0) {
          constexpr int kE = kR * kCW;
#pragma unroll
          for (int k = 0; k < kNB; ++k) {
            fma_row8(acc, x + k * kTM, d0 + k * kN, d1 + k * kN);
#pragma unroll
            for (int e = k * kE / kNB; e < (k + 1) * kE / kNB; ++e) {
              bits[e / kCW][e % kCW] = sr_bits(
                  x0 + static_cast<uint32_t>((e / kCW) * n + e % kCW));
            }
          }
        } else {
          fma_chunk<kVec, kCW, kTM, kN>(acc, x, tm, d0, d1, dz_stride, nb);
          if constexpr (kVec) {
            if (last) {
#pragma unroll
              for (int r = 0; r < kR; ++r) {
#pragma unroll
                for (int j = 0; j < kCW; ++j) {
                  bits[r][j] =
                      sr_bits(x0 + static_cast<uint32_t>(r * n + j));
                }
              }
            }
          }
        }
        if (!last) {
          if (p.acc_smem) {
#pragma unroll
            for (int r = 0; r < kR; ++r) {
#pragma unroll
              for (int j = 0; j < kCW; ++j) {
                acc_s[(r * kCW + j) * p.items + i] = acc[r][j];
              }
            }
          }
          continue;
        }
        const uint16_t* ws = w_st + lr0 * tn + col;
        uint16_t* wg = p.w + row0 * n + gcol;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (lr0 + r < tile.rows) {
            const uint32_t xr = x0 + static_cast<uint32_t>(r * n);
            if constexpr (kVec) {
              const uint4 wv = *reinterpret_cast<const uint4*>(ws + r * tn);
              uint4 out;
              out.x = sr_pair_bits(wv.x, acc[r][0], acc[r][1], bits[r][0],
                                   bits[r][1]);
              out.y = sr_pair_bits(wv.y, acc[r][2], acc[r][3], bits[r][2],
                                   bits[r][3]);
              out.z = sr_pair_bits(wv.z, acc[r][4], acc[r][5], bits[r][4],
                                   bits[r][5]);
              out.w = sr_pair_bits(wv.w, acc[r][6], acc[r][7], bits[r][6],
                                   bits[r][7]);
              *reinterpret_cast<uint4*>(wg + static_cast<long long>(r) * n) =
                  out;
            } else {
              const int e = (lr0 + r) * tn + col;
              uint16_t* wr = wg + static_cast<long long>(r) * n;
              const uint16_t wv = e >= tail_from ? *wr : w_st[e];
              *wr = sr_one(wv, acc[r][0], xr);
            }
          }
        }
      }
      __syncwarp();
      if ((ctid & 31) == 0) mbar_arrive(&empty[s]);
      if (++s == p.stages) {
        s = 0;
        phase ^= 1u;
      }
    }
  }
}

template <bool kVec, int kTM, int kN, int kNB>
__global__ void __launch_bounds__(kThreads, 2)
fused_readout_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + p.stages;
  float* dzc_s = reinterpret_cast<float*>(smem + p.off_dzc);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.dzc_resident) {
    const int total = p.b * p.n;
    for (int i = tid; i < total; i += kThreads) {
      const int bb = i / p.n, col = i - bb * p.n;
      dzc_s[bb * p.n + (kVec ? swz(col) : col)] = p.dzc[i];
    }
  }
  __syncthreads();
  if (tid >= kConsumers) {
    produce<kVec>(p, smem, full, empty, tid - kConsumers);
  } else {
    consume<kVec, kTM, kN, kNB>(p, smem, full, empty, dzc_s, tid);
  }
}

template <bool kVec, int kTM = 0, int kN = 0, int kNB = 0>
cudaError_t launch(const Params& p, const VstPlan& plan, cudaStream_t stream) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(fused_readout_kernel<kVec, kTM, kN, kNB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fused_readout_kernel<kVec, kTM, kN, kNB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  fused_readout_kernel<kVec, kTM, kN, kNB>
      <<<plan.grid, kThreads, plan.smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// W (m, n) bf16 <- SR(W + xa^T @ dzc) in place, on `stream`, by `plan`.
// Returns a cudaError_t: cudaErrorInvalidValue for a plan that this shape
// cannot take or whose shared-memory bytes disagree with the layout here.
extern "C" int vst_apply_scaled_outer_bf16(void* w, const void* xa,
                                           const void* dzc, long long m,
                                           int n, int b, unsigned int seed,
                                           const VstPlan* plan, void* stream) {
  const VstPlan& q = *plan;
  const bool vec = q.vec != 0;
  const int cw = vec ? 8 : 1;
  bool ok = m > 0 && n > 0 && b > 0 && q.tm > 0 && q.tm % 8 == 0 &&
            q.tn > 0 && q.tn <= n && q.stages >= 2 && q.b_chunk >= 1 &&
            q.b_chunk <= b &&
            q.w_mode >= 0 && q.w_mode <= 2 && q.grid > 0 &&
            (q.w_mode != 1 || q.tn == n) && (!q.xa_tma || m % 4 == 0) &&
            (!q.dzc_resident || q.b_chunk == b);
  if (vec) {
    ok = ok && n % 8 == 0 && q.tm % (4 * kR) == 0 &&
         (q.tn == n || q.tn % 64 == 0);
  } else {
    ok = ok && q.tm % kR == 0 && (q.tn == n || q.tn % 32 == 0) &&
         q.w_mode != 2;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.w = static_cast<uint16_t*>(w);
  p.xa = static_cast<const float*>(xa);
  p.dzc = static_cast<const float*>(dzc);
  p.m = m;
  p.n = n;
  p.b = b;
  p.key = static_cast<uint32_t>(seed) * 0x9E3779B9u + kLeafConst;
  p.tm = q.tm;
  p.tn = q.tn;
  p.stages = q.stages;
  p.b_chunk = q.b_chunk;
  p.n_chunks = (b + q.b_chunk - 1) / q.b_chunk;
  p.items = vec ? (q.tm / kR) * (((q.tn / 8) + 7) / 8 * 8)
                : (q.tm / kR) * ((q.tn + 31) / 32 * 32);
  p.w_mode = q.w_mode;
  p.xa_tma = q.xa_tma;
  p.dzc_resident = q.dzc_resident;
  p.acc_smem = q.acc_smem;
  p.col_tiles = (n + q.tn - 1) / q.tn;
  p.tiles = (m + q.tm - 1) / q.tm * p.col_tiles;
  if (q.grid > p.tiles) return static_cast<int>(cudaErrorInvalidValue);

  // the layout of ops/fused_readout.py:_smem_bytes
  const uint64_t tm = q.tm, tn = q.tn, bc = q.b_chunk;
  const uint64_t w_part = align128(tm * tn * 2);
  const uint64_t xa_part = align128(bc * tm * 4);
  const uint64_t dz_part = q.dzc_resident ? 0 : align128(bc * tn * 4);
  const uint64_t dzc_res =
      q.dzc_resident ? align128(static_cast<uint64_t>(b) * n * 4) : 0;
  const uint64_t acc =
      q.acc_smem ? align128(static_cast<uint64_t>(p.items) * kR * cw * 4)
                 : 0;
  if (w_part + xa_part + dz_part + dzc_res + acc > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.off_dzc = static_cast<uint32_t>(align128(16u * q.stages));
  p.off_acc = static_cast<uint32_t>(p.off_dzc + dzc_res);
  p.off_ring = static_cast<uint32_t>(p.off_acc + acc);
  p.stage_bytes = static_cast<uint32_t>(w_part + xa_part + dz_part);
  p.off_xa = static_cast<uint32_t>(w_part);
  p.off_dzs = static_cast<uint32_t>(w_part + xa_part);
  const uint64_t total =
      static_cast<uint64_t>(p.off_ring) +
      static_cast<uint64_t>(q.stages) * p.stage_bytes;
  if (total != static_cast<uint64_t>(q.smem_bytes) || total > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!vec) {
    err = launch<false>(p, q, st);
  } else if (q.tm == 32 && q.tn == 256 && n == 256) {  // the fused steps'
    switch (q.dzc_resident ? b : 0) {                  // tile and batches
      case 8: err = launch<true, 32, 256, 8>(p, q, st); break;
      case 16: err = launch<true, 32, 256, 16>(p, q, st); break;
      case 64: err = launch<true, 32, 256, 64>(p, q, st); break;
      default: err = launch<true, 32, 256>(p, q, st);
    }
  } else {
    err = launch<true>(p, q, st);
  }
  return static_cast<int>(err);
}
