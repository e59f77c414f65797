// What the flash-attention kernels on the tensor cores (flash_fwd.cu's
// bf16 forward, flash_bwd.cu's bf16 K2 and K3) share: the block's 64 rows
// and a warpgroup's 128 output columns, the copy of a head's rows into a
// 128-byte swizzled tile (hopper.cuh) with zero fill past N and past the
// width d, the bf16 stores of accumulator pairs, and the grid's column
// groups.
//
// Copies: 16-byte cp.async where a row chunk is 16-byte aligned (every
// width that is a multiple of 8); a d = 276 row is 552 bytes, so every
// other row is only 8-byte aligned and loads as two 8-byte cp.async;
// other widths load element by element. TMA would need 16-byte strides.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash_tiles {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kRows = 64;   // rows a block owns: wgmma's M
constexpr int kCols = 128;  // output columns a warpgroup owns at most
constexpr float kLog2e = 1.4426950408889634f;

// bytes of a tile of `rows` rows at kernel width `d`: 64-wide column atoms
__host__ __device__ constexpr int tile_bytes(int rows, int d) {
  return rows * 128 * ((d + 63) / 64);
}

__device__ __forceinline__ void st_zero16(uint32_t dst) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
               :: "r"(dst), "r"(0) : "memory");
}

// One 16-byte chunk of a tile: the first `valid` (at most 8) values from
// `src`, zeros after them. The widest copy the source's alignment allows.
__device__ __forceinline__ void load_chunk(uint32_t dst,
                                           const bf16* __restrict__ src,
                                           int valid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (valid <= 0) {
    st_zero16(dst);
  } else if ((a & 15) == 0) {
    cp_async<16>(dst, src, 2 * valid);
  } else if ((a & 7) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = min(max(valid - 4 * h, 0), 4);
      cp_async<8>(dst + 8 * h, v ? src + 4 * h : src, 2 * v);
    }
  } else {  // element by element
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint16_t lo = 2 * h < valid ? __bfloat16_as_ushort(src[2 * h]) : 0;
      const uint16_t hi =
          2 * h + 1 < valid ? __bfloat16_as_ushort(src[2 * h + 1]) : 0;
      w[h] = uint32_t(lo) | (uint32_t(hi) << 16);
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// Rows r0 .. r0 + kTileRows - 1 of one head's (n, d) array into a tile of
// kernel width kD; rows at or past n and columns at or past d are zeros.
// `aligned`: d is a multiple of 8 and the arrays 16-byte aligned, so every
// chunk is one 16-byte copy (or zero fill) with no test of its alignment
// (at every kernel width but 288, whose 36 chunks a row do not divide the
// block).
template <int kTileRows, int kD, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const bf16* __restrict__ src,
                                          int r0, int n, int d, bool aligned) {
  constexpr int kChunks = kD / 8;
  constexpr int kStep = kThreads / kChunks;  // rows a pass of the block
  if constexpr (kThreads % kChunks == 0 && kStep % 8 == 0) {
    // a thread keeps its chunk c and its row's swizzle in every pass
    if (aligned) {
      const int r = threadIdx.x / kChunks;
      const int c = threadIdx.x % kChunks;
      const uint32_t dst = tile + tile_offset(kTileRows, r, c);
      const bf16* from = src + size_t(r0 + r) * d + 8 * c;
      const bool col_ok = 8 * c < d;
#pragma unroll
      for (int j = 0; j < kTileRows / kStep; ++j) {
        const bool ok = col_ok && r0 + r + j * kStep < n;
        cp_async<16>(dst + j * kStep * 128,
                     ok ? from + size_t(j) * kStep * d : src, ok ? 16 : 0);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < kTileRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int row = r0 + r;
    load_chunk(tile + tile_offset(kTileRows, r, c),
               src + size_t(row) * d + 8 * c,
               row < n ? min(d - 8 * c, 8) : 0);
  }
}

// Whether load_tile's 16-byte path takes these arrays.
__device__ __forceinline__ bool aligned16(int d, const void* a, const void* b,
                                          const void* c, const void* e) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b) |
                      reinterpret_cast<uintptr_t>(c) |
                      reinterpret_cast<uintptr_t>(e);
  return d % 8 == 0 && (x & 15) == 0;
}

// Whether an output's rows take bf16 pairs: an even width, 4-byte aligned.
__device__ __forceinline__ bool pairs_ok(const bf16* out, int d) {
  return d % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
}

// Two adjacent values of an output row (columns col, col + 1) in bf16,
// those at or past d dropped.
__device__ __forceinline__ void store_pair(bf16* __restrict__ row, int col,
                                           int d, bool pairs, float x,
                                           float y) {
  if (pairs && col + 1 < d) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
  } else {
    if (col < d) row[col] = __float2bfloat16(x);
    if (col + 1 < d) row[col + 1] = __float2bfloat16(y);
  }
}

template <int kN>
__device__ __forceinline__ void zero(float (&x)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = 0.f;
}

// Column of accumulator register i (of an m64nN tile) for this lane; its
// row is 16 * warp + lane / 4 + 8 * ((i / 2) % 2).
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Grid: (B*H, ceil(N / 64), ceil(kD / (kWG * kCols))); kWG warpgroups,
// each owning kCols output columns (the last group of a ragged width
// fewer, in a block of its own). The first column of this warpgroup:
template <int kWG>
__device__ __forceinline__ int first_col() {
  return (blockIdx.z * kWG + threadIdx.x / 128) * kCols;
}

}  // namespace flash_tiles
