// Flash-attention backward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ops/_build.py, ops/flash_attention.py).
//
// Two kernels, launched in this order on one stream:
//   K2 (dq)  replaces
//      oaprogressionmmf_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel
//      (pallas_call at :255). For each query row i it computes
//        delta_i = sum_d dO_i,d O_i,d                (once per row)
//        P_ij    = exp(q_i.k_j * scale - lse_i)      (recomputed)
//        dS_ij   = P_ij (dO_i.v_j - delta_i)
//        dQ_i    = scale * sum_j dS_ij k_j
//      and writes dQ in the input type and delta as (B*H, N) float32.
//   K3 (dkv) replaces
//      oaprogressionmmf_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
//      (pallas_call at :270). For each key j it computes
//        dV_j = sum_i P_ij dO_i,   dK_j = scale * sum_i dS_ij q_i
//      recomputing P from lse and reading K2's delta.
// Each output row is owned by one block and written once, so the grads are
// deterministic and no atomics are needed. lse is the forward's (B*H, N)
// float32 array (flash_fwd.cu), not the TPU's 128-lane broadcast. Any head
// width d up to 288 runs (the TPU backward pads D to 128 lanes); columns at
// or past d are staged as zeros and never stored, so they add exactly zero.
// DenseNet-161's 2208-wide tokens in 8 heads give d = 276.
//
// The two types take two designs, dispatched by type:
//
// bfloat16 (the training step, under autocast): the tensor cores.
//   What bounds it on an H100: K2 does 3 and K3 4 products of N x N x D, so
//   at the with_gap=false length (B*H = 64, N = 2432, D = 256) they need
//   5.8e11 and 7.8e11 operations, 0.59 and 0.78 ms at 989 TFLOP/s, against
//   ~0.5 ms for their bytes: the operations bound them. At the flagship's
//   N (25, 64, 92) the work is a few microseconds of either, and the time
//   goes to each block's load latency: the grid is 64-128 blocks.
//   The design. A block owns 64 rows (wgmma's M: query rows in K2, keys in
//   K3), grid (B*H, ceil(N / 64), column groups). Its own rows (Q and dO in
//   K2, K and V in K3) stay in shared memory in bf16 in the 128-byte
//   swizzled layout of hopper.cuh; the other side streams through in tiles
//   of 64 rows (32 at D = 288, and at D = 256 when N <= 32) through a
//   two-stage ring of 16-byte cp.async copies: the next tile's copies are
//   issued right after this tile's first products, and fly while they
//   run. Per tile, with wgmma (bf16 in, float32 accumulators):
//     K3: S^T = K Q^T and dP^T = V dO^T (both operands K-major in shared
//         memory); in registers P^T = exp(scale S^T - lse), zero at query
//         rows >= N, and dS^T = P^T (dP^T - delta); both rounded to bf16
//         become the A operand, from registers, of dV += P^T dO and
//         dK += dS^T Q, whose B (the dO and Q tiles) is read transposed
//         (MN-major) through the descriptor.
//     K2: S = Q K^T and dP = dO V^T; P = exp(scale S - lse), zero at keys
//         >= N; dS = P (dP - delta) rounded to bf16 is the A operand of
//         dQ += dS K.
//   dQ, dK and dV are scaled and rounded to bf16 once, at the store. The
//   plain versions (ops/flash_attention.py) round P and dS to the input
//   type at the same places.
//   Registers: a warpgroup owns at most 128 output columns, so at D = 256 a
//   block runs two consumer warpgroups, each holding 64 x 128 float32 of
//   dK and dV (128 registers a thread) and recomputing S^T and dP^T (64
//   more) for itself: 1.5x K3's products (1.67x K2's) and no exchange
//   through shared memory. At D = 288 the third group of columns (32 wide)
//   goes to a third block (grid z), each of one warpgroup. ptxas (CUDA
//   12.9, -O3) at D = 256: 240 registers a thread in K3 and 182 in K2 (206
//   and 156 with 32-row tiles); no spills at any width. A warpgroup waits
//   for each tile's dV/dK (dQ) products before the next tile: carrying them
//   over the next tile's S and dP made ptxas serialize every wgmma.
//   Shared memory at D = 256: K3 holds K and V (64 KB) and two stages of Q
//   and dO (128 KB), 193 KB with lse and delta; K2 the same sizes. At
//   D = 288 the five 64-wide column atoms take 80 KB for the block's rows
//   and 80 KB for two stages of 32-row tiles.
//   Copies: flash_tiles.cuh (16-, 8-byte or element copies by alignment).
//
// float32: CUDA-core kernels, full float32 FMAs (no TF32). They
//   exist for the 5e-4 gradient bar of the tests and of the float32 step
//   check, which TF32 tensor cores would not meet. 16 rows per block
//   (query rows in K2, keys in K3); the other side in 32-row tiles staged
//   as float32 in shared memory, rows padded by one float against bank
//   conflicts. The widths 32, 64, 128 and 256 have kernels of their own;
//   any other runs in the kernel of the next of 32, 64, 128, 256 and 288.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- float32

namespace f32 {

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kTile = 32;                          // other side: one per lane
constexpr int kThreads = kWarps * 32;

// Stage rows r0 .. r0 + rows - 1 of a (n, dd) array as D float32 columns
// with row stride `stride`; rows at or past n are zero, and with kPad the
// columns at or past the arrays' own width d (dd = d) too.
template <int D, bool kPad>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int r0, int rows, int n, int stride,
                                      int d) {
  const int dd = kPad ? d : D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * stride + c] = (r0 + r < n && (!kPad || c < d))
                              ? src[size_t(r0 + r) * dd + c] : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_floats() {
  // Q and dO rows of the block, K and V tiles (rows padded), dS tile
  return 2 * size_t(kBlockRows) * D + 2 * size_t(kTile) * (D + 1) +
         size_t(kBlockRows) * kTile;
}

template <int D>
constexpr size_t dkv_smem_floats() {
  // K and V rows of the block, Q and dO tiles (rows padded), P and dS
  // tiles, lse and delta of the query tile
  return 2 * size_t(kBlockRows) * D + 2 * size_t(kTile) * (D + 1) +
         2 * size_t(kBlockRows) * kTile + 2 * size_t(kTile);
}

// K2. Grid: (B*H, ceil(N / kBlockRows)). Warp w owns query rows
// q0 + w*kRowsPerWarp ... + kRowsPerWarp - 1; lane j scores key k0 + j and
// accumulates dQ columns j, j + 32, ... D is the kernel's head width; with
// kPad the arrays' own width d is less than D.
template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ g, const float* __restrict__ lse,
                    float* __restrict__ dq, float* __restrict__ delta, int n,
                    int d, float scale) {
  static_assert(D % 32 == 0, "head width must be a multiple of 32");
  constexpr int kStride = D + 1;
  constexpr int kCols = D / 32;

  extern __shared__ float smem[];
  float* qs = smem;                     // [kBlockRows][D]
  float* gs = qs + kBlockRows * D;      // [kBlockRows][D]
  float* ks = gs + kBlockRows * D;      // [kTile][D + 1]
  float* vs = ks + kTile * kStride;     // [kTile][D + 1]
  float* dss = vs + kTile * kStride;    // [kBlockRows][kTile]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int dd = kPad ? d : D;  // the width of the arrays' rows
  const size_t base = size_t(bh) * n * dd;

  stage<D, kPad>(qs, q + base, q0, kBlockRows, n, D, d);
  stage<D, kPad>(gs, g + base, q0, kBlockRows, n, D, d);
  __syncthreads();

  const int row0 = warp * kRowsPerWarp;  // first row of this warp in the tile
  float lse_r[kRowsPerWarp];
  float delta_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + row0 + r;
    float part = 0.f;
    if (row < n) {
      const float* orow = o + base + size_t(row) * dd;
      for (int c = lane; c < dd; c += 32)
        part = fmaf(gs[(row0 + r) * D + c], orow[c], part);
    }
    delta_r[r] = warp_sum(part);
    // padded rows: lse 0 and delta 0 keep them finite; they are not stored
    lse_r[r] = (row < n) ? lse[size_t(bh) * n + row] : 0.f;
    if (lane == 0 && row < n) delta[size_t(bh) * n + row] = delta_r[r];
  }

  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  const float* qrow = qs + row0 * D;
  const float* grow = gs + row0 * D;
  float* dsrow = dss + row0 * kTile;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous K/V tile is consumed
    stage<D, kPad>(ks, k + base, k0, kTile, n, kStride, d);
    stage<D, kPad>(vs, v + base, k0, kTile, n, kStride, d);
    __syncthreads();

    // S and dP of this warp's rows against key k0 + lane
    float s[kRowsPerWarp];
    float dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float* krow = ks + lane * kStride;
    const float* vrow = vs + lane * kStride;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
      const float vd = vrow[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(qrow[r * D + d], kd, s[r]);
        dp[r] = fmaf(grow[r * D + d], vd, dp[r]);
      }
    }

    // keys at or past n contribute exactly zero
    const bool valid = k0 + lane < n;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = valid ? expf(s[r] * scale - lse_r[r]) : 0.f;
      dsrow[r * kTile + lane] = p * (dp[r] - delta_r[r]);
    }
    __syncwarp();

    // acc += dS . K over this tile's keys
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float dsj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) dsj[r] = dsrow[r * kTile + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kj = ks[j * kStride + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][c] = fmaf(dsj[r], kj, acc[r][c]);
      }
    }
    __syncwarp();  // this warp rewrites its dS rows on the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + row0 + r;
    if (row >= n) continue;  // padded query rows are not stored
    float* dqrow = dq + base + size_t(row) * dd;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (!kPad || lane + 32 * c < d) dqrow[lane + 32 * c] = acc[r][c] * scale;
  }
}

// K3. Grid: (B*H, ceil(N / kBlockRows)). Warp w owns keys
// k0 + w*kRowsPerWarp ... + kRowsPerWarp - 1; lane i scores query q0 + i
// and accumulates dK and dV columns i, i + 32, ... As K2 for D and kPad.
template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int n, int d, float scale) {
  static_assert(D % 32 == 0, "head width must be a multiple of 32");
  constexpr int kStride = D + 1;
  constexpr int kCols = D / 32;

  extern __shared__ float smem[];
  float* ks = smem;                        // [kBlockRows][D]
  float* vs = ks + kBlockRows * D;         // [kBlockRows][D]
  float* qs = vs + kBlockRows * D;         // [kTile][D + 1]
  float* gs = qs + kTile * kStride;        // [kTile][D + 1]
  float* ps = gs + kTile * kStride;        // [kBlockRows][kTile]
  float* dss = ps + kBlockRows * kTile;    // [kBlockRows][kTile]
  float* lse_s = dss + kBlockRows * kTile; // [kTile]
  float* delta_s = lse_s + kTile;          // [kTile]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int dd = kPad ? d : D;  // the width of the arrays' rows
  const size_t base = size_t(bh) * n * dd;
  const size_t base_row = size_t(bh) * n;

  stage<D, kPad>(ks, k + base, k0, kBlockRows, n, D, d);
  stage<D, kPad>(vs, v + base, k0, kBlockRows, n, D, d);

  float dk_acc[kRowsPerWarp][kCols];
  float dv_acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  const int row0 = warp * kRowsPerWarp;
  const float* krow = ks + row0 * D;
  const float* vrow = vs + row0 * D;
  float* prow = ps + row0 * kTile;
  float* dsrow = dss + row0 * kTile;

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // K/V are staged; the previous Q/dO tile is consumed
    stage<D, kPad>(qs, q + base, q0, kTile, n, kStride, d);
    stage<D, kPad>(gs, g + base, q0, kTile, n, kStride, d);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = (row < n) ? lse[base_row + row] : 0.f;
      delta_s[threadIdx.x] = (row < n) ? delta[base_row + row] : 0.f;
    }
    __syncthreads();

    // S and dP of this warp's keys against query q0 + lane
    float s[kRowsPerWarp];
    float dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    const float* qcol = qs + lane * kStride;
    const float* gcol = gs + lane * kStride;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qcol[d];
      const float gd = gcol[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(krow[r * D + d], qd, s[r]);
        dp[r] = fmaf(vrow[r * D + d], gd, dp[r]);
      }
    }

    // query rows at or past n contribute exactly zero
    const bool valid = q0 + lane < n;
    const float lse_i = lse_s[lane];
    const float delta_i = delta_s[lane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = valid ? expf(s[r] * scale - lse_i) : 0.f;
      prow[r * kTile + lane] = p;
      dsrow[r * kTile + lane] = p * (dp[r] - delta_i);
    }
    __syncwarp();

    // dV += P^T . dO and dK += dS^T . Q over this tile's queries
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float pi[kRowsPerWarp];
      float dsi[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        pi[r] = prow[r * kTile + i];
        dsi[r] = dsrow[r * kTile + i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float gi = gs[i * kStride + lane + 32 * c];
        const float qi = qs[i * kStride + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          dv_acc[r][c] = fmaf(pi[r], gi, dv_acc[r][c]);
          dk_acc[r][c] = fmaf(dsi[r], qi, dk_acc[r][c]);
        }
      }
    }
    __syncwarp();  // this warp rewrites its P and dS rows on the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = k0 + row0 + r;
    if (row >= n) continue;  // padded keys are not stored
    float* dkrow = dk + base + size_t(row) * dd;
    float* dvrow = dv + base + size_t(row) * dd;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (kPad && lane + 32 * c >= d) continue;
      dkrow[lane + 32 * c] = dk_acc[r][c] * scale;
      dvrow[lane + 32 * c] = dv_acc[r][c];
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------- bfloat16

namespace tc {

using namespace hopper;
using namespace flash_tiles;

// The kernels' shared memory: the block's own rows (two arrays), two
// stages of two arrays of the other side, `floats` float32 values, and
// slack to align the start to 1024 bytes.
template <int kD, int kTile>
constexpr size_t smem_bytes(int floats) {
  return 2 * size_t(tile_bytes(kRows, kD)) + 4 * size_t(tile_bytes(kTile, kD)) +
         4 * size_t(floats) + 1024;
}

// Rows r0 .. r0 + count - 1 of one head's (n,) float32 array; zeros past n.
template <int kThreads>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int n, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) {
    if (r0 + i < n)
      cp_async<4>(smem_u32(dst + i), src + r0 + i, 4);
    else
      dst[i] = 0.f;
  }
}

// The dot product of two bf16 rows of width d (at most kD), split over kT
// neighbouring threads of a warp (sub = 0 .. kT - 1) and summed over them.
// A thread issues eight 16-byte loads of each row before it uses one.
template <int kD, int kT>
__device__ __forceinline__ float row_dot(const bf16* __restrict__ a,
                                         const bf16* __restrict__ b, int d,
                                         int sub) {
  constexpr int kBatch = 8;
  constexpr int kSteps = (kD / 8 + kT - 1) / kT;
  float acc = 0.f;
  const uintptr_t ab = reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b);
  if ((ab & 15) == 0 && d % 8 == 0) {
    for (int j0 = 0; j0 < kSteps; j0 += kBatch) {
      uint4 x[kBatch], y[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int c = 8 * ((j0 + j) * kT + sub);
        x[j] = y[j] = make_uint4(0, 0, 0, 0);
        if (c < d) {
          x[j] = *reinterpret_cast<const uint4*>(a + c);
          y[j] = *reinterpret_cast<const uint4*>(b + c);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const auto* xs = reinterpret_cast<const __nv_bfloat162*>(&x[j]);
        const auto* ys = reinterpret_cast<const __nv_bfloat162*>(&y[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fx = __bfloat1622float2(xs[e]);
          const float2 fy = __bfloat1622float2(ys[e]);
          acc = fmaf(fx.x, fy.x, acc);
          acc = fmaf(fx.y, fy.y, acc);
        }
      }
    }
  } else {
    for (int c = sub; c < d; c += kT)
      acc = fmaf(__bfloat162float(a[c]), __bfloat162float(b[c]), acc);
  }
#pragma unroll
  for (int off = kT / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// K3's work for one block: kN output columns from c0 for this warpgroup.
template <int kD, int kTile, int kWG, int kN>
__device__ __forceinline__ void dkv_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int d, float scale,
    uint8_t* smem, int c0) {
  constexpr int kThreads = kWG * 128;
  constexpr int kTileBytes = tile_bytes(kTile, kD);
  const uint32_t ks = smem_u32(smem);
  const uint32_t vs = ks + tile_bytes(kRows, kD);
  const uint32_t ring = vs + tile_bytes(kRows, kD);  // stage s: Q, dO
  float* rows_f = reinterpret_cast<float*>(smem + 2 * tile_bytes(kRows, kD) +
                                           4 * kTileBytes);  // [2][lse, delta]

  const int k0 = blockIdx.y * kRows;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const bool aligned = aligned16(d, q, k, v, g);

  auto load_stage = [&](int t) {
    const int s = t & 1;
    load_tile<kTile, kD, kThreads>(ring + 2 * s * kTileBytes, q, t * kTile, n,
                                   d, aligned);
    load_tile<kTile, kD, kThreads>(ring + (2 * s + 1) * kTileBytes, g,
                                   t * kTile, n, d, aligned);
    load_rows<kThreads>(rows_f + 2 * s * kTile, lse, t * kTile, n, kTile);
    load_rows<kThreads>(rows_f + (2 * s + 1) * kTile, delta, t * kTile, n,
                        kTile);
  };
  load_tile<kRows, kD, kThreads>(ks, k, k0, n, d, aligned);
  load_tile<kRows, kD, kThreads>(vs, v, k0, n, d, aligned);
  load_stage(0);
  cp_async_commit();

  float dk_acc[kN / 2], dv_acc[kN / 2];
  zero(dk_acc);
  zero(dv_acc);
  const float scale_log2 = scale * kLog2e;
  const int tiles = (n + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    // tile t (and at t = 0 the block's own rows) has landed, and every
    // warpgroup is done with tile t - 1
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();

    const int s = t & 1;
    const int q0 = t * kTile;
    const uint32_t qs = ring + 2 * s * kTileBytes;
    const uint32_t gs = qs + kTileBytes;
    const float* lse_t = rows_f + 2 * s * kTile;
    const float* delta_t = lse_t + kTile;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x kTile queries
    float st[kTile / 2], dpt[kTile / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kD / 16; ++j)
      mma_ss<kTile>(st, desc_k(ks, kRows, 0, j), desc_k(qs, kTile, 0, j), j);
#pragma unroll
    for (int j = 0; j < kD / 16; ++j)
      mma_ss<kTile>(dpt, desc_k(vs, kRows, 0, j), desc_k(gs, kTile, 0, j), j);
    wgmma_commit();
    // while they run, tile t + 1 into the stage of tile t - 1
    if (t + 1 < tiles) {
      load_stage(t + 1);
      cp_async_commit();
    }
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T in bf16, as the A fragments of k-step i / 8
    uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
#pragma unroll
    for (int i = 0; i < kTile / 2; i += 2) {
      const int col = acc_col(i, lane);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + col);
      const float p0 =
          q0 + col < n ? exp2f(st[i] * scale_log2 - l2.x * kLog2e) : 0.f;
      const float p1 =
          q0 + col + 1 < n ? exp2f(st[i + 1] * scale_log2 - l2.y * kLog2e)
                           : 0.f;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
      dsa[i / 8][(i % 8) / 2] =
          pack_bf16(p0 * (dpt[i] - d2.x), p1 * (dpt[i + 1] - d2.y));
    }

    // dV += P^T dO and dK += dS^T Q over this tile's queries
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      mma_rs<kN>(dv_acc, pa[j], desc_mn(gs, kTile, c0, j), 1);
      mma_rs<kN>(dk_acc, dsa[j], desc_mn(qs, kTile, c0, j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }

  const bool pairs_k = pairs_ok(dk, d);
  const bool pairs_v = pairs_ok(dv, d);
#pragma unroll
  for (int i = 0; i < kN / 2; i += 2) {
    const int row = k0 + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    if (row >= n) continue;  // padded keys are not stored
    const int col = c0 + acc_col(i, lane);
    store_pair(dk + size_t(row) * d, col, d, pairs_k, dk_acc[i] * scale,
               dk_acc[i + 1] * scale);
    store_pair(dv + size_t(row) * d, col, d, pairs_v, dv_acc[i],
               dv_acc[i + 1]);
  }
}

// K2's work for one block: kN dQ columns from c0 for this warpgroup.
template <int kD, int kTile, int kWG, int kN>
__device__ __forceinline__ void dq_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ o,
    const bf16* __restrict__ g, const float* __restrict__ lse,
    bf16* __restrict__ dq, float* __restrict__ delta, int n, int d,
    float scale, uint8_t* smem, int c0) {
  constexpr int kThreads = kWG * 128;
  constexpr int kTileBytes = tile_bytes(kTile, kD);
  const uint32_t qs = smem_u32(smem);
  const uint32_t gs = qs + tile_bytes(kRows, kD);
  const uint32_t ring = gs + tile_bytes(kRows, kD);  // stage s: K, V
  float* lse_s = reinterpret_cast<float*>(smem + 2 * tile_bytes(kRows, kD) +
                                          4 * kTileBytes);  // [kRows]
  float* delta_s = lse_s + kRows;                            // [kRows]

  const int q0 = blockIdx.y * kRows;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const bool aligned = aligned16(d, q, k, v, g);

  auto load_stage = [&](int t) {
    const int s = t & 1;
    load_tile<kTile, kD, kThreads>(ring + 2 * s * kTileBytes, k, t * kTile, n,
                                   d, aligned);
    load_tile<kTile, kD, kThreads>(ring + (2 * s + 1) * kTileBytes, v,
                                   t * kTile, n, d, aligned);
  };
  load_tile<kRows, kD, kThreads>(qs, q, q0, n, d, aligned);
  load_tile<kRows, kD, kThreads>(gs, g, q0, n, d, aligned);
  load_stage(0);
  cp_async_commit();

  // delta = rowsum(dO o O) of the block's rows, kThreads / kRows threads a
  // row, while the copies fly; the first group of columns writes it out.
  // Rows past n: lse 0, delta 0.
  {
    constexpr int kT = kThreads / kRows;
    const int r = threadIdx.x / kT;
    const int row = q0 + r;
    const float x = row_dot<kD, kT>(g + size_t(row) * d, o + size_t(row) * d,
                                    row < n ? d : 0, threadIdx.x % kT);
    if (threadIdx.x % kT == 0) {
      delta_s[r] = x;
      lse_s[r] = row < n ? lse[row] * kLog2e : 0.f;
      if (row < n && blockIdx.z == 0) delta[row] = x;
    }
  }
  __syncthreads();
  float lse_r[2], delta_r[2];  // rows 16 * warp + lane / 4 (+ 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = lse_s[16 * warp + lane / 4 + 8 * h];
    delta_r[h] = delta_s[16 * warp + lane / 4 + 8 * h];
  }

  float dq_acc[kN / 2];
  zero(dq_acc);
  const float scale_log2 = scale * kLog2e;
  const int tiles = (n + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    // tile t (and at t = 0 the block's own rows) has landed, and every
    // warpgroup is done with tile t - 1
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();

    const int s = t & 1;
    const int k0 = t * kTile;
    const uint32_t ks = ring + 2 * s * kTileBytes;
    const uint32_t vs = ks + kTileBytes;

    // S = Q K^T and dP = dO V^T: 64 queries x kTile keys
    float st[kTile / 2], dpt[kTile / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kD / 16; ++j)
      mma_ss<kTile>(st, desc_k(qs, kRows, 0, j), desc_k(ks, kTile, 0, j), j);
#pragma unroll
    for (int j = 0; j < kD / 16; ++j)
      mma_ss<kTile>(dpt, desc_k(gs, kRows, 0, j), desc_k(vs, kTile, 0, j), j);
    wgmma_commit();
    // while they run, tile t + 1 into the stage of tile t - 1
    if (t + 1 < tiles) {
      load_stage(t + 1);
      cp_async_commit();
    }
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // dS in bf16, as the A fragments of k-step i / 8
    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int i = 0; i < kTile / 2; i += 2) {
      const int h = (i / 2) % 2;
      const int col = acc_col(i, lane);
      const float p0 =
          k0 + col < n ? exp2f(st[i] * scale_log2 - lse_r[h]) : 0.f;
      const float p1 =
          k0 + col + 1 < n ? exp2f(st[i + 1] * scale_log2 - lse_r[h]) : 0.f;
      dsa[i / 8][(i % 8) / 2] = pack_bf16(p0 * (dpt[i] - delta_r[h]),
                                          p1 * (dpt[i + 1] - delta_r[h]));
    }

    // dQ += dS K over this tile's keys
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j)
      mma_rs<kN>(dq_acc, dsa[j], desc_mn(ks, kTile, c0, j), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
  }

  const bool pairs = pairs_ok(dq, d);
#pragma unroll
  for (int i = 0; i < kN / 2; i += 2) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    if (row >= n) continue;  // padded query rows are not stored
    store_pair(dq + size_t(row) * d, c0 + acc_col(i, lane), d, pairs,
               dq_acc[i] * scale, dq_acc[i + 1] * scale);
  }
}

template <int kD, int kTile, int kWG>
__global__ void __launch_bounds__(kWG * 128, 1)
flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ o,
                   const bf16* __restrict__ g, const float* __restrict__ lse,
                   bf16* __restrict__ dq, float* __restrict__ delta, int n,
                   int d, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const size_t head = size_t(blockIdx.x) * n * d;
  const size_t rows = size_t(blockIdx.x) * n;
  const int c0 = first_col<kWG>();
  if constexpr (kD <= kCols || kD % kCols == 0) {
    dq_block<kD, kTile, kWG, (kD < kCols ? kD : kCols)>(
        q + head, k + head, v + head, o + head, g + head, lse + rows,
        dq + head, delta + rows, n, d, scale, smem, c0);
  } else {
    static_assert(kWG == 1, "a ragged last column group is a block's own");
    if (c0 + kCols <= kD)
      dq_block<kD, kTile, kWG, kCols>(
          q + head, k + head, v + head, o + head, g + head, lse + rows,
          dq + head, delta + rows, n, d, scale, smem, c0);
    else
      dq_block<kD, kTile, kWG, kD % kCols>(
          q + head, k + head, v + head, o + head, g + head, lse + rows,
          dq + head, delta + rows, n, d, scale, smem, c0);
  }
}

template <int kD, int kTile, int kWG>
__global__ void __launch_bounds__(kWG * 128, 1)
flash_bwd_dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int n, int d, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const size_t head = size_t(blockIdx.x) * n * d;
  const size_t rows = size_t(blockIdx.x) * n;
  const int c0 = first_col<kWG>();
  if constexpr (kD <= kCols || kD % kCols == 0) {
    dkv_block<kD, kTile, kWG, (kD < kCols ? kD : kCols)>(
        q + head, k + head, v + head, g + head, lse + rows, delta + rows,
        dk + head, dv + head, n, d, scale, smem, c0);
  } else {
    static_assert(kWG == 1, "a ragged last column group is a block's own");
    if (c0 + kCols <= kD)
      dkv_block<kD, kTile, kWG, kCols>(
          q + head, k + head, v + head, g + head, lse + rows, delta + rows,
          dk + head, dv + head, n, d, scale, smem, c0);
    else
      dkv_block<kD, kTile, kWG, kD % kCols>(
          q + head, k + head, v + head, g + head, lse + rows, delta + rows,
          dk + head, dv + head, n, d, scale, smem, c0);
  }
}

}  // namespace tc

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;
  const void* lse;
  const void* delta_in;
  void* out0;
  void* out1;
  int bh;
  int n;
  int d;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int D, bool kPad>
cudaError_t launch_dq_f32(const Args& a) {
  using namespace f32;
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_bwd_dq_kernel<D, kPad>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.n + kBlockRows - 1) / kBlockRows);
  flash_bwd_dq_kernel<D, kPad><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.g), static_cast<const float*>(a.lse),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.n, a.d,
      a.scale);
  return cudaGetLastError();
}

template <int D, bool kPad>
cudaError_t launch_dkv_f32(const Args& a) {
  using namespace f32;
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D, kPad>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.n + kBlockRows - 1) / kBlockRows);
  flash_bwd_dkv_kernel<D, kPad><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g),
      static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta_in), static_cast<float*>(a.out0),
      static_cast<float*>(a.out1), a.n, a.d, a.scale);
  return cudaGetLastError();
}

template <bool kDq, int D, bool kPad>
cudaError_t launch_f32(const Args& a) {
  return kDq ? launch_dq_f32<D, kPad>(a) : launch_dkv_f32<D, kPad>(a);
}

template <bool kDq>
cudaError_t dispatch_f32(const Args& a) {
  switch (a.d) {
    case 32: return launch_f32<kDq, 32, false>(a);
    case 64: return launch_f32<kDq, 64, false>(a);
    case 128: return launch_f32<kDq, 128, false>(a);
    case 256: return launch_f32<kDq, 256, false>(a);
    default: break;
  }
  // any other width: the next kernel width, its columns past d padded
  if (a.d < 32) return launch_f32<kDq, 32, true>(a);
  if (a.d < 64) return launch_f32<kDq, 64, true>(a);
  if (a.d < 128) return launch_f32<kDq, 128, true>(a);
  if (a.d < 256) return launch_f32<kDq, 256, true>(a);
  return launch_f32<kDq, 288, true>(a);
}

template <bool kDq, int kD, int kTile, int kWG>
cudaError_t launch_bf16(const Args& a) {
  using tc::bf16;
  const dim3 grid(a.bh, (a.n + tc::kRows - 1) / tc::kRows,
                  (kD + kWG * tc::kCols - 1) / (kWG * tc::kCols));
  if constexpr (kDq) {
    const auto kernel = tc::flash_bwd_dq_wgmma<kD, kTile, kWG>;
    const size_t smem = tc::smem_bytes<kD, kTile>(2 * tc::kRows);
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kWG * 128, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
        static_cast<const bf16*>(a.g), static_cast<const float*>(a.lse),
        static_cast<bf16*>(a.out0), static_cast<float*>(a.out1), a.n, a.d,
        a.scale);
  } else {
    const auto kernel = tc::flash_bwd_dkv_wgmma<kD, kTile, kWG>;
    const size_t smem = tc::smem_bytes<kD, kTile>(4 * kTile);
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kWG * 128, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
        static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta_in), static_cast<bf16*>(a.out0),
        static_cast<bf16*>(a.out1), a.n, a.d, a.scale);
  }
  return cudaGetLastError();
}

// bf16: the kernel of the next width of 32, 64, 128, 256 and 288; two
// warpgroups at 256, three one-warpgroup blocks of 32-row tiles at 288. At
// 256 a sequence of at most 32 rows (the flagship's 25-token FeaT) takes
// 32-row tiles, which halve the empty rows of its one tile.
template <bool kDq>
cudaError_t dispatch_bf16(const Args& a) {
  if (a.d <= 32) return launch_bf16<kDq, 32, 64, 1>(a);
  if (a.d <= 64) return launch_bf16<kDq, 64, 64, 1>(a);
  if (a.d <= 128) return launch_bf16<kDq, 128, 64, 1>(a);
  if (a.d <= 256)
    return a.n <= 32 ? launch_bf16<kDq, 256, 32, 2>(a)
                     : launch_bf16<kDq, 256, 64, 2>(a);
  return launch_bf16<kDq, 288, 32, 1>(a);
}

template <bool kDq>
int dispatch(const Args& a, int is_bf16) {
  if (a.bh <= 0 || a.n <= 0 || a.d <= 0 || a.d > 288)
    return int(cudaErrorInvalidValue);
  return int(is_bf16 ? dispatch_bf16<kDq>(a) : dispatch_f32<kDq>(a));
}

}  // namespace

// q, k, v, o, g (dO), dq: contiguous (B*H, N, d) arrays, 0 < d <= 288, of
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); lse and delta:
// contiguous (B*H, N) float32. Writes dq and delta = rowsum(dO * O). Launches on
// `stream` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* g, const void* lse,
                            void* dq, void* delta, int bh, int n, int d,
                            int is_bf16, float scale, void* stream) {
  const Args a{q, k, v, o, g, lse, nullptr, dq, delta, bh, n, d, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, is_bf16);
}

// As flash_bwd_dq, with delta as written by flash_bwd_dq for the same
// inputs; writes dk and dv.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* g, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int n, int d, int is_bf16, float scale,
                             void* stream) {
  const Args a{q, k, v, nullptr, g, lse, delta, dk, dv, bh, n, d, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, is_bf16);
}
