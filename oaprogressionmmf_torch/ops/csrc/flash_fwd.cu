// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ops/_build.py, ops/flash_attention.py).
//
// Replaces the TPU kernel
//   oaprogressionmmf_tpu/ops/flash_attention.py::_flash_fwd_kernel
//   (launched by _flash_fwd, pallas_call at :127).
// For every (batch*head) and query row it computes
//   O   = softmax(q.k^T * scale) . v      over the keys < N
//   lse = m + log(l)                      (running max m, running sum l)
// with an online softmax: the scores live in registers and shared memory
// only, never in device memory. O is written in the input type, lse as a
// (B*H, N) float32 array (the TPU kernel broadcast it over 128 lanes). P
// is rounded to the input type before the P.V product, as the TPU kernel
// does (p.astype(v.dtype)); l sums the unrounded P.
//
// Any head width d up to 288 runs (the TPU kernel pads D to 128 lanes).
// The widths 32, 64, 128 and 256 have kernels of their own; any other
// runs in the kernel of the next of 32, 64, 128, 256 and 288, whose
// columns at or past d are staged as zeros and never stored, so they add
// exactly zero. DenseNet-161's 2208-wide tokens in 8 heads give d = 276.
//
// The two types take two designs, dispatched by type:
//
// bfloat16 (serving, and the training step under autocast): the tensor
//   cores. What bounds it on an H100: at the with_gap=false length
//   (B*H = 32, N = 2432, D = 256) its two N x N x D products need 1.9e11
//   operations, 0.196 ms at 989 TFLOP/s, against 0.05 ms for its bytes. At
//   the flagship's N (25, 64, 92) a call moves ~6 MB and does ~0.3 GFLOP,
//   a few microseconds of either, and the time goes to each block's load
//   latency on a grid of 32-64 row tiles for 132 SMs.
//   The design. A block owns 64 or 128 query rows (wgmma's M is 64); its
//   Q tile stays in shared memory in bf16 in the 128-byte swizzled layout
//   of hopper.cuh, and K and V stream through in tiles of 64 keys (32 when
//   N <= 32) through two-stage rings of cp.async copies
//   (flash_tiles.cuh), K a tile ahead of V: tile t + 1's V and tile t + 2's
//   K fly while tile t runs. Per tile, with wgmma (bf16 in, float32
//   accumulators): S = Q K^T, both operands K-major in shared memory (tile
//   t + 1's issued right behind tile t's P V, so that the two run back to
//   back on the tensor cores); the online softmax in the accumulator's
//   registers in log2 units (log2(e) folded into the scale, exp2f), keys
//   at or past N masked to -inf, the row max reduced over the 4 lanes that
//   hold a row, the row sum kept per lane and reduced once at the end; P
//   rounded to bf16 is the A operand, from registers, of O += P V, whose B
//   (the V tile) is read MN-major through the descriptor. O is divided by
//   l and rounded to bf16 once, at the store; query rows at or past N are
//   not stored.
//   Layouts. Every block reads all of its head's K and V, so at long N
//   the bytes from L2 (B*H x N / rows-a-block x N x D x 4) outweigh the
//   products: 128 rows a block, two warpgroups of 64 rows and all columns
//   (m64n256k16 at D = 256, 128 accumulator registers), halve them. Where
//   that grid would leave SMs idle (the flagship's short sequences), a
//   block owns 64 rows and its warpgroups split the columns, 128 each, and
//   compute S for themselves (two warpgroups of one block at D = 256; at
//   D = 288 the third group, 32 wide, is a block of its own, grid z).
//   Grid: B*H x row tiles, a head's row tiles consecutive so that the
//   blocks in flight share its K and V in L2.
//   Shared memory at D = 256: the Q tile (32 or 64 KB) and two stages each
//   of K and V (128 KB); at D = 288 five 64-wide column atoms, 40 + 160 KB.
//
// float32: a CUDA-core kernel, full float32 FMAs (no TF32), for the 2e-5
//   parity bar of the tests and the float32 step check, which TF32 tensor
//   cores would not meet. One block per (b*h, 16-row query tile): 64-192
//   blocks for 132 SMs at the flagship's shapes. Keys are visited in
//   32-key tiles by a loop inside the block (the TPU's sequential grid
//   axis); K and V tiles are staged in shared memory as float32. Every FMA
//   reads an operand from shared memory, so shared-memory bandwidth bounds
//   it at long sequences.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- float32

namespace f32 {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  // q tile, K tile (rows padded by one float), V tile, P tile
  return size_t(kBlockQ) * D + size_t(kBlockK) * (D + 1) +
         size_t(kBlockK) * D + size_t(kBlockQ) * kBlockK;
}

// Grid: (B*H, ceil(N / kBlockQ)). Warp w owns query rows
// q0 + w*kRowsPerWarp ... + kRowsPerWarp - 1; lane j scores key k0 + j and
// accumulates output columns j, j + 32, ... D is the kernel's head width;
// with kPad the arrays' own width d is less than D.
template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int n, int d, float scale) {
  static_assert(D % 32 == 0, "head width must be a multiple of 32");
  constexpr int kStrideK = D + 1;  // lane j reads K row j: no bank conflicts
  constexpr int kCols = D / 32;

  extern __shared__ float smem[];
  float* qs = smem;                     // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;         // [kBlockK][D + 1]
  float* vs = ks + kBlockK * kStrideK;  // [kBlockK][D]
  float* ps = vs + kBlockK * D;         // [kBlockQ][kBlockK]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int dd = kPad ? d : D;  // the width of the arrays' rows
  const size_t base = size_t(bh) * n * dd;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const size_t off = kPad ? size_t(r) * d + c : size_t(i);
    qs[i] = (q0 + r < n && (!kPad || c < d))
                ? q[base + size_t(q0) * dd + off] : 0.f;
  }

  float acc[kRowsPerWarp][kCols];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const float* qrow = qs + warp * kRowsPerWarp * D;
  float* prow = ps + warp * kRowsPerWarp * kBlockK;

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // q is staged; the previous K/V tile is consumed
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const bool ok = k0 + r < n && (!kPad || c < d);
      const size_t g = base + size_t(k0) * dd +
                       (kPad ? size_t(r) * d + c : size_t(i));
      ks[r * kStrideK + c] = ok ? k[g] : 0.f;
      vs[i] = ok ? v[g] : 0.f;
    }
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = ks + lane * kStrideK;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(qrow[r * D + d], kd, s[r]);
    }

    // online softmax; a tile always holds key k0 < n, so m stays finite
    const bool valid = k0 + lane < n;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = valid ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float corr = expf(m[r] - m_new);
      const float p = expf(sr - m_new);
      l[r] = corr * l[r] + warp_sum(p);
      m[r] = m_new;
      prow[r * kBlockK + lane] = p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

    // acc += P . V over this tile's keys
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = prow[r * kBlockK + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vj = vs[j * D + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][c] = fmaf(pj[r], vj, acc[r][c]);
      }
    }
    __syncwarp();  // this warp rewrites its P rows on the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= n) continue;  // padded query rows are not stored
    float* orow = o + base + size_t(row) * dd;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (!kPad || lane + 32 * c < d) orow[lane + 32 * c] = acc[r][c] / l[r];
    if (lane == 0) lse[size_t(bh) * n + row] = m[r] + logf(l[r]);
  }
}

}  // namespace f32

// ---------------------------------------------------------------- bfloat16

namespace tc {

using namespace hopper;
using namespace flash_tiles;

constexpr float kLn2 = 0.6931471805599453f;

// The kernel's shared memory: the Q tile of kQRows rows, two stages each
// of a K and a V tile, and slack to align the start to 1024 bytes.
template <int kD, int kTile, int kQRows>
constexpr size_t smem_bytes() {
  return size_t(tile_bytes(kQRows, kD)) + 4 * size_t(tile_bytes(kTile, kD)) +
         1024;
}

// Max and sum over the 4 lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One block's work for this warpgroup: kN output columns from c0 of the
// 64 query rows q0 + r0 .., where the block's Q tile holds the kQRows rows
// from q0.
template <int kD, int kTile, int kWG, int kN, int kQRows>
__device__ __forceinline__ void fwd_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int n, int d, float scale, uint8_t* smem,
    int q0, int r0, int c0) {
  constexpr int kThreads = kWG * 128;
  constexpr int kTileBytes = tile_bytes(kTile, kD);
  const uint32_t qs = smem_u32(smem);
  const uint32_t ks = qs + tile_bytes(kQRows, kD);  // K stages 0, 1
  const uint32_t vs = ks + 2 * kTileBytes;          // V stages 0, 1

  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const bool aligned = aligned16(d, q, k, v, q);
  const int tiles = (n + kTile - 1) / kTile;

  const auto k_tile = [&](int t) { return ks + (t & 1) * kTileBytes; };
  const auto v_tile = [&](int t) { return vs + (t & 1) * kTileBytes; };
  const auto load = [&](uint32_t tile, const bf16* __restrict__ src, int t) {
    load_tile<kTile, kD, kThreads>(tile, src, t * kTile, n, d, aligned);
  };
  // S = Q K^T of tile t: 64 queries x kTile keys, in a commit group of
  // its own (inside another group's conditional it serializes every wgmma)
  const auto s_product = [&](float (&st)[kTile / 2], int t) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kD / 16; ++j)
      mma_ss<kTile>(st, desc_k(qs, kQRows, r0, j),
                    desc_k(k_tile(t), kTile, 0, j), j);
    wgmma_commit();
  };

  load_tile<kQRows, kD, kThreads>(qs, q, q0, n, d, aligned);
  load(k_tile(0), k, 0);
  cp_async_commit();
  load(v_tile(0), v, 0);
  if (tiles > 1) load(k_tile(1), k, 1);
  cp_async_commit();
  cp_async_wait<1>();  // Q and K_0
  fence_async_shared();
  __syncthreads();
  float s_cur[kTile / 2];
  s_product(s_cur, 0);
  wgmma_wait<0>();
  fence_regs(s_cur);

  // rows 16 * warp + lane / 4 + 8 * h of the warpgroup's 64, h = 0, 1: the
  // running max (log2 units) and this lane's part of the running sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o_acc[kN / 2];
  zero(o_acc);
  const float scale_log2 = scale * kLog2e;
  for (int t = 0; t < tiles; ++t) {
    // V_t and K_t+1 have landed, and every warpgroup is done with K_t and
    // V_t-1, whose stages take K_t+2 and V_t+1
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();
    if (t + 2 < tiles) load(k_tile(t + 2), k, t + 2);
    if (t + 1 < tiles) load(v_tile(t + 1), v, t + 1);
    cp_async_commit();

    // the new running max; a tile always holds key k0 < n, so it is finite
    const int k0 = t * kTile;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      s_cur[i] =
          k0 + acc_col(i, lane) < n ? s_cur[i] * scale_log2 : -INFINITY;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s_cur[i]);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }

    // P in bf16, as the A fragments of k-step i / 8
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int i = 0; i < kTile / 2; i += 2) {
      const int h = (i / 2) % 2;
      const float p0 = exp2f(s_cur[i] - m[h]);
      const float p1 = exp2f(s_cur[i + 1] - m[h]);
      l[h] += p0 + p1;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }

    // O = corr O + P V over this tile's keys, and behind it the next tile's
    // S into the registers of this tile's
    fence_regs(o_acc);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) o_acc[i] *= corr[(i / 2) % 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j)
      mma_rs<kN>(o_acc, pa[j], desc_mn(v_tile(t), kTile, c0, j), 1);
    wgmma_commit();
    if (t + 1 < tiles) s_product(s_cur, t + 1);
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(s_cur);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
  const bool pairs = pairs_ok(o, d);
  const int row0 = q0 + r0 + 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < kN / 2; i += 2) {
    const int h = (i / 2) % 2;
    if (row0 + 8 * h >= n) continue;  // padded query rows are not stored
    store_pair(o + size_t(row0 + 8 * h) * d, c0 + acc_col(i, lane), d, pairs,
               o_acc[i] / l[h], o_acc[i + 1] / l[h]);
  }
  if (c0 == 0 && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + 8 * h < n) lse[row0 + 8 * h] = m[h] * kLn2 + logf(l[h]);
  }
}

// The kWG warpgroups of a block split either the rows or the columns.
// kRowSplit: a block owns kWG * 64 query rows, a warpgroup 64 of them and
// all kD (at most 256) output columns. Otherwise: a block owns 64 query
// rows, a warpgroup kCols of its columns (the last group of a ragged
// width fewer, in a block of its own). Grid: (B*H x row tiles, 1, column
// groups), a head's row tiles consecutive so that the blocks in flight
// share its K and V in L2.
template <int kD, int kTile, int kWG, bool kRowSplit>
__global__ void __launch_bounds__(kWG * 128, 1)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int n, int d, float scale) {
  constexpr int kQRows = kRowSplit ? kWG * kRows : kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int row_tiles = (n + kQRows - 1) / kQRows;
  const int bh = blockIdx.x / row_tiles;
  const int q0 = (blockIdx.x - bh * row_tiles) * kQRows;
  const size_t head = size_t(bh) * n * d;
  q += head;
  k += head;
  v += head;
  o += head;
  lse += size_t(bh) * n;
  if constexpr (kRowSplit) {
    static_assert(kD <= 256, "a warpgroup holds at most 256 columns");
    const int r0 = (threadIdx.x / 128) * kRows;  // this warpgroup's rows
    fwd_block<kD, kTile, kWG, kD, kQRows>(q, k, v, o, lse, n, d, scale, smem,
                                          q0, r0, 0);
  } else if constexpr (kD <= kCols || kD % kCols == 0) {
    fwd_block<kD, kTile, kWG, (kD < kCols ? kD : kCols), kRows>(
        q, k, v, o, lse, n, d, scale, smem, q0, 0, first_col<kWG>());
  } else {
    static_assert(kWG == 1, "a ragged last column group is a block's own");
    const int c0 = first_col<kWG>();
    if (c0 + kCols <= kD)
      fwd_block<kD, kTile, kWG, kCols, kRows>(
          q, k, v, o, lse, n, d, scale, smem, q0, 0, c0);
    else
      fwd_block<kD, kTile, kWG, kD % kCols, kRows>(
          q, k, v, o, lse, n, d, scale, smem, q0, 0, c0);
  }
}

}  // namespace tc

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* lse;
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
cudaError_t launch_f32(const Args& a) {
  using namespace f32;
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_fwd_kernel<D, kPad>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.n + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D, kPad><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.n, a.d, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Args& a) {
  switch (a.d) {
    case 32: return launch_f32<32, false>(a);
    case 64: return launch_f32<64, false>(a);
    case 128: return launch_f32<128, false>(a);
    case 256: return launch_f32<256, false>(a);
    default: break;
  }
  // any other width: the next kernel width, its columns past d padded
  if (a.d < 32) return launch_f32<32, true>(a);
  if (a.d < 64) return launch_f32<64, true>(a);
  if (a.d < 128) return launch_f32<128, true>(a);
  if (a.d < 256) return launch_f32<256, true>(a);
  return launch_f32<288, true>(a);
}

template <int kD, int kTile, int kWG, bool kRowSplit>
cudaError_t launch_bf16(const Args& a) {
  using tc::bf16;
  constexpr int kQRows = kRowSplit ? kWG * tc::kRows : tc::kRows;
  const auto kernel = tc::flash_fwd_wgmma<kD, kTile, kWG, kRowSplit>;
  const size_t smem = tc::smem_bytes<kD, kTile, kQRows>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = int64_t(a.bh) * ((a.n + kQRows - 1) / kQRows);
  if (blocks > int64_t(0x7fffffff)) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(blocks), 1,
                  kRowSplit ? 1 : (kD + kWG * tc::kCols - 1) /
                                      (kWG * tc::kCols));
  kernel<<<grid, kWG * 128, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o),
      static_cast<float*>(a.lse), a.n, a.d, a.scale);
  return cudaGetLastError();
}

// At width kD, 128 rows a block (two warpgroups of 64) if `rows`, which
// 64-key tiles and widths up to 256 take; else 64 rows, kWG warpgroups.
template <int kD, int kTile, int kWG>
cudaError_t launch_layout(const Args& a, bool rows) {
  if constexpr (kTile == 64 && kD <= 256)
    if (rows) return launch_bf16<kD, kTile, 2, true>(a);
  return launch_bf16<kD, kTile, kWG, false>(a);
}

// bf16: the kernel of the next width of 32, 64, 128, 256 and 288, with
// 32-key tiles when N <= 32 (the flagship's 25-token FeaT), which halve
// the empty keys of its one tile. With 64 rows a block, two warpgroups of
// 128 columns at D = 256, three blocks at D = 288.
template <int kTile>
cudaError_t dispatch_bf16_width(const Args& a, bool rows) {
  if (a.d <= 32) return launch_layout<32, kTile, 1>(a, rows);
  if (a.d <= 64) return launch_layout<64, kTile, 1>(a, rows);
  if (a.d <= 128) return launch_layout<128, kTile, 1>(a, rows);
  if (a.d <= 256) return launch_layout<256, kTile, 2>(a, rows);
  return launch_layout<288, kTile, 1>(a, rows);
}

// `layout` 1: 64 query rows a block; 2: 128 (widths up to 256, N > 64);
// 0: 128 where that grid, B*H x ceil(N / 128), has a block for every SM,
// which halves the K and V each query row reads from L2 at long N, else
// 64, whose grid is twice as large.
cudaError_t dispatch_bf16(const Args& a, int layout) {
  bool rows = layout == 2;
  if (layout == 0 && a.d <= 256 && a.n > 64) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    rows = int64_t(a.bh) * ((a.n + 127) / 128) >= sms;
  }
  if (rows && (a.d > 256 || a.n <= 64)) return cudaErrorInvalidValue;
  return a.n <= 32 ? dispatch_bf16_width<32>(a, rows)
                   : dispatch_bf16_width<64>(a, rows);
}

}  // namespace

// q, k, v, o: contiguous (B*H, N, d) arrays, 0 < d <= 288, of float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); lse: contiguous (B*H, N)
// float32. `layout` (bf16 only): the query rows a block owns, 0 to choose
// (dispatch_bf16). Launches on `stream` and returns cudaGetLastError() of
// the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int n, int d,
                         int is_bf16, int layout, float scale,
                         void* stream) {
  if (bh <= 0 || n <= 0 || d <= 0 || d > 288 || layout < 0 || layout > 2)
    return int(cudaErrorInvalidValue);
  const Args a{q, k, v, o, lse, bh, n, d, scale,
               static_cast<cudaStream_t>(stream)};
  return int(is_bf16 ? dispatch_bf16(a, layout) : dispatch_f32(a));
}
