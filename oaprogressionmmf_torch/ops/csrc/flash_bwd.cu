// Flash-attention backward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ops/_build.py, ops/flash_attention.py).
//
// Two kernels, launched in this order on one stream:
//   K2 flash_bwd_dq_kernel  replaces
//      oaprogressionmmf_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel
//      (pallas_call at :255). For each query row i it computes
//        delta_i = sum_d dO_i,d O_i,d                (once per row)
//        P_ij    = exp(q_i.k_j * scale - lse_i)      (recomputed)
//        dS_ij   = P_ij (dO_i.v_j - delta_i)
//        dQ_i    = scale * sum_j dS_ij k_j
//      and writes dQ in the input type and delta as (B*H, N) float32.
//   K3 flash_bwd_dkv_kernel replaces
//      oaprogressionmmf_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
//      (pallas_call at :270). For each key j it computes
//        dV_j = sum_i P_ij dO_i,   dK_j = scale * sum_i dS_ij q_i
//      recomputing P from lse and reading K2's delta.
// Each output row is owned by one block and written once, so the grads are
// deterministic and no atomics are needed. lse is the forward's (B*H, N)
// float32 array (flash_fwd.cu), not the TPU's 128-lane broadcast.
//
// Any head width d up to 288 runs, as in the forward kernel (the TPU
// backward, _flash_bwd, pads D to 128 lanes). The widths 32, 64, 128 and
// 256 have kernels of their own; any other runs in the kernel of the next
// width of 32, 64, 128, 256 and 288 (kPad), whose columns at or past d are
// staged as zeros and never stored, so they add exactly zero.
// DenseNet-161's 2208-wide tokens in 8 heads give d = 276.
//
// What bounds it on an H100. At the flagship's training shapes (B*H = 64,
// D = 256, N in {25, 64, 92}) one backward moves ~4-24 MB and does at most
// ~1.4 GFLOP, so the bound from the card's memory rate is a few
// microseconds and what matters is getting enough blocks in flight: 16
// rows per block (query rows in K2, keys in K3) gives 128-384 blocks for
// 132 SMs where the TPU's 128-row blocks would give 64. The other side is
// visited in 32-row tiles by a loop inside the block (the TPU's sequential
// grid axis), staged in shared memory as float32 with rows padded by one
// float so that lane j reads its own row without bank conflicts.
//
// This first version multiplies on the CUDA cores with float32 FMAs: the
// float32 path stays full float32 (no TF32) for the 5e-4 gradient bar, and
// bf16 operands are widened to float32. As in the TPU kernels, P, dP and dS
// stay float32 (no rounding to bf16) and only the grads are rounded to the
// input type. Every FMA reads an operand from shared memory, so
// shared-memory bandwidth, not the tensor cores, bounds it at long
// sequences; wgmma and TMA are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kTile = 32;                          // other side: one per lane
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows r0 .. r0 + rows - 1 of a (n, dd) array as D float32 columns
// with row stride `stride`; rows at or past n are zero, and with kPad the
// columns at or past the arrays' own width d (dd = d) too.
template <typename T, int D, bool kPad>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int rows, int n, int stride,
                                      int d) {
  const int dd = kPad ? d : D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * stride + c] = (r0 + r < n && (!kPad || c < d))
                              ? to_f32(src[size_t(r0 + r) * dd + c]) : 0.f;
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
template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta, int n,
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

  stage<T, D, kPad>(qs, q + base, q0, kBlockRows, n, D, d);
  stage<T, D, kPad>(gs, g + base, q0, kBlockRows, n, D, d);
  __syncthreads();

  const int row0 = warp * kRowsPerWarp;  // first row of this warp in the tile
  float lse_r[kRowsPerWarp];
  float delta_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + row0 + r;
    float part = 0.f;
    if (row < n) {
      const T* orow = o + base + size_t(row) * dd;
      for (int c = lane; c < dd; c += 32)
        part = fmaf(gs[(row0 + r) * D + c], to_f32(orow[c]), part);
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
    stage<T, D, kPad>(ks, k + base, k0, kTile, n, kStride, d);
    stage<T, D, kPad>(vs, v + base, k0, kTile, n, kStride, d);
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
    T* dqrow = dq + base + size_t(row) * dd;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (!kPad || lane + 32 * c < d)
        dqrow[lane + 32 * c] = from_f32<T>(acc[r][c] * scale);
  }
}

// K3. Grid: (B*H, ceil(N / kBlockRows)). Warp w owns keys
// k0 + w*kRowsPerWarp ... + kRowsPerWarp - 1; lane i scores query q0 + i
// and accumulates dK and dV columns i, i + 32, ... As K2 for D and kPad.
template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int n, int d, float scale) {
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

  stage<T, D, kPad>(ks, k + base, k0, kBlockRows, n, D, d);
  stage<T, D, kPad>(vs, v + base, k0, kBlockRows, n, D, d);

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
    stage<T, D, kPad>(qs, q + base, q0, kTile, n, kStride, d);
    stage<T, D, kPad>(gs, g + base, q0, kTile, n, kStride, d);
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
    T* dkrow = dk + base + size_t(row) * dd;
    T* dvrow = dv + base + size_t(row) * dd;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (kPad && lane + 32 * c >= d) continue;
      dkrow[lane + 32 * c] = from_f32<T>(dk_acc[r][c] * scale);
      dvrow[lane + 32 * c] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

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

template <typename T, int D, bool kPad>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, D, kPad>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.n + kBlockRows - 1) / kBlockRows);
  flash_bwd_dq_kernel<T, D, kPad><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.g), static_cast<const float*>(a.lse),
      static_cast<T*>(a.out0), static_cast<float*>(a.out1), a.n, a.d,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D, bool kPad>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, D, kPad>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.n + kBlockRows - 1) / kBlockRows);
  flash_bwd_dkv_kernel<T, D, kPad><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g),
      static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta_in), static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.n, a.d, a.scale);
  return cudaGetLastError();
}

template <bool kDq, typename T, int D, bool kPad>
cudaError_t launch_one(const Args& a) {
  return kDq ? launch_dq<T, D, kPad>(a) : launch_dkv<T, D, kPad>(a);
}

template <bool kDq, typename T>
cudaError_t dispatch_d(const Args& a) {
  switch (a.d) {
    case 32: return launch_one<kDq, T, 32, false>(a);
    case 64: return launch_one<kDq, T, 64, false>(a);
    case 128: return launch_one<kDq, T, 128, false>(a);
    case 256: return launch_one<kDq, T, 256, false>(a);
    default: break;
  }
  // any other width: the next kernel width, its columns past d padded
  if (a.d <= 0 || a.d > 288) return cudaErrorInvalidValue;
  if (a.d < 32) return launch_one<kDq, T, 32, true>(a);
  if (a.d < 64) return launch_one<kDq, T, 64, true>(a);
  if (a.d < 128) return launch_one<kDq, T, 128, true>(a);
  if (a.d < 256) return launch_one<kDq, T, 256, true>(a);
  return launch_one<kDq, T, 288, true>(a);
}

template <bool kDq>
int dispatch(const Args& a, int is_bf16) {
  if (a.bh <= 0 || a.n <= 0) return int(cudaErrorInvalidValue);
  return int(is_bf16 ? dispatch_d<kDq, __nv_bfloat16>(a)
                     : dispatch_d<kDq, float>(a));
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
