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
// (B*H, N) float32 array (the TPU kernel broadcast it over 128 lanes).
//
// What bounds it on an H100. At the flagship's shapes (B*H = 32, D = 256,
// N in {25, 64, 92}) one call moves at most ~6 MB and does at most ~0.3
// GFLOP, so the bound from the card's memory rate and tensor-core rate is
// one or two microseconds and what matters is getting enough blocks in
// flight: one block per (b*h, 16-row query tile) gives 64-192 blocks for
// 132 SMs, where the TPU's 128-512-row blocks would give 32. Keys are
// visited in 32-key tiles by a loop inside the block (the TPU's sequential
// grid axis); K and V tiles are staged in shared memory as float32.
//
// Any head width d up to 288 runs (the TPU kernel pads D to 128 lanes).
// The widths 32, 64, 128 and 256 have kernels of their own; any other
// runs in the kernel of the next width of 32, 64, 128, 256 and 288
// (kPad), whose columns at or past d are staged as zeros and never stored,
// so they add exactly zero. DenseNet-161's 2208-wide tokens in 8 heads give
// d = 276.
//
// This first version multiplies on the CUDA cores with float32 FMAs: the
// float32 path must stay full float32 (no TF32) to meet the 2e-5 parity
// bar, and bf16 operands are widened to float32 with P rounded to bf16
// before the P.V product, as the TPU kernel does (p.astype(v.dtype)).
// Every FMA reads an operand from shared memory, so shared-memory
// bandwidth, not the tensor cores, bounds it at long sequences; wgmma and
// TMA are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
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
template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
                ? to_f32(q[base + size_t(q0) * dd + off]) : 0.f;
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
      ks[r * kStrideK + c] = ok ? to_f32(k[g]) : 0.f;
      vs[i] = ok ? to_f32(v[g]) : 0.f;
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
      prow[r * kBlockK + lane] = to_f32(from_f32<T>(p));
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
    T* orow = o + base + size_t(row) * dd;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (!kPad || lane + 32 * c < d)
        orow[lane + 32 * c] = from_f32<T>(acc[r][c] / l[r]);
    if (lane == 0) lse[size_t(bh) * n + row] = m[r] + logf(l[r]);
  }
}

template <typename T, int D, bool kPad>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int n, int d, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (n + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, D, kPad><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), n, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int bh, int n, int d, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32, false>(q, k, v, o, lse, bh, n, d, scale,
                                         stream);
    case 64: return launch<T, 64, false>(q, k, v, o, lse, bh, n, d, scale,
                                         stream);
    case 128: return launch<T, 128, false>(q, k, v, o, lse, bh, n, d, scale,
                                           stream);
    case 256: return launch<T, 256, false>(q, k, v, o, lse, bh, n, d, scale,
                                           stream);
    default: break;
  }
  // any other width: the next kernel width, its columns past d padded
  if (d <= 0 || d > 288) return cudaErrorInvalidValue;
  if (d < 32) return launch<T, 32, true>(q, k, v, o, lse, bh, n, d, scale,
                                         stream);
  if (d < 64) return launch<T, 64, true>(q, k, v, o, lse, bh, n, d, scale,
                                         stream);
  if (d < 128) return launch<T, 128, true>(q, k, v, o, lse, bh, n, d, scale,
                                           stream);
  if (d < 256) return launch<T, 256, true>(q, k, v, o, lse, bh, n, d, scale,
                                           stream);
  return launch<T, 288, true>(q, k, v, o, lse, bh, n, d, scale, stream);
}

}  // namespace

// q, k, v, o: contiguous (B*H, N, d) arrays, 0 < d <= 288, of float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); lse: contiguous (B*H, N)
// float32. Launches on `stream` and returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int n, int d,
                         int is_bf16, float scale, void* stream) {
  if (bh <= 0 || n <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, n, d, scale, s)
              : dispatch<float>(q, k, v, o, lse, bh, n, d, scale, s);
  return int(err);
}
