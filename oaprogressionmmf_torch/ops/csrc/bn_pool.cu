// Fused BatchNorm(eval) + ReLU + 3x3/2 max pool (padding 1) for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (ops/_build.py, ops/fused_stem.py).
//
// Replaces the TPU kernel
//   oaprogressionmmf_tpu/ops/fused_stem.py::_bn_pool_kernel
//   (wrapper fused_bn_relu_pool, pallas_call at :92).
// For every image n, output row i, output column j and channel c:
//   out[n, i, j, c] = max over h in {2i-1, 2i, 2i+1} ∩ [0, H),
//                              w in {2j-1, 2j, 2j+1} ∩ [0, W)
//                     of relu(y[n, h, w, c] * a[c] + b[c])
// with a = gamma / sqrt(var + eps) and b = beta - mean * a in float32.
// y and out are NHWC (PyTorch's channels_last), float32 or bfloat16; the
// BatchNorm's four (C,) arrays float32 or bfloat16 (a bf16 model holds
// them in bf16) and are upcast. The arithmetic is float32 and the result
// is rounded once to the output type.
//
// What bounds it on an H100: bytes. Per input element it does a multiply,
// an add and a ReLU; per output 8 more maxima: ~5 float32 operations per
// element read against 2 or 4 bytes, far below the ~20 operations per byte
// where the CUDA cores would become the limit. The flagship's stems read
// 210 MB (DESS), 82 MB (T2) and 16 MB (XR) of bf16 conv output and write a
// quarter of that; the unfused stem (batch norm, ReLU, max pool) passes
// over the conv-size tensor about five times. So y is read once from
// device memory and only the pooled map is written, in one launch, and the
// design aims at the memory rate.
//
// The vector path (C a multiple of 8, at most 1024, y and out 16-byte
// aligned): a thread owns 8 consecutive channels of one output column j,
// loads them with one 16-byte load in bf16 (two in float32) and keeps
// their 8 folded (a, b) pairs in registers. A block covers a band of
// output rows of one image and a strip of its output columns, the threads
// over (column, channel group) with channels fastest, so a warp's loads
// and stores are contiguous. It walks down the band two input rows at a
// time, the next pair's loads in flight while this pair's arithmetic
// runs: each thread reads columns 2j and 2j + 1 of rows 2i and 2i + 1
// once, applies the affine once per element, and takes the max of its two
// columns; column 2j - 1 is its left neighbour's 2j + 1, handed over
// through shared memory (a double buffer, one barrier per output row; a
// halo thread group per strip reads the column left of the strip and
// stores nothing); the max over the three rows keeps row 2i + 1's in
// registers for output row i + 1. A band after the first reads its halo
// row 2i0 - 1, which the band before it reads too. Bands are 8 output
// rows, or fewer while the grid has fewer than 4 blocks per SM (the
// X-ray's 4 images). Offsets are 64-bit: 4096 slices x 80 x 80 x 96
// channels pass 2^31 elements.
//
// The scalar path (any other C or alignment; every shape the wrapper
// takes): one block per output row, a thread per (column, channel) output
// reading its 3x3 window, the folded affine in shared memory.
//
// Numerics. Every operation is rounded on its own (__fdiv_rn, __fsqrt_rn,
// __fmul_rn, __fadd_rn, __fsub_rn; nothing is contracted into an FMA), as
// the plain version's PyTorch ops round them, so the kernel and the plain
// version agree bit for bit. The affine is applied per element before any
// max (gamma may be negative). The maximum starts at 0, which is exact
// because every value is >= 0 after the ReLU (the TPU kernel pads with 0
// for the same reason), and a position outside the map contributes that
// 0. A NaN anywhere in the window gives NaN, as torch.relu and
// F.max_pool2d propagate it (fmaxf would drop it); the maximum of a set
// that may hold NaN does not depend on the order it is taken in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// the larger of m and v; a NaN in either gives NaN
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// a and b of channel k, folded as the plain version folds them
template <typename P>
__device__ __forceinline__ void fold(const P* __restrict__ weight,
                                     const P* __restrict__ bias,
                                     const P* __restrict__ mean,
                                     const P* __restrict__ var, float eps,
                                     int k, float& a, float& b) {
  a = __fdiv_rn(to_f32(weight[k]), __fsqrt_rn(__fadd_rn(to_f32(var[k]), eps)));
  b = __fsub_rn(to_f32(bias[k]), __fmul_rn(to_f32(mean[k]), a));
}

// ----------------------------------------------------------------- vector

constexpr int kVec = 8;             // channels a thread owns
constexpr int kVecThreads = 256;    // threads of a block, at most
constexpr int kMaxVecChannels = kVec * kVecThreads / 2;  // 2 columns
constexpr int kBandRows = 8;        // output rows of a band, at most
constexpr int kBlocksPerSm = 4;     // fewer: bands are halved, down to 2

// 8 consecutive values of T as loaded: one 16-byte vector in bf16, two in
// float32
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Raw<float> {
  float4 u, v;
};

// from a 16-byte aligned address
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p,
                                         Raw<__nv_bfloat16>& r) {
  r.u = __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void load_raw(const float* p, Raw<float>& r) {
  r.u = __ldg(reinterpret_cast<const float4*>(p));
  r.v = __ldg(reinterpret_cast<const float4*>(p) + 1);
}

// in float32 (exact)
__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r,
                                      float (&x)[kVec]) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void widen(const Raw<float>& r, float (&x)[kVec]) {
  x[0] = r.u.x; x[1] = r.u.y; x[2] = r.u.z; x[3] = r.u.w;
  x[4] = r.v.x; x[5] = r.v.y; x[6] = r.v.z; x[7] = r.v.w;
}

// 8 values rounded to the output type, to a 16-byte aligned address
__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  uint4 u;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e)  // round to nearest even, as torch's cast
    h[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Grid: (N * bands, column strips); block: (cols + 1) * groups threads,
// thread (jl, g) = (threadIdx.x / groups, threadIdx.x % groups) owning
// channels 8g .. 8g + 7 of column j = strip * cols + jl - 1. Thread jl = 0
// is the strip's halo: it reads only column 2j + 1, its right neighbour's
// 2j' - 1, and stores nothing. Dynamic shared memory: 2 buffers x 2 rows x
// 2 x blockDim float4.
template <typename T, typename P>
__global__ void __launch_bounds__(kVecThreads)
bn_relu_pool_vec(const T* __restrict__ y, const P* __restrict__ weight,
                 const P* __restrict__ bias, const P* __restrict__ mean,
                 const P* __restrict__ var, float eps, T* __restrict__ out,
                 int h, int w, int c, int ho, int wo, int bands,
                 int band_rows, int cols) {
  extern __shared__ float4 xs[];
  const int groups = c / kVec;
  const int g = threadIdx.x % groups;
  const int jl = threadIdx.x / groups;
  const int j = blockIdx.y * cols + jl - 1;
  // which of this thread's two columns are read, and whether it stores
  const bool own = jl > 0 && j < wo;
  const bool right = j >= 0 && j < wo && 2 * j + 1 < w;
  const int64_t image = blockIdx.x / bands;
  const int band = int(blockIdx.x - image * bands);
  const T* src = y + image * h * int64_t(w) * c + (2 * int64_t(j)) * c +
                 kVec * g;
  T* dst = out + (image * ho * int64_t(wo) + j) * c + kVec * g;
  float a[kVec], b[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    fold(weight, bias, mean, var, eps, kVec * g + e, a[e], b[e]);

  // Output rows i0 .. i1 - 1, from input row pairs (2i, 2i + 1); a band
  // after the first starts one pair early for its halo row 2i0 - 1 (row
  // 2i0 - 2 is not read). Rows outside [lo, h) and columns outside the map
  // give 0.
  const int i0 = band * band_rows;
  const int i1 = min(i0 + band_rows, ho);
  const int lo = max(2 * i0 - 1, 0);
  const int first = i0 > 0 ? i0 - 1 : i0;
  const auto row_ok = [&](int row) { return row >= lo && row < h; };
  Raw<T> cur[2][2], next[2][2];  // [row of the pair][column 2j, 2j + 1]
  const auto issue = [&](int i, Raw<T> (&r)[2][2]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = 2 * i + k;
      const T* p = src + int64_t(row) * w * c;
      if (own && row_ok(row)) load_raw(p, r[k][0]);
      if (right && row_ok(row)) load_raw(p + c, r[k][1]);
    }
  };
  issue(first, cur);
  float prev[kVec];  // the max over input row 2i - 1's window columns
#pragma unroll
  for (int e = 0; e < kVec; ++e) prev[e] = 0.f;
  for (int i = first; i < i1; ++i) {
    if (i + 1 < i1) issue(i + 1, next);  // in flight while this pair runs
    float4* buf = xs + (i & 1) * 4 * blockDim.x;
    float hm[2][kVec];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool ok = row_ok(2 * i + k);
      float x0[kVec], x1[kVec];
      widen(cur[k][0], x0);
      widen(cur[k][1], x1);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        x0[e] = ok && own ? __fadd_rn(__fmul_rn(x0[e], a[e]), b[e]) : 0.f;
        x1[e] = ok && right ? __fadd_rn(__fmul_rn(x1[e], a[e]), b[e]) : 0.f;
        hm[k][e] = nan_max(x0[e], x1[e]);
      }
      // column 2j + 1 for the thread of column j + 1
      buf[(2 * k) * blockDim.x + threadIdx.x] =
          make_float4(x1[0], x1[1], x1[2], x1[3]);
      buf[(2 * k + 1) * blockDim.x + threadIdx.x] =
          make_float4(x1[4], x1[5], x1[6], x1[7]);
    }
    __syncthreads();
    if (jl > 0) {  // column 2j - 1 from the thread of column j - 1
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4 u = buf[(2 * k) * blockDim.x + threadIdx.x - groups];
        const float4 v = buf[(2 * k + 1) * blockDim.x + threadIdx.x - groups];
        const float xl[kVec] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < kVec; ++e) hm[k][e] = nan_max(hm[k][e], xl[e]);
      }
    }
    if (i >= i0) {
      float m[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        m[e] = nan_max(nan_max(nan_max(0.f, prev[e]), hm[0][e]), hm[1][e]);
      if (own) store8(dst + int64_t(i) * wo * c, m);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) prev[e] = hm[1][e];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      cur[k][0] = next[k][0];
      cur[k][1] = next[k][1];
    }
  }
}

// ----------------------------------------------------------------- scalar

constexpr int kThreads = 256;
// the folded affine of the (C,) arrays is kept in shared memory
constexpr int kMaxChannels = 6144;  // 2 x 6144 floats = 48 KB

// Grid: one block per output row r = n * ho + i (a grid-stride loop covers
// more rows than blocks). Dynamic shared memory: 2 * c floats.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
bn_relu_pool_scalar(const T* __restrict__ y, const P* __restrict__ weight,
                    const P* __restrict__ bias, const P* __restrict__ mean,
                    const P* __restrict__ var, float eps,
                    T* __restrict__ out, int64_t rows, int h, int w, int c,
                    int ho, int wo) {
  extern __shared__ float ab[];
  float* as = ab;      // a[c] = weight / sqrt(var + eps)
  float* bs = ab + c;  // b[c] = bias - mean * a
  for (int k = threadIdx.x; k < c; k += kThreads)
    fold(weight, bias, mean, var, eps, k, as[k], bs[k]);
  __syncthreads();

  const int row_elems = wo * c;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int64_t n = r / ho;
    const int i = int(r - n * ho);
    const T* img = y + n * int64_t(h) * w * c;
    T* orow = out + r * int64_t(row_elems);
    const int h0 = max(2 * i - 1, 0), h1 = min(2 * i + 1, h - 1);
    for (int e = threadIdx.x; e < row_elems; e += kThreads) {
      const int j = e / c;
      const int ch = e - j * c;
      const int w0 = max(2 * j - 1, 0), w1 = min(2 * j + 1, w - 1);
      const float ac = as[ch], bc = bs[ch];
      float m = 0.f;
      for (int hh = h0; hh <= h1; ++hh) {
        const T* px = img + (int64_t(hh) * w + w0) * c + ch;
        for (int ww = w0; ww <= w1; ++ww, px += c)
          m = nan_max(m, __fadd_rn(__fmul_rn(to_f32(*px), ac), bc));
      }
      orow[e] = from_f32<T>(m);
    }
  }
}

// ----------------------------------------------------------------- launch

bool vector_path(const void* y, const void* out, int c) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(y) |
                      reinterpret_cast<uintptr_t>(out);
  return c % kVec == 0 && c <= kMaxVecChannels && (a & 15) == 0;
}

template <typename T, typename P>
cudaError_t launch_vec(const void* y, const void* const* bn, float eps,
                       void* out, int64_t n, int h, int w, int c, int ho,
                       int wo, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // strips of at most 256 threads (a halo column and `cols` columns),
  // their columns balanced
  const int groups = c / kVec;
  const int per_block = kVecThreads / groups - 1;
  const int strips = (wo + per_block - 1) / per_block;
  const int cols = (wo + strips - 1) / strips;
  const int threads = (cols + 1) * groups;
  int band_rows = kBandRows;
  while (band_rows > 2 &&
         n * ((ho + band_rows - 1) / band_rows) * strips <
             int64_t(kBlocksPerSm) * sms)
    band_rows /= 2;
  const int bands = (ho + band_rows - 1) / band_rows;
  const dim3 grid(unsigned(n * bands), unsigned(strips));
  const size_t smem = 2 * 4 * size_t(threads) * sizeof(float4);
  bn_relu_pool_vec<T, P><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const P*>(bn[0]),
      static_cast<const P*>(bn[1]), static_cast<const P*>(bn[2]),
      static_cast<const P*>(bn[3]), eps, static_cast<T*>(out), h, w, c, ho,
      wo, bands, band_rows, cols);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch(const void* y, const void* const* bn, float eps,
                   void* out, int64_t n, int h, int w, int c,
                   cudaStream_t stream) {
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  // the vector grid's x is n * bands, at most n * ceil(ho / 2)
  if (vector_path(y, out, c) && n * ((ho + 1) / 2) <= int64_t(0x7fffffff) &&
      wo <= 65535 * (kVecThreads / (c / kVec) - 1))
    return launch_vec<T, P>(y, bn, eps, out, n, h, w, c, ho, wo, stream);
  const int64_t rows = n * ho;
  // a block per row up to the grid's limit; the loop takes the rest
  const unsigned int grid =
      unsigned(rows < int64_t(0x7fffffff) ? rows : int64_t(0x7fffffff));
  const size_t smem = 2 * size_t(c) * sizeof(float);
  bn_relu_pool_scalar<T, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const P*>(bn[0]),
      static_cast<const P*>(bn[1]), static_cast<const P*>(bn[2]),
      static_cast<const P*>(bn[3]), eps, static_cast<T*>(out), rows, h, w,
      c, ho, wo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* y, const void* const* bn, float eps,
                     void* out, int64_t n, int h, int w, int c,
                     int params_bf16, cudaStream_t stream) {
  return params_bf16
             ? launch<T, __nv_bfloat16>(y, bn, eps, out, n, h, w, c, stream)
             : launch<T, float>(y, bn, eps, out, n, h, w, c, stream);
}

}  // namespace

// y: (N, H, W, C) NHWC array of float32 (y_bf16 = 0) or bfloat16
// (y_bf16 = 1); weight, bias, mean, var: the BatchNorm's (C,) arrays, all
// float32 (params_bf16 = 0) or all bfloat16 (params_bf16 = 1); out:
// (N, (H-1)/2+1, (W-1)/2+1, C) in y's type. Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int bn_relu_pool(const void* y, const void* weight,
                            const void* bias, const void* mean,
                            const void* var, float eps, void* out,
                            long long n, int h, int w, int c, int y_bf16,
                            int params_bf16, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > kMaxChannels)
    return int(cudaErrorInvalidValue);
  // a row of the output is indexed in 32 bits
  if (int64_t((w - 1) / 2 + 1) * c > int64_t(0x7fffffff))
    return int(cudaErrorInvalidValue);
  const void* bn[4] = {weight, bias, mean, var};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      y_bf16 ? dispatch<__nv_bfloat16>(y, bn, eps, out, n, h, w, c,
                                       params_bf16, s)
             : dispatch<float>(y, bn, eps, out, n, h, w, c, params_bf16, s);
  return int(err);
}
