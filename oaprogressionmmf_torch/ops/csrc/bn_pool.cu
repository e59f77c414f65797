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
// over the conv-size tensor about five times. So the design reads y once
// from device memory and writes only the pooled map, in one launch:
//   * one block per output row (n, i), its threads over the row's
//     Wo x C outputs with c fastest, so that neighbouring threads read and
//     write neighbouring channels (coalesced on NHWC);
//   * each block first folds a and b for every channel into shared memory
//     (the wrapper launches no folding kernels of its own);
//   * each thread reads its 3x3 window; the rows and columns two windows
//     share (the window's stride is 2) come from L1/L2, not device memory;
//   * offsets are 64-bit: 4096 slices x 80 x 80 x 96 channels pass 2^31
//     elements.
//
// Numerics. Every operation is rounded on its own (__fdiv_rn, __fsqrt_rn,
// __fmul_rn, __fadd_rn, __fsub_rn; nothing is contracted into an FMA), as
// the plain version's PyTorch ops round them, so the kernel and the plain
// version agree bit for bit. The maximum starts at 0, which is exact
// because every value is >= 0 after the ReLU (the TPU kernel pads with 0
// for the same reason). A NaN anywhere in the window gives NaN, as
// torch.relu and F.max_pool2d propagate it (fmaxf would drop it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// the folded affine of the (C,) arrays is kept in shared memory
constexpr int kMaxChannels = 6144;  // 2 x 6144 floats = 48 KB

// Grid: one block per output row r = n * ho + i (a grid-stride loop covers
// more rows than blocks). Dynamic shared memory: 2 * c floats.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
bn_relu_pool_kernel(const T* __restrict__ y, const P* __restrict__ weight,
                    const P* __restrict__ bias, const P* __restrict__ mean,
                    const P* __restrict__ var, float eps,
                    T* __restrict__ out, int64_t rows, int h, int w, int c,
                    int ho, int wo) {
  extern __shared__ float ab[];
  float* as = ab;      // a[c] = weight / sqrt(var + eps)
  float* bs = ab + c;  // b[c] = bias - mean * a
  for (int k = threadIdx.x; k < c; k += kThreads) {
    const float a = __fdiv_rn(to_f32(weight[k]),
                              __fsqrt_rn(__fadd_rn(to_f32(var[k]), eps)));
    as[k] = a;
    bs[k] = __fsub_rn(to_f32(bias[k]), __fmul_rn(to_f32(mean[k]), a));
  }
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
        for (int ww = w0; ww <= w1; ++ww, px += c) {
          float v = __fadd_rn(__fmul_rn(to_f32(*px), ac), bc);
          v = v < 0.f ? 0.f : v;         // ReLU; NaN stays NaN
          if (v > m || isnan(v)) m = v;  // once m is NaN, it stays NaN
        }
      }
      orow[e] = from_f32<T>(m);
    }
  }
}

template <typename T, typename P>
cudaError_t launch(const void* y, const void* const* bn, float eps,
                   void* out, int64_t n, int h, int w, int c,
                   cudaStream_t stream) {
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const int64_t rows = n * ho;
  // a block per row up to the grid's limit; the loop takes the rest
  const unsigned int grid =
      unsigned(rows < int64_t(0x7fffffff) ? rows : int64_t(0x7fffffff));
  const size_t smem = 2 * size_t(c) * sizeof(float);
  bn_relu_pool_kernel<T, P><<<grid, kThreads, smem, stream>>>(
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
