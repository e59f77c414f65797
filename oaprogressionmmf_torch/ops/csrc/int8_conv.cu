// int8 implicit-GEMM convolution for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (ops/_build.py, ops/int8_conv.py).
//
// Replaces the TPU kernel
//   scripts/exp_pallas_conv.py::make_conv.<locals>.kernel
//   (pallas_call at :47): s8 x s8 -> s32 3x3/s1 SAME convolution, nine
//   per-tap (M, C) @ (C, Cout) products accumulated in int32.
// The same template computes every int8 convolution of the quantized ResNet
// and ResNeXt feature extractors (models/resnet.py): 3x3 at stride 1 and 2
// with padding 1, the 7x7/s2 stem with padding 3, and grouped 3x3s
// (ResNeXt's 32 groups), which the JAX package runs as a block-diagonal
// dense convolution; PyTorch has no int8 convolution on CUDA.
//
//   y[n, oh, ow, g*coutg + co] =
//     sum_{r, s, ci} x[n, oh*stride - pad + r, ow*stride - pad + s, g*cg + ci]
//                    * w[g, r, s, ci, co]
// with x int8 NHWC (zero outside the map), w int8, y int32 NHWC. Integer
// sums have no rounding, so the result equals the plain version
// (ops/int8_conv.py::int8_conv2d_plain) bit for bit.
//
// Design (a simple one; mma.sync s8, wgmma and TMA are the next step). An
// implicit GEMM: M = N*Ho*Wo output pixels, N = coutg output channels of a
// group, K = kh*kw*cg/4 channel quads. One block owns a tile of BP pixels x
// BC channels of one group and walks K in steps of kKQ quads: the input
// patch (kKQ quads of each of its BP pixels, gathered from the NHWC map, zero
// where the window leaves it) and the weight tile (kKQ quads of BC channels)
// are staged in shared memory as 32-bit words, and each thread multiplies
// its TP x TC outputs with __dp4a, four int8 products a word, into int32
// registers. The reduction runs over (tap, quad) pairs flattened into one
// index, so a group of 4 channels (ResNeXt's first stage, the stem padded
// to 4 channels) wastes no part of a step. Channels per group must be a
// multiple of 4; the wrapper pads the stem's 1 or 3 input channels with
// zeros, which is exact.
//
// What bounds it on an H100. The flagship's convolutions do 2*M*N*K*4 =
// 0.1-50 G int8 operations a call on 0.1-100 MB, so the tensor cores'
// 1979 TOP/s would bound them; this version runs on the CUDA cores (dp4a,
// ~64 per SM and clock), so it is bound by the rate of dp4a and by the
// shared-memory loads that feed it, far above the tensor-core bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKQ = 16;  // channel quads of the reduction per step

struct ConvShape {
  int n, h, w, c;           // input (N, H, W, C), C a multiple of 4
  int ho, wo, cout;         // output (N, Ho, Wo, Cout)
  int kh, kw, stride, pad;  // square stride and padding
  int groups;               // cg = c / groups, coutg = cout / groups
};

// Grid: (ceil(M / BP), ceil(coutg / BC), groups). Thread (ty, tx) owns
// pixels ty*TP .. ty*TP + TP - 1 and channels tx*TC .. tx*TC + TC - 1 of
// the block's tile.
template <int BP, int BC, int TP, int TC>
__global__ void __launch_bounds__((BP / TP) * (BC / TC))
int8_conv_kernel(const int8_t* __restrict__ x, const int* __restrict__ wq,
                 int* __restrict__ y, ConvShape s) {
  static_assert(TP % 4 == 0 && TC % 4 == 0, "tiles are read as int4");
  constexpr int kThreadsC = BC / TC;
  constexpr int kThreads = (BP / TP) * kThreadsC;
  constexpr int kStrideA = BP + 4;  // rows 16-byte aligned, banks staggered

  __shared__ __align__(16) int a_s[kKQ][kStrideA];  // [quad][pixel]
  __shared__ __align__(16) int b_s[kKQ][BC];        // [quad][channel]
  __shared__ int pix_n[BP];  // image of each pixel, -1 past the last one
  __shared__ int pix_h[BP];  // top row of its window (may be negative)
  __shared__ int pix_w[BP];  // left column of its window

  const int g = blockIdx.z;
  const int cg = s.c / s.groups;
  const int qg = cg / 4;  // quads per group
  const int coutg = s.cout / s.groups;
  const int k_total = s.kh * s.kw * qg;
  const long long m_total = (long long)s.n * s.ho * s.wo;
  const long long m0 = (long long)blockIdx.x * BP;
  const int c0 = blockIdx.y * BC;

  for (int p = threadIdx.x; p < BP; p += kThreads) {
    const long long m = m0 + p;
    if (m < m_total) {
      const int ow = int(m % s.wo);
      const long long t = m / s.wo;
      const int oh = int(t % s.ho);
      pix_n[p] = int(t / s.ho);
      pix_h[p] = oh * s.stride - s.pad;
      pix_w[p] = ow * s.stride - s.pad;
    } else {
      pix_n[p] = -1;
      pix_h[p] = 0;
      pix_w[p] = 0;
    }
  }

  const int tx = threadIdx.x % kThreadsC;
  const int ty = threadIdx.x / kThreadsC;
  int acc[TP][TC];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0;

  const int8_t* xg = x + size_t(g) * cg;  // this group's first channel
  const int* wg = wq + size_t(g) * k_total * coutg;

  for (int k0 = 0; k0 < k_total; k0 += kKQ) {
    __syncthreads();  // the pixel table is written; the last tiles are used
    // input patch: 16 neighbouring threads read the 16 quads of one pixel
    for (int i = threadIdx.x; i < kKQ * BP; i += kThreads) {
      const int kq = i % kKQ;
      const int p = i / kKQ;
      const int k = k0 + kq;
      const int img = pix_n[p];
      int v = 0;
      if (k < k_total && img >= 0) {
        const int tap = k / qg;
        const int q = k - tap * qg;
        const int r = tap / s.kw;
        const int ih = pix_h[p] + r;
        const int iw = pix_w[p] + (tap - r * s.kw);
        if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w)
          v = *reinterpret_cast<const int*>(
              xg + ((size_t(img) * s.h + ih) * s.w + iw) * s.c + q * 4);
      }
      a_s[kq][p] = v;
    }
    // weight tile: rows of the packed (k, coutg) words
    for (int i = threadIdx.x; i < kKQ * BC; i += kThreads) {
      const int kq = i / BC;
      const int cc = i - kq * BC;
      const int k = k0 + kq;
      const int co = c0 + cc;
      b_s[kq][cc] = (k < k_total && co < coutg) ? wg[size_t(k) * coutg + co]
                                                : 0;
    }
    __syncthreads();

#pragma unroll 4
    for (int kq = 0; kq < kKQ; ++kq) {
      int a[TP];
      int b[TC];
#pragma unroll
      for (int i = 0; i < TP; i += 4) {
        const int4 v = *reinterpret_cast<const int4*>(&a_s[kq][ty * TP + i]);
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TC; j += 4) {
        const int4 v = *reinterpret_cast<const int4*>(&b_s[kq][tx * TC + j]);
        b[j] = v.x;
        b[j + 1] = v.y;
        b[j + 2] = v.z;
        b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const long long m = m0 + ty * TP + i;
    if (m >= m_total) continue;
    int* yrow = y + size_t(m) * s.cout + size_t(g) * coutg;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int co = c0 + tx * TC + j;
      if (co < coutg) yrow[co] = acc[i][j];
    }
  }
}

template <int BP, int BC, int TP, int TC>
cudaError_t launch(const void* x, const void* wq, void* y, const ConvShape& s,
                   cudaStream_t stream) {
  const long long m = (long long)s.n * s.ho * s.wo;
  const int coutg = s.cout / s.groups;
  const dim3 grid(unsigned((m + BP - 1) / BP), unsigned((coutg + BC - 1) / BC),
                  unsigned(s.groups));
  int8_conv_kernel<BP, BC, TP, TC><<<grid, (BP / TP) * (BC / TC), 0,
                                     stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int*>(wq),
      static_cast<int*>(y), s);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous int8 (n, h, w, c) NHWC, 4-byte aligned; wq: contiguous
// int32 (groups, kh, kw, cg / 4, cout / groups), each word the int8 weights
// of 4 consecutive input channels of one output channel, lowest channel in
// the lowest byte (ops/int8_conv.py::pack_int8_conv_weight); y: contiguous
// int32 (n, ho, wo, cout). c and c / groups must be multiples of 4. Launches
// on `stream` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int int8_conv2d(const void* x, const void* wq, void* y, int n,
                           int h, int w, int c, int ho, int wo, int cout,
                           int kh, int kw, int stride, int pad, int groups,
                           void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || ho <= 0 || wo <= 0 ||
      cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || pad < 0 ||
      groups <= 0 || c % groups != 0 || cout % groups != 0 ||
      (c / groups) % 4 != 0 || groups > 65535)
    return int(cudaErrorInvalidValue);
  const ConvShape s{n, h, w, c, ho, wo, cout, kh, kw, stride, pad, groups};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // narrow output groups (ResNeXt's 4-32 channels) take a tile of 16
  // channels and 256 pixels; the others 64 channels and 128 pixels
  const cudaError_t err =
      (cout / groups <= 16) ? launch<256, 16, 4, 4>(x, wq, y, s, st)
                            : launch<128, 64, 8, 4>(x, wq, y, s, st);
  return int(err);
}
