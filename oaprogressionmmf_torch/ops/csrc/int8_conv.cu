// int8 implicit-GEMM convolution with its int8 epilogue, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes (ops/_build.py,
// ops/int8_conv.py).
//
// Replaces the TPU kernel
//   scripts/exp_pallas_conv.py::make_conv.<locals>.kernel
//   (pallas_call at :47): s8 x s8 -> s32 3x3/s1 SAME convolution, nine
//   per-tap (M, C) @ (C, Cout) products accumulated in int32,
// together with what XLA fused behind the TPU's convolutions of the
// quantized FEs (oaprogressionmmf_tpu/ops/quant.py:13-17, 96-112):
// dequantize, BatchNorm, the residual add, ReLU and the requantize to the
// next activation site. It computes every conv of the quantized ResNet and
// ResNeXt feature extractors (models/resnet.py): the 7x7/s2 stem, the 3x3s
// at stride 1 and 2, grouped or not (ResNeXt's 32 groups), and the 1x1s
// (conv1, conv3, downsample) at stride 1 and 2.
//
//   acc[m, co] = sum_{r, s, ci} x[n, oh*stride - pad + r,
//                                 ow*stride - pad + s, ci] * w[co, r, s, ci]
// (ci over the group of co; x zero outside the map), then per output
// channel, each step one IEEE float32 operation rounded once, in the order
// of the plain version (ops/int8_conv.py::int8_conv2d_fused_plain), which
// is the eager chain the FEs ran before:
//   t = float(acc) * sc[co]
//   t = (t - mean[co]) * mul[co] + bias[co]        (BatchNorm, optional)
//   t = t + res  or  t + float(res8) * s_res       (residual, optional)
//   t = max(t, 0)                                  (ReLU, optional)
//   float32 t, or int8 clamp(rint(t / s_out), -127, 127)
// __fmul_rn/__fadd_rn/__fsub_rn keep nvcc from contracting a*b+c into an
// FMA, __fdiv_rn is the correctly rounded division (PyTorch's CUDA division
// by a 0-d tensor on the card is one too; only a CPU scalar divisor becomes
// a reciprocal multiply there, and the scales here are device tensors), and
// rintf rounds half to even as torch.round does. Integer sums are exact, so
// the output equals the plain version's bit for bit.
//
// What bounds it on an H100. A batch-4 flagship request's 159 convs move
// int8 maps in and out, float32 ones after the stem and where a
// downsample feeds a residual: 7.3 GB (a strided 1x1 reads a quarter of
// its map), 2.19 ms at 3.35 TB/s, against 2*M*N*K = 1.5 T operations,
// 0.78 ms at the 1979 TOP/s int8 peak (chip_smoke.py's
// int8_conv_bound_ms). So the bytes bound the stems and
// the 1x1s; the deep 3x3s (K up to 4608) are bound by operations.
//
// Design (right and simple first). An implicit GEMM on the tensor cores:
// M = N*Ho*Wo output pixels, N = output channels, K = (tap, input channel).
// A block of two warpgroups owns 128 pixels (64 a warpgroup, wgmma's M) x
// BN output channels (64 or 128) and walks K in stages of 128 bytes
// through a three-stage ring of cp.async copies: the next stage's copies
// are issued right after this stage's four wgmma m64nBNk32 s8 products
// (hopper.cuh), and fly while they run. A (pixels) is gathered from the
// NHWC map into hopper.cuh's 128-byte swizzled K-major tile, one 16-byte
// run of channels per pixel and tap where the channels allow (8 or 4 bytes
// for ResNeXt's groups of 8 and 4 and for the stem's 4 padded channels),
// zero-filled outside the map and past K; B (weights) comes K-major from
// the packed (Cout, Kp) rows (ops/int8_conv.py::pack_int8_conv_weight, Kp a
// multiple of 32, zeros past K). The epilogue scales the int32
// accumulators and applies the BatchNorm in registers, with the per-channel
// vectors read into shared memory before any store; the float32 tile goes
// through shared memory (the ring, free by then), and each thread finishes
// runs of 16 channels of a pixel (residual, ReLU, requantize) with 16-byte
// loads and stores, neighbouring threads on neighbouring runs, every
// residual load of a thread issued before its first store (the compiler
// cannot hoist a load above a store that may alias it). Each output is
// stored once; BatchNorm, the residual, ReLU and the requantize never touch
// device memory in between.
//
// ResNeXt's narrow groups (32 groups of 4, 8, 16 and 32 channels): no
// tensor-core tile is 4 wide, so groups share a tile of 64 output channels
// whose reduction runs over the input channels of all its groups, with the
// weights block-diagonal (zero across groups): 16, 8, 4 and 2 times the
// products a group needs, on the X-ray branch only (4 images a request),
// where the tensor cores' rate leaves the convs bound by their bytes all
// the same (PERF.md, section 6, gives the measured cost).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;     // output pixels a block: two warpgroups of 64
constexpr int kBK = 128;     // reduction bytes a stage: one swizzled atom
constexpr int kStages = 3;   // the cp.async ring
constexpr int kThreads = 256;

struct Conv {
  const int8_t* x;   // (n, h, w, c) NHWC
  const int8_t* wp;  // (cout, kp) K-major
  int n, h, w, c, ho, wo, cout;
  int kh, kw, stride, pad;
  int cg, coutg;  // input and output channels of a group
  int span;       // input channels of one output tile's reduction
  int k_true;     // kh * kw * span
  int kp;         // k_true rounded up to 32
};

struct Epilogue {
  const float* sc;    // (cout,): t = float(acc) * sc
  const float* mean;  // (cout,) each, or all null: no BatchNorm
  const float* mul;
  const float* bias;
  const void* res;    // (M, cout) float32 (res_kind 1) or int8 (2), or null
  int res_kind;
  const float* res_scale;  // 0-d: the int8 residual's scale
  int relu;
  const float* out_scale;  // 0-d, or null: float32 output
  void* out;               // (M, cout) int8 or float32
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return (kBM + BN) * kBK;
}

// the ring, then the epilogue's four per-channel vectors, + alignment slack;
// after the main loop the ring holds the epilogue's float32 tile
template <int BN>
constexpr size_t smem_bytes() {
  return size_t(kStages) * stage_bytes<BN>() + 4 * BN * sizeof(float) + 1024;
}

// the epilogue's tile: 128 rows of BN float32 values, rows padded by 8
// floats against bank conflicts
template <int BN>
__host__ __device__ constexpr int tile_ld() {
  return BN + 8;
}
static_assert(kBM * tile_ld<128>() * 4 <= kStages * stage_bytes<128>() &&
                  kBM * tile_ld<64>() * 4 <= kStages * stage_bytes<64>(),
              "the epilogue's tile fits the ring");

// sign-extended byte b (0-3) of a 32-bit word
__device__ __forceinline__ int byte_of(uint32_t w, int b) {
  return int(w << (24 - 8 * b)) >> 24;
}

__device__ __forceinline__ int8_t requantize(float t, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(t, s)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// Grid: one block per (128-pixel tile, BN-channel tile), the channel tiles
// of a pixel tile next to each other so that they share its rows in L2.
// kUnit: the bytes of one gathered channel run (16, or 8 / 4 where the
// channels of a group are fewer).
template <int BN, int kUnit>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_wgmma(Conv p, Epilogue e) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t ring = smem_u32(smem);
  // sc, mean, mul, bias of the tile's channels
  float* vec = reinterpret_cast<float*>(smem + kStages * stage_bytes<BN>());
  const int n_tiles = (p.cout + BN - 1) / BN;
  const int n0 = int(blockIdx.x % n_tiles) * BN;
  const int m0 = int(blockIdx.x / n_tiles) * kBM;
  const int m_total = p.n * p.ho * p.wo;
  const int8_t* xs = p.x + (n0 / p.coutg) * p.cg;  // the tile's channels
  const int tid = threadIdx.x;
  const int chunk = tid % 8;  // 16-byte chunk of a 128-byte row
  const int row0 = tid / 8;   // this thread's rows: row0 + 32 i

  // the pixels of this thread's four A rows: image (-1 past M), top row
  // and left column of the window
  int img[4], top[4], left[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + row0 + 32 * i;
    const int ow = m % p.wo;
    const int t = m / p.wo;
    img[i] = m < m_total ? t / p.ho : -1;
    top[i] = (t % p.ho) * p.stride - p.pad;
    left[i] = ow * p.stride - p.pad;
  }

  auto load_stage = [&](int kt) {
    const uint32_t a_s = ring + (kt % kStages) * stage_bytes<BN>();
    const uint32_t b_s = a_s + kBM * kBK;
    const int kb = kt * kBK + 16 * chunk;
#pragma unroll
    for (int u = 0; u < 16 / kUnit; ++u) {
      const int k = kb + u * kUnit;
      const int tap = k / p.span;
      const int ci = k - tap * p.span;
      const int r = tap / p.kw;
      const int s = tap - r * p.kw;
      const bool k_ok = k < p.k_true;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ih = top[i] + r;
        const int iw = left[i] + s;
        const bool ok = k_ok && img[i] >= 0 && ih >= 0 && ih < p.h &&
                        iw >= 0 && iw < p.w;
        const int8_t* src =
            ok ? xs + ((size_t(img[i]) * p.h + ih) * p.w + iw) * p.c + ci
               : p.x;
        cp_async<kUnit>(a_s + tile_offset(kBM, row0 + 32 * i, chunk) +
                            u * kUnit,
                        src, ok ? kUnit : 0);
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int row = row0 + 32 * j;
      const bool ok = n0 + row < p.cout && kb < p.kp;
      const int8_t* src = ok ? p.wp + size_t(n0 + row) * p.kp + kb : p.wp;
      cp_async<16>(b_s + tile_offset(BN, row, chunk), src, ok ? 16 : 0);
    }
  };

  // read before any store (the main loop's first barrier publishes them)
  for (int c = tid; c < BN; c += kThreads) {
    const int co = min(n0 + c, p.cout - 1);
    vec[c] = e.sc[co];
    if (e.mean) {
      vec[BN + c] = e.mean[co];
      vec[2 * BN + c] = e.mul[co];
      vec[3 * BN + c] = e.bias[co];
    }
  }

  const int wg = tid / 128;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const int k_tiles = (p.kp + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    // stage kt has landed, and both warpgroups are done with stage kt - 1
    cp_async_wait<kStages - 2>();
    fence_async_shared();
    __syncthreads();
    const uint32_t a_s = ring + (kt % kStages) * stage_bytes<BN>();
    const uint32_t b_s = a_s + kBM * kBK;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s)
      mma_s8<BN>(acc, desc_k(a_s, kBM, 64 * wg, s), desc_k(b_s, BN, 0, s),
                 1);
    wgmma_commit();
    // while they run, stage kt + 2 into the slot of stage kt - 1
    if (kt + kStages - 1 < k_tiles) load_stage(kt + kStages - 1);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  // the epilogue. 1: from the accumulators, t = float(acc) * sc and the
  // BatchNorm, into a float32 tile in shared memory (the ring is free once
  // every warpgroup has waited for its products); register i holds row
  // 16 * warp + lane / 4 + 8 * ((i / 2) % 2) of the warpgroup's 64 and
  // column 8 * (i / 4) + 2 * (lane % 4) + i % 2
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int kLd = tile_ld<BN>();
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int row = 64 * wg + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = __fmul_rn(__int2float_rn(acc[i + h]), vec[col + h]);
      if (e.mean)
        t = __fadd_rn(__fmul_rn(__fsub_rn(t, vec[BN + col + h]),
                                vec[2 * BN + col + h]),
                      vec[3 * BN + col + h]);
      v[h] = t;
    }
    *reinterpret_cast<float2*>(tile + row * kLd + col) = make_float2(v[0], v[1]);
  }
  __syncthreads();

  // 2: runs of 16 channels of one pixel, neighbouring threads on
  // neighbouring runs: the residual read (all of a thread's runs before any
  // store), + residual, ReLU, the requantize or float32, one 16-element
  // store (cout is a multiple of 16)
  constexpr int kRuns = BN / 16;                 // runs a row
  constexpr int kPer = kBM * kRuns / kThreads;   // runs a thread
  const float s_out = e.out_scale ? *e.out_scale : 1.f;
  const float s_res = e.res_kind == 2 ? *e.res_scale : 0.f;
  const float* res_f = static_cast<const float*>(e.res);
  const int8_t* res_8 = static_cast<const int8_t*>(e.res);
  size_t off[kPer];
  bool ok[kPer];
  float4 rf[kPer][4];
  uint4 r8[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int q = tid + j * kThreads;
    const int row = m0 + q / kRuns;
    const int col = n0 + 16 * (q % kRuns);
    ok[j] = row < m_total && col < p.cout;
    off[j] = size_t(row) * p.cout + col;
    if (ok[j] && e.res_kind == 1) {
#pragma unroll
      for (int h = 0; h < 4; ++h)
        rf[j][h] = *reinterpret_cast<const float4*>(res_f + off[j] + 4 * h);
    } else if (ok[j] && e.res_kind == 2) {
      r8[j] = *reinterpret_cast<const uint4*>(res_8 + off[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!ok[j]) continue;
    const int q = tid + j * kThreads;
    const float* t = tile + (q / kRuns) * kLd + 16 * (q % kRuns);
    float v[16];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 f = *reinterpret_cast<const float4*>(t + 4 * h);
      v[4 * h] = f.x;
      v[4 * h + 1] = f.y;
      v[4 * h + 2] = f.z;
      v[4 * h + 3] = f.w;
    }
    if (e.res_kind == 1) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        v[4 * h] = __fadd_rn(v[4 * h], rf[j][h].x);
        v[4 * h + 1] = __fadd_rn(v[4 * h + 1], rf[j][h].y);
        v[4 * h + 2] = __fadd_rn(v[4 * h + 2], rf[j][h].z);
        v[4 * h + 3] = __fadd_rn(v[4 * h + 3], rf[j][h].w);
      }
    } else if (e.res_kind == 2) {
      const uint32_t w[4] = {r8[j].x, r8[j].y, r8[j].z, r8[j].w};
#pragma unroll
      for (int h = 0; h < 16; ++h)
        v[h] = __fadd_rn(v[h], __fmul_rn(__int2float_rn(byte_of(w[h / 4],
                                                                h % 4)),
                                         s_res));
    }
    if (e.relu) {
#pragma unroll
      for (int h = 0; h < 16; ++h) v[h] = fmaxf(v[h], 0.f);
    }
    if (e.out_scale) {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int h = 0; h < 16; ++h)
        w[h / 4] |= uint32_t(uint8_t(requantize(v[h], s_out))) << (8 * (h % 4));
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(e.out) + off[j]) =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      float* o = static_cast<float*>(e.out) + off[j];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        *reinterpret_cast<float4*>(o + 4 * h) =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    }
  }
}

template <int BN, int kUnit>
cudaError_t launch(const Conv& p, const Epilogue& e, cudaStream_t stream) {
  const size_t smem = smem_bytes<BN>();
  const cudaError_t err = cudaFuncSetAttribute(
      int8_conv_wgmma<BN, kUnit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const long long m_tiles = ((long long)p.n * p.ho * p.wo + kBM - 1) / kBM;
  const long long blocks = m_tiles * ((p.cout + BN - 1) / BN);
  int8_conv_wgmma<BN, kUnit>
      <<<unsigned(blocks), kThreads, smem, stream>>>(p, e);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_unit(int unit, const Conv& p, const Epilogue& e,
                        cudaStream_t stream) {
  if (unit == 16) return launch<BN, 16>(p, e, stream);
  if (unit == 8) return launch<BN, 8>(p, e, stream);
  return launch<BN, 4>(p, e, stream);
}

bool misaligned(const void* ptr, int bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) != 0;
}

}  // namespace

// x: contiguous int8 (n, h, w, c) NHWC, c / groups a multiple of 4 (the
// wrapper pads the stem's channels); wp: contiguous int8 (cout, kp), kp =
// kh * kw * span rounded up to 32 (ops/int8_conv.py::pack_int8_conv_weight);
// tile (64 or 128) and span: the output tile width and the input channels
// of one tile's reduction (ops/int8_conv.py::_tiling). sc, mean, mul, bias:
// float32 (cout,) (mean, mul and bias all null for no BatchNorm); res:
// (n, ho, wo, cout) float32 (res_kind 1), int8 (res_kind 2, res_scale a
// 0-d float32) or null (0); out_scale: 0-d float32 for int8 output, null
// for float32; out: contiguous (n, ho, wo, cout). cout a multiple of 16;
// out and res 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int int8_conv2d_fused(
    const void* x, const void* wp, void* out, const void* sc,
    const void* mean, const void* mul, const void* bias, const void* res,
    int res_kind, const void* res_scale, int relu, const void* out_scale,
    int n, int h, int w, int c, int ho, int wo, int cout, int kh, int kw,
    int stride, int pad, int groups, int tile, int span, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || ho <= 0 || wo <= 0 ||
      cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || pad < 0 ||
      groups <= 0 || c % groups != 0 || cout % groups != 0 || cout % 16 != 0 ||
      (c / groups) % 4 != 0 || (tile != 64 && tile != 128) || span <= 0 ||
      span % (c / groups) != 0 || span > c || res_kind < 0 || res_kind > 2 ||
      (res_kind != 0) != (res != nullptr) ||
      (res_kind == 2) != (res_scale != nullptr) ||
      (mean == nullptr) != (mul == nullptr) ||
      (mean == nullptr) != (bias == nullptr) ||
      (long long)n * ho * wo >= (1ll << 31) ||
      (long long)n * h * w * c >= (1ll << 40))
    return int(cudaErrorInvalidValue);
  const int cg = c / groups;
  const int coutg = cout / groups;
  // a tile's channels: its own group's (a group of whole tiles), or the
  // groups it packs block-diagonally, or all of them (no groups)
  if (groups > 1 && !(coutg % tile == 0 && span == cg) &&
      !(tile % coutg == 0 && span == (tile / coutg < groups ? tile / coutg
                                                             : groups) * cg))
    return int(cudaErrorInvalidValue);
  if (groups == 1 && span != c) return int(cudaErrorInvalidValue);
  const int unit = (c % 16 == 0 && cg % 16 == 0) ? 16
                   : (c % 8 == 0 && cg % 8 == 0) ? 8 : 4;
  if (misaligned(x, unit) || misaligned(wp, 16) || misaligned(out, 16) ||
      (res != nullptr && misaligned(res, 16)))
    return int(cudaErrorInvalidValue);
  const int k_true = kh * kw * span;
  const Conv p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp),
               n, h, w, c, ho, wo, cout, kh, kw, stride, pad, cg, coutg, span,
               k_true, (k_true + 31) / 32 * 32};
  const Epilogue e{static_cast<const float*>(sc),
                   static_cast<const float*>(mean),
                   static_cast<const float*>(mul),
                   static_cast<const float*>(bias),
                   res,
                   res_kind,
                   static_cast<const float*>(res_scale),
                   relu,
                   static_cast<const float*>(out_scale),
                   out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tile == 128 ? launch_unit<128>(unit, p, e, st)
                                      : launch_unit<64>(unit, p, e, st);
  return int(err);
}
