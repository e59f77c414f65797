// Global BatchNorm in training for Hopper (sm_90a): BatchNorm2d whose
// statistics are those of the batch over every rank of a process group,
// as four kernels around the two collectives that
// oaprogressionmmf_torch/parallel/mesh.py::GlobalBatchNorm2d already has,
// with a plain C interface loaded through ctypes (ops/_build.py,
// ops/global_bn.py).
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm under its
// device mesh to XLA, which fuses the statistics, the cross-device sums
// and the normalisation itself. The port's plain version is a chain of
// ~42 small PyTorch launches a layer (mesh.py), and a four-rank training
// step of the flagship, ~159 such layers, spends most of its time with
// the card waiting for the host to launch them. Here a layer is four
// launches and two collectives:
//
//   forward   gbn_bn_fw_stats   x -> this rank's (count, mean, biased
//                               variance) per channel, float32, (3, C)
//             all-gather        -> (world, 3, C)
//             gbn_bn_fw_apply   merges the ranks' rows per channel (Chan),
//                               y = (x - mean) * invstd * w + b; block
//                               (0, 0) also saves mean, invstd and the
//                               count for the backward, updates the
//                               running mean and (unbiased) variance and
//                               adds 1 to num_batches_tracked
//   backward  gbn_bn_bw_reduce  dy, x -> this rank's sum(dy) and
//                               sum(dy * xhat), float32, (2, C), also
//                               written to d_bias and d_weight
//             all-reduce        -> the global sums
//             gbn_bn_bw_dx      dx = w * invstd * (dy - sum(dy) / n
//                                    - xhat * sum(dy * xhat) / n)
//
// x, y, dy and dx are float32 or bfloat16, laid out NHWC (PyTorch's
// channels_last, the port's layout on the card) or contiguous NCHW; the
// BatchNorm's weight, bias and running statistics float32 (training keeps
// float32 parameters under bf16 autocast). All arithmetic is float32;
// values are rounded once to their type.
//
// What bounds it on an H100: bytes. Each kernel does a few float32
// operations per element against 2 or 4 bytes read; a layer reads x
// twice and writes y in the forward, reads dy and x twice and writes dx
// in the backward: 8 passes over the activation (the plain version takes
// ~14). So every kernel streams its tensors once with 16-byte loads and
// aims at the memory rate.
//
// Layout of the work. NHWC: a thread owns V consecutive channels (V = 8
// in bf16, 4 in float32: one 16-byte load; V = 1 where C is not a
// multiple of that or an address is not 16-byte aligned) of a block's
// rows, the threads of a block over (row lane, channel group) with
// channels fastest, so a warp reads contiguous bytes; the grid over (row
// blocks, channel tiles of at most 32 groups, 8 in the reductions, whose
// tiles' partials are merged by one block each). A thread keeps its
// channels' constants in registers and walks its rows four at a time,
// their loads in flight together. NCHW: a block's channel is blockIdx.y;
// its threads take V consecutive values of one (image, channel) plane
// each, the grid's x over the channel's values.
//
// The reductions (statistics, backward sums) are deterministic: each
// thread accumulates its own values in order (Welford for the
// statistics; plain sums for the backward), a block merges its threads in
// a fixed tree through shared memory and writes its partial, and the last
// block of a channel tile to finish (an integer counter per tile, reset
// by that block) merges the partials in a fixed order, kBatch loads in
// flight (a chain of dependent loads costs an L2 round trip each: ~0.1 ms
// a reduction at 264 partials on an H100). No float atomics: two runs on
// the same inputs give the same bits. The merge of moments is
// Chan's: n = na + nb, mean = ma + d * nb / n, M2 = M2a + M2b + d^2 na nb
// / n with d = mb - ma. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 32;    // channel groups of a block (NHWC)
constexpr int kUnroll = 4;        // rows (NHWC) or vectors (NCHW) in flight
constexpr int kBatch = 8;         // partials in flight in a final merge
constexpr int kMaxVec = 8;
constexpr int kMaxTiles = 65535;  // grid.y, and the counters' length

// V consecutive values from p (16-byte aligned when V > 1), in float32
template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
    static_assert(V == 1, "float32 vectors hold 4 values");
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p,
                                     float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
    static_assert(V == 1, "bfloat16 vectors hold 8 values");
    v[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 u;
    auto* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}

// --------------------------------------------------------- accumulators

// count, mean and sum of squared deviations of a set of values
struct Moments {
  float n, mean, m2;
};

// Chan's merge; an empty side leaves the other as it is
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

__device__ __forceinline__ Moments load_cg(const Moments* p) {
  const float* f = reinterpret_cast<const float*>(p);
  return {__ldcg(f), __ldcg(f + 1), __ldcg(f + 2)};
}

// sum(dy) and sum(dy * (x - mean)) of a set of values
struct Sums {
  float dy, dyx;
};

__device__ __forceinline__ Sums merge(Sums a, Sums b) {
  return {a.dy + b.dy, a.dyx + b.dyx};
}

__device__ __forceinline__ Sums load_cg(const Sums* p) {
  const float* f = reinterpret_cast<const float*>(p);
  return {__ldcg(f), __ldcg(f + 1)};
}

// The block's K accumulators per thread merged over its `lanes` lanes, in
// a fixed tree: thread (lane, slots slot0 .. slot0 + K - 1) of `width`
// slots; a thread with lane >= lanes takes part in the barriers only.
// Lane 0's acc holds the block's result after it.
template <class Acc, int K>
__device__ __forceinline__ void block_merge(Acc (&acc)[K], Acc* sh, int lane,
                                            int lanes, int slot0,
                                            int width) {
  if (lane < lanes) {
#pragma unroll
    for (int k = 0; k < K; ++k) sh[lane * width + slot0 + k] = acc[k];
  }
  __syncthreads();
  int half = 1;
  while (half < lanes) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    if (lane < half && lane + half < lanes) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k] = merge(acc[k], sh[(lane + half) * width + slot0 + k]);
        sh[lane * width + slot0 + k] = acc[k];
      }
    }
    __syncthreads();
  }
}

// After every block has written its partials (P, C) of Acc for its
// channels: true in the last block of channel tile blockIdx.y to finish,
// which then resets the tile's counter. Every thread calls it.
__device__ __forceinline__ bool last_block(unsigned int* counters) {
  __shared__ bool last;
  __threadfence();  // this block's partials are seen before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&counters[blockIdx.y], 1u) == gridDim.x - 1;
    if (last) counters[blockIdx.y] = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// In the last block: the partials of `width` channels c0 .. c0 + width - 1
// (those below c) merged in a fixed order, into lane 0's result for
// channel c0 + threadIdx.x (threadIdx.x < width). Lane l of a channel
// takes partials l, l + lanes, ...; the lanes are merged as in
// block_merge.
template <class Acc>
__device__ __forceinline__ Acc final_merge(const Acc* partial, int blocks,
                                           int c, int c0, int width,
                                           Acc* sh) {
  const int lanes = kThreads / width;
  const int slot = threadIdx.x % width, lane = threadIdx.x / width;
  Acc acc[1] = {Acc{}};  // empty: count 0, sums 0
  if (lane < lanes && c0 + slot < c) {
    // kBatch loads in flight, then their merges in order
    for (int p = lane; p < blocks; p += kBatch * lanes) {
      Acc part[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        part[u] = p + u * lanes < blocks
                      ? load_cg(partial + int64_t(p + u * lanes) * c + c0 +
                                slot)
                      : Acc{};
#pragma unroll
      for (int u = 0; u < kBatch; ++u) acc[0] = merge(acc[0], part[u]);
    }
  }
  block_merge<Acc, 1>(acc, sh, lane, lanes, slot, width);
  return acc[0];
}

// ------------------------------------------------------------- the merge

// Channel k's global mean, biased variance and count from the gathered
// rows (world, 3, C) of (count, mean, biased variance): the share-weighted
// form of Chan's merge, in rank order (as the plain version computes it).
__device__ __forceinline__ void merged(const float* __restrict__ gathered,
                                       int world, int c, int k, float& mean,
                                       float& var, float& count) {
  const int64_t row = 3 * int64_t(c);
  count = 0.f;
  for (int r = 0; r < world; ++r) count += gathered[r * row + k];
  mean = 0.f;
  for (int r = 0; r < world; ++r)
    mean += gathered[r * row + k] / count * gathered[r * row + c + k];
  var = 0.f;
  for (int r = 0; r < world; ++r) {
    const float d = gathered[r * row + c + k] - mean;
    var += gathered[r * row + k] / count *
           (gathered[r * row + 2 * c + k] + d * d);
  }
}

// torch.lerp's formula: the weight's small side from the start
__device__ __forceinline__ float lerp_torch(float start, float end, float w) {
  return w < 0.5f ? start + w * (end - start)
                  : end - (end - start) * (1.f - w);
}

// Block (0, 0) of gbn_bn_fw_apply: saves mean, invstd and the count, and
// updates the running statistics and the batch counter, for all channels.
__device__ void finish_forward(const float* __restrict__ gathered, int world,
                               int c, float eps, float momentum,
                               float* __restrict__ running_mean,
                               float* __restrict__ running_var,
                               long long* __restrict__ tracked,
                               float* __restrict__ saved) {
  const long long batches = *tracked;
  // momentum < 0: None, the cumulative average
  const float m = momentum >= 0.f ? momentum : 1.f / float(batches + 1);
  float count = 0.f;
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    float mean, var;
    merged(gathered, world, c, k, mean, var, count);
    saved[k] = mean;
    saved[c + k] = rsqrtf(var + eps);
    const float unbiased = var * count / fmaxf(count - 1.f, 1.f);
    running_mean[k] = lerp_torch(running_mean[k], mean, m);
    running_var[k] = lerp_torch(running_var[k], unbiased, m);
  }
  __syncthreads();  // every thread has read the counter
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int r = 0; r < world; ++r) total += gathered[r * 3 * int64_t(c)];
    saved[2 * c] = total;
    *tracked = batches + 1;
  }
}

// ------------------------------------------------------------------ NHWC
//
// Grid (row blocks, channel tiles); thread (ty, tx) = (threadIdx.x / cg,
// threadIdx.x % cg) owns channels (blockIdx.y * cg + tx) * V .. + V - 1 of
// rows r0 + ty, r0 + ty + lanes, ... below r1, lanes = kThreads / cg.

struct Nhwc {
  int cg, lanes, tx, ty, ch;
  int64_t r0, r1;
  bool active;

  __device__ __forceinline__ Nhwc(int c, int cg_, int64_t rows,
                                  int64_t per_block, int vec) {
    cg = cg_;
    lanes = kThreads / cg;
    tx = threadIdx.x % cg;
    ty = threadIdx.x / cg;
    ch = (blockIdx.y * cg + tx) * vec;
    r0 = blockIdx.x * per_block;
    r1 = r0 + per_block < rows ? r0 + per_block : rows;
    active = ty < lanes && ch < c;
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gbn_bn_fw_stats_nhwc(const T* __restrict__ x, int64_t rows, int c, int cg,
                     int64_t per_block, Moments* __restrict__ partial,
                     unsigned int* __restrict__ counters,
                     float* __restrict__ local) {
  __shared__ Moments sh[kThreads * kMaxVec];
  const Nhwc t(c, cg, rows, per_block, V);
  float mean[V], m2[V];
  int count = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) mean[v] = m2[v] = 0.f;
  if (t.active) {
    for (int64_t r = t.r0 + t.ty; r < t.r1; r += kUnroll * t.lanes) {
      float xs[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * t.lanes < t.r1)
          load<V>(x + (r + u * t.lanes) * c + t.ch, xs[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * t.lanes < t.r1) {  // Welford, one count for V channels
          ++count;
          const float inv = 1.f / float(count);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float d = xs[u][v] - mean[v];
            mean[v] += d * inv;
            m2[v] += d * (xs[u][v] - mean[v]);
          }
        }
      }
    }
  }
  Moments acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = {float(count), mean[v], m2[v]};
  const int width = t.cg * V;
  block_merge<Moments, V>(acc, sh, t.ty, t.lanes, t.tx * V, width);
  if (t.ty == 0 && t.active) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (t.ch + v < c) partial[int64_t(blockIdx.x) * c + t.ch + v] = acc[v];
  }
  if (!last_block(counters)) return;
  const int c0 = blockIdx.y * width;
  const Moments m = final_merge(partial, gridDim.x, c, c0, width, sh);
  const int k = c0 + threadIdx.x;
  if (threadIdx.x < width && k < c) {
    local[k] = float(rows);
    local[c + k] = m.mean;
    local[2 * c + k] = m.n > 0.f ? m.m2 / m.n : 0.f;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gbn_bn_fw_apply_nhwc(const T* __restrict__ x, T* __restrict__ y,
                     int64_t rows, int c, int cg, int64_t per_block,
                     const float* __restrict__ gathered, int world,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias, float eps,
                     float momentum, float* __restrict__ running_mean,
                     float* __restrict__ running_var,
                     long long* __restrict__ tracked,
                     float* __restrict__ saved) {
  const Nhwc t(c, cg, rows, per_block, V);
  if (t.active) {
    float a[V], b[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float mean, var, count;
      merged(gathered, world, c, t.ch + v, mean, var, count);
      a[v] = rsqrtf(var + eps) * weight[t.ch + v];
      b[v] = bias[t.ch + v] - mean * a[v];
    }
    for (int64_t r = t.r0 + t.ty; r < t.r1; r += kUnroll * t.lanes) {
      float xs[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * t.lanes < t.r1)
          load<V>(x + (r + u * t.lanes) * c + t.ch, xs[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * t.lanes < t.r1) {
#pragma unroll
          for (int v = 0; v < V; ++v) xs[u][v] = xs[u][v] * a[v] + b[v];
          store<V>(y + (r + u * t.lanes) * c + t.ch, xs[u]);
        }
      }
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0)
    finish_forward(gathered, world, c, eps, momentum, running_mean,
                   running_var, tracked, saved);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gbn_bn_bw_reduce_nhwc(const T* __restrict__ dy, const T* __restrict__ x,
                      int64_t rows, int c, int cg, int64_t per_block,
                      const float* __restrict__ saved,
                      Sums* __restrict__ partial,
                      unsigned int* __restrict__ counters,
                      float* __restrict__ sums,
                      float* __restrict__ d_weight,
                      float* __restrict__ d_bias) {
  __shared__ Sums sh[kThreads * kMaxVec];
  const Nhwc t(c, cg, rows, per_block, V);
  Sums acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = {0.f, 0.f};
  if (t.active) {
    float mean[V];
#pragma unroll
    for (int v = 0; v < V; ++v) mean[v] = saved[t.ch + v];
    for (int64_t r = t.r0 + t.ty; r < t.r1; r += kUnroll * t.lanes) {
      float gs[kUnroll][V], xs[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * t.lanes < t.r1) {
          load<V>(dy + (r + u * t.lanes) * c + t.ch, gs[u]);
          load<V>(x + (r + u * t.lanes) * c + t.ch, xs[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * t.lanes < t.r1) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[v].dy += gs[u][v];
            acc[v].dyx += gs[u][v] * (xs[u][v] - mean[v]);
          }
        }
      }
    }
  }
  const int width = t.cg * V;
  block_merge<Sums, V>(acc, sh, t.ty, t.lanes, t.tx * V, width);
  if (t.ty == 0 && t.active) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (t.ch + v < c) partial[int64_t(blockIdx.x) * c + t.ch + v] = acc[v];
  }
  if (!last_block(counters)) return;
  const int c0 = blockIdx.y * width;
  const Sums s = final_merge(partial, gridDim.x, c, c0, width, sh);
  const int k = c0 + threadIdx.x;
  if (threadIdx.x < width && k < c) {
    const float dyx = s.dyx * saved[c + k];  // sum(dy * xhat)
    sums[k] = d_bias[k] = s.dy;
    sums[c + k] = d_weight[k] = dyx;
  }
}

// dx's per-channel constants: dx = k * (dy - s1 - (x - mean) * invstd * s2)
__device__ __forceinline__ void dx_constants(const float* __restrict__ saved,
                                             const float* __restrict__ sums,
                                             const float* __restrict__ weight,
                                             int c, int ch, float& mean,
                                             float& scale, float& s1,
                                             float& s2) {
  const float count = saved[2 * c];
  const float invstd = saved[c + ch];
  mean = saved[ch];
  scale = weight[ch] * invstd;
  s1 = sums[ch] / count;
  s2 = sums[c + ch] / count * invstd;  // applied to (x - mean)
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gbn_bn_bw_dx_nhwc(const T* __restrict__ dy, const T* __restrict__ x,
                  T* __restrict__ dx, int64_t rows, int c, int cg,
                  int64_t per_block, const float* __restrict__ saved,
                  const float* __restrict__ sums,
                  const float* __restrict__ weight) {
  const Nhwc t(c, cg, rows, per_block, V);
  if (!t.active) return;
  float mean[V], scale[V], s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    dx_constants(saved, sums, weight, c, t.ch + v, mean[v], scale[v], s1[v],
                 s2[v]);
  for (int64_t r = t.r0 + t.ty; r < t.r1; r += kUnroll * t.lanes) {
    float gs[kUnroll][V], xs[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * t.lanes < t.r1) {
        load<V>(dy + (r + u * t.lanes) * c + t.ch, gs[u]);
        load<V>(x + (r + u * t.lanes) * c + t.ch, xs[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * t.lanes < t.r1) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          xs[u][v] = scale[v] * (gs[u][v] - s1[v] - (xs[u][v] - mean[v]) *
                                                        s2[v]);
        store<V>(dx + (r + u * t.lanes) * c + t.ch, xs[u]);
      }
    }
  }
}

// ------------------------------------------------------------------ NCHW
//
// Grid (blocks of a channel, C); block (bx, k) takes vectors j0 .. j1 - 1
// of channel k's n * hv vectors of V values (hv = HW / V per plane),
// thread i vectors j0 + i, j0 + i + kThreads, ...

struct Nchw {
  int k;
  int64_t j0, j1, hv, hw, c;

  __device__ __forceinline__ Nchw(int64_t n, int c_, int64_t hw_, int vec,
                                  int64_t per_block) {
    k = blockIdx.y;
    c = c_;
    hw = hw_;
    hv = hw_ / vec;
    j0 = blockIdx.x * per_block;
    const int64_t all = n * hv;
    j1 = j0 + per_block < all ? j0 + per_block : all;
  }

  // the offset of vector j's first value
  __device__ __forceinline__ int64_t at(int64_t j, int vec) const {
    const int64_t img = j / hv;
    return (img * c + k) * hw + (j - img * hv) * vec;
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gbn_bn_fw_stats_nchw(const T* __restrict__ x, int64_t n, int c, int64_t hw,
                     int64_t per_block, Moments* __restrict__ partial,
                     unsigned int* __restrict__ counters,
                     float* __restrict__ local) {
  __shared__ Moments sh[kThreads];
  const Nchw t(n, c, hw, V, per_block);
  Moments acc[1] = {{0.f, 0.f, 0.f}};
  for (int64_t j = t.j0 + threadIdx.x; j < t.j1; j += kUnroll * kThreads) {
    float xs[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * kThreads < t.j1)
        load<V>(x + t.at(j + u * kThreads, V), xs[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < t.j1) {  // the vector's moments, then Chan
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) s += xs[u][v];
        const float mean = s / float(V);
        float m2 = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v)
          m2 += (xs[u][v] - mean) * (xs[u][v] - mean);
        acc[0] = merge(acc[0], Moments{float(V), mean, m2});
      }
    }
  }
  block_merge<Moments, 1>(acc, sh, threadIdx.x, kThreads, 0, 1);
  if (threadIdx.x == 0) partial[int64_t(blockIdx.x) * c + t.k] = acc[0];
  if (!last_block(counters)) return;
  const Moments m = final_merge(partial, gridDim.x, c, t.k, 1, sh);
  if (threadIdx.x == 0) {
    local[t.k] = float(n * hw);
    local[c + t.k] = m.mean;
    local[2 * c + t.k] = m.n > 0.f ? m.m2 / m.n : 0.f;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gbn_bn_fw_apply_nchw(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                     int c, int64_t hw, int64_t per_block,
                     const float* __restrict__ gathered, int world,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias, float eps,
                     float momentum, float* __restrict__ running_mean,
                     float* __restrict__ running_var,
                     long long* __restrict__ tracked,
                     float* __restrict__ saved) {
  const Nchw t(n, c, hw, V, per_block);
  float mean, var, count;
  merged(gathered, world, c, t.k, mean, var, count);
  const float a = rsqrtf(var + eps) * weight[t.k];
  const float b = bias[t.k] - mean * a;
  for (int64_t j = t.j0 + threadIdx.x; j < t.j1; j += kUnroll * kThreads) {
    float xs[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * kThreads < t.j1)
        load<V>(x + t.at(j + u * kThreads, V), xs[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < t.j1) {
#pragma unroll
        for (int v = 0; v < V; ++v) xs[u][v] = xs[u][v] * a + b;
        store<V>(y + t.at(j + u * kThreads, V), xs[u]);
      }
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0)
    finish_forward(gathered, world, c, eps, momentum, running_mean,
                   running_var, tracked, saved);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gbn_bn_bw_reduce_nchw(const T* __restrict__ dy, const T* __restrict__ x,
                      int64_t n, int c, int64_t hw, int64_t per_block,
                      const float* __restrict__ saved,
                      Sums* __restrict__ partial,
                      unsigned int* __restrict__ counters,
                      float* __restrict__ sums,
                      float* __restrict__ d_weight,
                      float* __restrict__ d_bias) {
  __shared__ Sums sh[kThreads];
  const Nchw t(n, c, hw, V, per_block);
  const float mean = saved[t.k];
  Sums acc[1] = {{0.f, 0.f}};
  for (int64_t j = t.j0 + threadIdx.x; j < t.j1; j += kUnroll * kThreads) {
    float gs[kUnroll][V], xs[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < t.j1) {
        const int64_t at = t.at(j + u * kThreads, V);
        load<V>(dy + at, gs[u]);
        load<V>(x + at, xs[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < t.j1) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[0].dy += gs[u][v];
          acc[0].dyx += gs[u][v] * (xs[u][v] - mean);
        }
      }
    }
  }
  block_merge<Sums, 1>(acc, sh, threadIdx.x, kThreads, 0, 1);
  if (threadIdx.x == 0) partial[int64_t(blockIdx.x) * c + t.k] = acc[0];
  if (!last_block(counters)) return;
  const Sums s = final_merge(partial, gridDim.x, c, t.k, 1, sh);
  if (threadIdx.x == 0) {
    const float dyx = s.dyx * saved[c + t.k];
    sums[t.k] = d_bias[t.k] = s.dy;
    sums[c + t.k] = d_weight[t.k] = dyx;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gbn_bn_bw_dx_nchw(const T* __restrict__ dy, const T* __restrict__ x,
                  T* __restrict__ dx, int64_t n, int c, int64_t hw,
                  int64_t per_block, const float* __restrict__ saved,
                  const float* __restrict__ sums,
                  const float* __restrict__ weight) {
  const Nchw t(n, c, hw, V, per_block);
  float mean, scale, s1, s2;
  dx_constants(saved, sums, weight, c, t.k, mean, scale, s1, s2);
  for (int64_t j = t.j0 + threadIdx.x; j < t.j1; j += kUnroll * kThreads) {
    float gs[kUnroll][V], xs[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < t.j1) {
        const int64_t at = t.at(j + u * kThreads, V);
        load<V>(dy + at, gs[u]);
        load<V>(x + at, xs[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < t.j1) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          xs[u][v] = scale * (gs[u][v] - s1 - (xs[u][v] - mean) * s2);
        store<V>(dx + t.at(j + u * kThreads, V), xs[u]);
      }
    }
  }
}

// ------------------------------------------------------------- launching

// The shape of one call and the grid that covers it.
struct Plan {
  bool nhwc;
  int vec;           // values a thread loads at once
  int cg;            // NHWC: channel groups of a block
  int64_t per_block; // NHWC: rows; NCHW: vectors of a channel
  dim3 grid;
};

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// How a kernel's grid is cut: the blocks an SM it aims at, a block's
// channel groups at most (NHWC), and the rows (NHWC) or vectors (NCHW) a
// thread takes at least. The reductions take narrow tiles and few row
// blocks, so that the last block of a tile merges few partials (their
// count is the row blocks of the tile); the streaming kernels wide tiles.
struct Kind {
  int blocks_per_sm, max_groups, min_per_thread;
};
constexpr Kind kReduce = {2, 8, 4 * kUnroll};
constexpr Kind kStream = {4, kMaxGroups, kUnroll};

// `ptrs`: the call's activations, whose alignment allows 16-byte vectors.
cudaError_t plan(int64_t n, int c, int64_t hw, int nhwc, int elt, Kind kind,
                 const void* const* ptrs, int n_ptrs, Plan& p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  bool al = true;
  for (int i = 0; i < n_ptrs; ++i) al = al && aligned(ptrs[i]);
  const int full = 16 / elt;
  const int64_t target = int64_t(kind.blocks_per_sm) * sms;
  p.nhwc = nhwc != 0;
  if (p.nhwc) {
    p.vec = al && c % full == 0 ? full : 1;
    const int groups = c / p.vec;
    p.cg = groups < kind.max_groups ? groups : kind.max_groups;
    const int tiles = (groups + p.cg - 1) / p.cg;
    const int lanes = kThreads / p.cg;
    const int64_t rows = n * hw;
    const int64_t least = int64_t(lanes) * kind.min_per_thread;
    const int64_t most = (rows + least - 1) / least;
    int64_t blocks = (target + tiles - 1) / tiles;
    if (blocks > most) blocks = most;
    if (blocks < 1) blocks = 1;
    p.per_block = (rows + blocks - 1) / blocks;
    blocks = (rows + p.per_block - 1) / p.per_block;
    if (tiles > kMaxTiles) return cudaErrorInvalidValue;
    p.grid = dim3(unsigned(blocks), unsigned(tiles));
  } else {
    p.vec = al && hw % full == 0 ? full : 1;
    p.cg = 0;
    const int64_t vectors = n * (hw / p.vec);
    const int64_t least = int64_t(kThreads) * kind.min_per_thread;
    const int64_t most = (vectors + least - 1) / least;
    int64_t blocks = (target + c - 1) / c;
    if (blocks > most) blocks = most;
    if (blocks < 1) blocks = 1;
    p.per_block = (vectors + blocks - 1) / blocks;
    blocks = (vectors + p.per_block - 1) / p.per_block;
    if (c > kMaxTiles) return cudaErrorInvalidValue;
    p.grid = dim3(unsigned(blocks), unsigned(c));
  }
  return cudaSuccess;
}

template <int V>
using Vec = std::integral_constant<int, V>;

// fn(T{}, Vec<V>{}) for the activations' type T and the plan's vector
// width V; returns what fn returns
template <class Fn>
cudaError_t by_type(int x_bf16, const Plan& p, Fn fn) {
  if (x_bf16)
    return p.vec == 8 ? fn(__nv_bfloat16{}, Vec<8>{})
                      : fn(__nv_bfloat16{}, Vec<1>{});
  return p.vec == 4 ? fn(float{}, Vec<4>{}) : fn(float{}, Vec<1>{});
}

bool valid(int64_t n, int c, int64_t hw) {
  return n > 0 && c > 0 && hw > 0 && c <= kMaxTiles;
}

}  // namespace

// Shapes: x is (n, c, h, w) with hw = h * w, NHWC in memory (nhwc = 1) or
// NCHW (nhwc = 0); x, y, dy, dx float32 (x_bf16 = 0) or bfloat16
// (x_bf16 = 1); weight, bias, running_mean, running_var, d_weight, d_bias
// (c,) float32; tracked one int64. Float32 buffers: local (3, c),
// gathered (world, 3, c), saved (2c + 1), sums (2, c); partial: at least
// gbn_max_blocks() * 3 * c floats; counters: 65535 zeroed unsigned ints,
// left zeroed. Each function launches one kernel on `stream` and returns
// cudaGetLastError() of the launch (0 on success).

// The most row blocks a reduction's grid takes on this device (its
// partials' capacity is that times 3 * c floats).
extern "C" int gbn_max_blocks() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return kReduce.blocks_per_sm * sms;
}

extern "C" int gbn_fw_stats(const void* x, long long n, int c, long long hw,
                            int nhwc, int x_bf16, float* local, void* partial,
                            void* counters, void* stream) {
  if (!valid(n, c, hw)) return int(cudaErrorInvalidValue);
  const void* ptrs[1] = {x};
  Plan p;
  cudaError_t err = plan(n, c, hw, nhwc, x_bf16 ? 2 : 4, kReduce, ptrs, 1,
                         p);
  if (err != cudaSuccess) return int(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<Moments*>(partial);
  auto* count = static_cast<unsigned int*>(counters);
  return int(by_type(x_bf16, p, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    const T* xs = static_cast<const T*>(x);
    if (p.nhwc)
      gbn_bn_fw_stats_nhwc<T, V><<<p.grid, kThreads, 0, s>>>(
          xs, n * hw, c, p.cg, p.per_block, part, count, local);
    else
      gbn_bn_fw_stats_nchw<T, V><<<p.grid, kThreads, 0, s>>>(
          xs, n, c, hw, p.per_block, part, count, local);
    return cudaGetLastError();
  }));
}

extern "C" int gbn_fw_apply(const void* x, void* y, long long n, int c,
                            long long hw, int nhwc, int x_bf16,
                            const float* gathered, int world,
                            const float* weight, const float* bias,
                            float eps, float momentum, float* running_mean,
                            float* running_var, long long* tracked,
                            float* saved, void* stream) {
  if (!valid(n, c, hw) || world < 1) return int(cudaErrorInvalidValue);
  const void* ptrs[2] = {x, y};
  Plan p;
  cudaError_t err = plan(n, c, hw, nhwc, x_bf16 ? 2 : 4, kStream, ptrs, 2,
                         p);
  if (err != cudaSuccess) return int(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(by_type(x_bf16, p, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    const T* xs = static_cast<const T*>(x);
    T* ys = static_cast<T*>(y);
    if (p.nhwc)
      gbn_bn_fw_apply_nhwc<T, V><<<p.grid, kThreads, 0, s>>>(
          xs, ys, n * hw, c, p.cg, p.per_block, gathered, world, weight,
          bias, eps, momentum, running_mean, running_var, tracked, saved);
    else
      gbn_bn_fw_apply_nchw<T, V><<<p.grid, kThreads, 0, s>>>(
          xs, ys, n, c, hw, p.per_block, gathered, world, weight, bias, eps,
          momentum, running_mean, running_var, tracked, saved);
    return cudaGetLastError();
  }));
}

extern "C" int gbn_bw_reduce(const void* dy, const void* x, long long n,
                             int c, long long hw, int nhwc, int x_bf16,
                             const float* saved, void* partial,
                             void* counters, float* sums, float* d_weight,
                             float* d_bias, void* stream) {
  if (!valid(n, c, hw)) return int(cudaErrorInvalidValue);
  const void* ptrs[2] = {dy, x};
  Plan p;
  cudaError_t err = plan(n, c, hw, nhwc, x_bf16 ? 2 : 4, kReduce, ptrs, 2,
                         p);
  if (err != cudaSuccess) return int(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<Sums*>(partial);
  auto* count = static_cast<unsigned int*>(counters);
  return int(by_type(x_bf16, p, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    const T* gs = static_cast<const T*>(dy);
    const T* xs = static_cast<const T*>(x);
    if (p.nhwc)
      gbn_bn_bw_reduce_nhwc<T, V><<<p.grid, kThreads, 0, s>>>(
          gs, xs, n * hw, c, p.cg, p.per_block, saved, part, count, sums,
          d_weight, d_bias);
    else
      gbn_bn_bw_reduce_nchw<T, V><<<p.grid, kThreads, 0, s>>>(
          gs, xs, n, c, hw, p.per_block, saved, part, count, sums, d_weight,
          d_bias);
    return cudaGetLastError();
  }));
}

extern "C" int gbn_bw_dx(const void* dy, const void* x, void* out,
                         long long n, int c, long long hw, int nhwc,
                         int x_bf16, const float* saved, const float* sums,
                         const float* weight, void* stream) {
  if (!valid(n, c, hw)) return int(cudaErrorInvalidValue);
  const void* ptrs[3] = {dy, x, out};
  Plan p;
  cudaError_t err = plan(n, c, hw, nhwc, x_bf16 ? 2 : 4, kStream, ptrs, 3,
                         p);
  if (err != cudaSuccess) return int(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(by_type(x_bf16, p, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    const T* gs = static_cast<const T*>(dy);
    const T* xs = static_cast<const T*>(x);
    T* dxs = static_cast<T*>(out);
    if (p.nhwc)
      gbn_bn_bw_dx_nhwc<T, V><<<p.grid, kThreads, 0, s>>>(
          gs, xs, dxs, n * hw, c, p.cg, p.per_block, saved, sums, weight);
    else
      gbn_bn_bw_dx_nchw<T, V><<<p.grid, kThreads, 0, s>>>(
          gs, xs, dxs, n, c, hw, p.per_block, saved, sums, weight);
    return cudaGetLastError();
  }));
}
