// The nested engine's meta push: one meta row into the meta-FDL ring, in place.
//
// Replaces no Pallas kernel. neojax.conv.nested inserts the row with jnp ops
// inside its jitted chunk step, where XLA fuses them; the port ran the same
// ops as a dozen PyTorch kernels a chunk (stack, abs, amax, where, divide,
// multiply, round, clamp, cast, the slot and scale copies). Used by
// conv.nested.process_nested, the hybrid engine's chunk-rate tail and
// dist.partnested's insert:
//
//   for each (c, k, group g of W = L/G meta-bins):
//     peak  = max |x| over the group's re and im parts
//     scale = peak > 0 ? peak : 1
//     fdl[0|1, pos, c, k, m] = clamp(rint(x / scale * int_max), -int_max, int_max)
//     scales[pos, c, k, g]   = scale
//
// for int8/int16 (IEEE division, rint half to even: the bits of
// kernels.meta_push.meta_push_reference, which is torch's divide, multiply,
// round and clamp), and the cast alone for f32/bf16 (bf16 round to nearest
// even), with no scales. The row is read where the meta-FFT leaves it: the
// .real and .imag views of one complex64 [C, K, L] tensor, passed as two
// pointers with their common element strides, so nothing is staged.
//
// Bound on the H100: device-memory bytes. At the nested int8 cell (C = 64,
// K = 513, L = 256, G = 64) a push reads 67.24 MB of complex64 and writes
// 16.81 MB of int8 planes and 8.40 MB of scales: 92.45 MB, 27.6 us at
// 3.35 TB/s. About 30 flops an element (a division among them) stay well
// under the f32 rate.
//
// Design: a thread owns V consecutive meta-bins (V = 4, 2 or 1: the most
// that divides W and keeps every access aligned), loaded as float4 pairs of
// the interleaved complex (float2 at V = 1), and keeps them in registers
// between the peak and the writes. A group spans TPG threads (the power of
// two at or above W / V, at most a CTA) whose peak is a shuffle max within
// the warp and, past 32 threads, a max over the group's warps in shared
// memory; a group wider than TPG * V bins is walked in REPS strides, its
// first in registers and the rest read again (L1/L2) for the writes. At the
// int8 cell W = 4 = V: one thread a group, no shuffle, one char4 store a
// plane and one float scale; a warp's loads are 1 KB contiguous and its
// stores 128 B a plane. The float storages take the same kernel with a
// "group" of V bins and no peak. One thread slot a (group, TPG lane),
// 128 a CTA: 16,416 CTAs at the int8 cell, every SM covered many times
// (on an H100, against 256 a CTA and streaming loads, 128 and cached loads
// read 1-2 % faster there and 12 % at the hybrid tail's W = 2).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Bins [m, m + V) of one (c, k) row: re[i], im[i].
template <int V, bool kPair>
__device__ __forceinline__ void load_bins(const float* __restrict__ xre, const float* __restrict__ xim,
                                          long long off, long long s_l, float (&re)[V], float (&im)[V]) {
  if constexpr (kPair) {  // interleaved complex: im = re + 1, s_l = 2
    if constexpr (V == 1) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(xre + off));
      re[0] = a.x;
      im[0] = a.y;
    } else {
#pragma unroll
      for (int i = 0; i < V; i += 2) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(xre + off + 2 * i));
        re[i] = a.x;
        im[i] = a.y;
        re[i + 1] = a.z;
        im[i + 1] = a.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      re[i] = xre[off + i * s_l];
      im[i] = xim[off + i * s_l];
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_bins(T* __restrict__ out_re, T* __restrict__ out_im, size_t idx,
                                           const float (&re)[V], const float (&im)[V], float scale) {
  constexpr bool kQuant = neo::Traits<T>::kQuant;
  constexpr float kMax = neo::Traits<T>::kIntMax;
  Pack<T, V> pr, pi;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float r = re[i], m = im[i];
    if constexpr (kQuant) {
      r = fminf(fmaxf(rintf(__fdiv_rn(r, scale) * kMax), -kMax), kMax);
      m = fminf(fmaxf(rintf(__fdiv_rn(m, scale) * kMax), -kMax), kMax);
    }
    neo::store(&pr.v[i], r);
    neo::store(&pi.v[i], m);
  }
  *reinterpret_cast<Pack<T, V>*>(out_re + idx) = pr;
  *reinterpret_cast<Pack<T, V>*>(out_im + idx) = pi;
}

template <typename T, int V, bool kPair>
__global__ void __launch_bounds__(kThreads) meta_push_kernel(
    const float* __restrict__ xre, const float* __restrict__ xim, long long s_c, long long s_k,
    long long s_l, T* __restrict__ out_re, T* __restrict__ out_im, float* __restrict__ scales,
    int K, int L, int G, int tpg_log2, int reps, unsigned slots) {
  constexpr bool kQuant = neo::Traits<T>::kQuant;
  __shared__ float warp_peak[kThreads / 32];
  const int tpg = 1 << tpg_log2;
  const unsigned slot = blockIdx.x * kThreads + threadIdx.x;
  const bool live = slot < slots;  // no early exit: a group past a warp meets __syncthreads
  const unsigned group = slot >> tpg_log2;  // (c * K + k) * G + g
  const int lane = static_cast<int>(slot & (tpg - 1));
  const unsigned ck = group / G;
  const unsigned c = ck / K;
  const int W = L / G;
  const int m0 = static_cast<int>(group - ck * G) * W;
  const long long row = static_cast<long long>(c) * s_c + static_cast<long long>(ck - c * K) * s_k;

  float re[V], im[V];
  float peak = 0.0f;
  const bool first = live && lane * V < W;
  if (first) {
    load_bins<V, kPair>(xre, xim, row + (m0 + lane * V) * s_l, s_l, re, im);
#pragma unroll
    for (int i = 0; i < V; ++i) peak = fmaxf(peak, fmaxf(fabsf(re[i]), fabsf(im[i])));
  }
  if constexpr (kQuant) {
    for (int r = 1; r < reps; ++r) {
      const int m = (r * tpg + lane) * V;
      if (live && m < W) {
        float a[V], b[V];
        load_bins<V, kPair>(xre, xim, row + (m0 + m) * s_l, s_l, a, b);
#pragma unroll
        for (int i = 0; i < V; ++i) peak = fmaxf(peak, fmaxf(fabsf(a[i]), fabsf(b[i])));
      }
    }
    for (int o = 1; o < min(tpg, 32); o <<= 1) peak = fmaxf(peak, __shfl_xor_sync(0xffffffffu, peak, o));
    if (tpg > 32) {  // the group's warps meet in shared memory (tpg is uniform)
      const int w = threadIdx.x >> 5, wpg = tpg >> 5;
      if ((threadIdx.x & 31) == 0) warp_peak[w] = peak;
      __syncthreads();
      const int w0 = w & ~(wpg - 1);
      for (int i = 0; i < wpg; ++i) peak = fmaxf(peak, warp_peak[w0 + i]);
    }
  }
  const float scale = peak > 0.0f ? peak : 1.0f;
  const size_t base = static_cast<size_t>(ck) * L + m0;
  if (first) {
    store_bins<T, V>(out_re, out_im, base + lane * V, re, im, scale);
    if (kQuant && lane == 0) scales[group] = scale;
  }
  for (int r = 1; r < reps; ++r) {
    const int m = (r * tpg + lane) * V;
    if (live && m < W) {
      load_bins<V, kPair>(xre, xim, row + (m0 + m) * s_l, s_l, re, im);
      store_bins<T, V>(out_re, out_im, base + m, re, im, scale);
    }
  }
}

template <typename T, int V, bool kPair>
int launch(const float* xre, const float* xim, long long s_c, long long s_k, long long s_l, T* out_re,
           T* out_im, float* scales, int C, int K, int L, int G, int W, cudaStream_t s) {
  int tpg_log2 = 0;
  while ((1 << tpg_log2) < W / V && (1 << tpg_log2) < kThreads) ++tpg_log2;
  const int reps = (W / V + (1 << tpg_log2) - 1) >> tpg_log2;
  const size_t slots = (static_cast<size_t>(C) * K * G) << tpg_log2;
  if (slots > 0xffffff00u) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((slots + kThreads - 1) / kThreads);
  meta_push_kernel<T, V, kPair><<<grid, kThreads, 0, s>>>(xre, xim, s_c, s_k, s_l, out_re, out_im, scales,
                                                          K, L, G, tpg_log2, reps,
                                                          static_cast<unsigned>(slots));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPair>
int launch_v(int v, const float* xre, const float* xim, long long s_c, long long s_k, long long s_l,
             T* out_re, T* out_im, float* scales, int C, int K, int L, int G, int W, cudaStream_t s) {
  if (v == 4) return launch<T, 4, kPair>(xre, xim, s_c, s_k, s_l, out_re, out_im, scales, C, K, L, G, W, s);
  if (v == 2) return launch<T, 2, kPair>(xre, xim, s_c, s_k, s_l, out_re, out_im, scales, C, K, L, G, W, s);
  return launch<T, 1, kPair>(xre, xim, s_c, s_k, s_l, out_re, out_im, scales, C, K, L, G, W, s);
}

bool aligned(const void* p, long long stride_bytes_c, long long stride_bytes_k, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0 && stride_bytes_c % bytes == 0 && stride_bytes_k % bytes == 0;
}

template <typename T>
int dispatch(void* fdl, void* scales, const float* xre, const float* xim, long long s_c,
             long long s_k, long long s_l, int P2, int pos, int C, int K, int L, int G, cudaStream_t s) {
  constexpr bool kQuant = neo::Traits<T>::kQuant;
  const size_t plane = static_cast<size_t>(C) * K * L;
  T* out_re = static_cast<T*>(fdl) + pos * plane;
  T* out_im = out_re + static_cast<size_t>(P2) * plane;
  float* scl = kQuant ? static_cast<float*>(scales) + static_cast<size_t>(pos) * C * K * G : nullptr;
  const int span = kQuant ? L / G : L;  // the bins a thread's V must divide
  const bool pair = xim == xre + 1 && s_l == 2;
  for (int v = 4; v >= 1; v >>= 1) {
    if (span % v || !aligned(out_re, 0, 0, sizeof(T) * v)) continue;
    const int W = kQuant ? span : v;  // a float storage's "group" is a thread's V bins
    const int g = kQuant ? G : L / v;
    if (pair && aligned(xre, s_c * 4, s_k * 4, v == 1 ? 8 : 16))
      return launch_v<T, true>(v, xre, xim, s_c, s_k, s_l, out_re, out_im, scl, C, K, L, g, W, s);
    return launch_v<T, false>(v, xre, xim, s_c, s_k, s_l, out_re, out_im, scl, C, K, L, g, W, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int neo_meta_push(int storage, void* fdl, void* scales, const void* xre, const void* xim,
                             long long s_c, long long s_k, long long s_l, int P2, int pos, int C, int K,
                             int L, int G, void* stream) {
  const bool quant = storage == neo::kInt16 || storage == neo::kInt8;
  if (P2 < 1 || pos < 0 || pos >= P2 || C < 1 || K < 1 || L < 1 || (quant && (G < 1 || L % G)) ||
      (quant && scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* re = static_cast<const float*>(xre);
  const float* im = static_cast<const float*>(xim);
  switch (storage) {
    case neo::kSplit:
      return dispatch<float>(fdl, scales, re, im, s_c, s_k, s_l, P2, pos, C, K, L, G, s);
    case neo::kBf16:
      return dispatch<__nv_bfloat16>(fdl, scales, re, im, s_c, s_k, s_l, P2, pos, C, K, L, G, s);
    case neo::kInt16:
      return dispatch<int16_t>(fdl, scales, re, im, s_c, s_k, s_l, P2, pos, C, K, L, G, s);
    case neo::kInt8:
      return dispatch<int8_t>(fdl, scales, re, im, s_c, s_k, s_l, P2, pos, C, K, L, G, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
