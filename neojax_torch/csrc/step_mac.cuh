// The one-block partition MAC shared by B1 (fdl_mac.cu: the unfused MAC and
// its tile-sparse form B4) and B2 (fused_step.cu: step_mac), the fixed-order
// reduce of its P splits, and the probe T1 (probes.cu: the MAC's read with
// the compute stripped, kProbe below):
//
//   part[s, c, k] = sum over the slots p of split s of
//                   ring[p, c, k] * filt[p, c', k]            (complex)
//   acc[c, k]     = part[0, c, k] + part[1, c, k] + ...       (split order)
//
// in split-complex planes with f32 accumulation; int rings dequantized as
// x * (scale[p, c] * inv_max), the Pallas kernels' order.
//
// Design (H100). The MAC reads the whole ring once a call for 8 flops per
// complex element: it is bound by device-memory bytes. The grid is (lane
// tiles, channels, P splits): a thread owns V adjacent lanes, loaded as one
// vector (B2: V = 16 / sizeof(T), 16-byte ring loads; B1/B4: V = 4, one
// 16-byte load of each f32 filter plane; V = 1 where K or a pointer's
// alignment forbids it), and sums its split's slots in ascending order in
// registers, so the card has many CTAs and each thread several loads in
// flight. A CTA is 128 threads: the lanes of one channel, or, where a
// channel has fewer lane threads, rows of channels. The splits' partial
// sums go to part [S, 2, C, K] and step_reduce_kernel adds them in split
// order: no atomics, so a result is the same bits on every run. With S = 1
// the MAC writes the result itself.
//
// The filter is two planes with strides, (p, c, k) at
// fre / fim + p * f_row + c * f_c + k (f_c = 0: one filter for all
// channels), in M = float (B1, B4, B2 at split/int16) or bf16 (B2 at
// bf16/int8).
//
// Schedules skip slots whose filter rows are zero (sparse filters). The
// slots are grouped in chunks of pc rows; per chunk a thread forms the mask
// of its V lanes that are live there:
//   kWidths (B2): lanes k < wrow[chunk] (a prefix of live lanes)
//   kTiles  (B4): lanes in k-tiles t with trow[chunk * nk + t] != 0 (V
//                 divides k_tile, so a thread's lanes are live or dead alike)
// A chunk with no live lane is skipped, one with every lane live runs the
// dense loop, a mixed one masks the terms of its dead lanes. Every skipped
// term is an exact zero of the dense sum (the masked filter is zero there),
// in the dense summation order: a scheduled MAC equals the dense one on the
// masked filter bit for bit, apart from the sign of zero.
//
// kProbe (T1, probes.cu) is the MAC's read with its arithmetic stripped, on
// the same grid, index math and loads: a thread reads its split's slots of
// the ring as mac_slots does and, per chunk of pc slots, the filter's re
// row at the chunk's head (p % pc == 0) only; re += x_re * f_re at a head,
// im += x_im there and x_re + x_im at every other slot. A head may fall
// anywhere in a split, so the loop walks the chunks a split touches.
#pragma once

#include "common.cuh"

// Internal linkage: each translation unit keeps its own instances.
namespace {

using namespace neo;

// One complex multiply-add in a fixed order (the scheduled and dense
// kernels must sum alike).
__device__ __forceinline__ void cmac(float& ar, float& ai, float xr, float xi, float fr, float fi) {
  ar = fmaf(xr, fr, ar);
  ar = fmaf(-xi, fi, ar);
  ai = fmaf(xr, fi, ai);
  ai = fmaf(xi, fr, ai);
}

template <typename E, int V>
struct alignas(sizeof(E) * V) Pack {
  E v[V];
};

constexpr int kStepThreads = 128;  // threads of a CTA (lanes of one channel, or rows of channels)
constexpr int kReduceThreads = 256;

enum StepSched : int { kDense = 0, kWidths = 1, kTiles = 2, kProbe = 3 };

template <typename T, typename M>
struct StepArgs {
  const T* ring;        // [2, P, C, K]
  const float* scales;  // [P, C] (int storages)
  const M* fre;         // filter re at (p, c, k): fre[p * f_row + c * f_c + k]
  const M* fim;
  long long f_row, f_c;
  const int* wrow;      // kWidths: live lane widths of the chunks [P / pc]
  const uint8_t* trow;  // kTiles: live (chunk, k-tile) pairs [P / pc, nk]
  float* part;          // [S, 2, C, K]
  int P, C, K, pc, per;  // per: slots a split
  int k_tile, nk;        // kTiles: lanes a k-tile, k-tiles a row
};

__device__ __forceinline__ unsigned low_bits(int n) {
  return n <= 0 ? 0u : n >= 32 ? ~0u : (1u << n) - 1u;
}

// the V elements at e, one vector load (e aligned to V elements)
template <typename E, int V>
__device__ __forceinline__ Pack<E, V> load_pack(const E* e) {
  return *reinterpret_cast<const Pack<E, V>*>(e);
}

// slots [a, b) into the V accumulators of lanes k0.. of channel c;
// kMasked: only the lanes whose bit is set in live
template <typename T, typename M, int V, bool kMasked>
__device__ __forceinline__ void mac_slots(float (&ar)[V], float (&ai)[V], const StepArgs<T, M>& g,
                                          const T* xbase, const M* fbase_re, const M* fbase_im,
                                          const float* sbase, int a, int b, unsigned live) {
  constexpr bool kQuant = Traits<T>::kQuant;
  constexpr float kInvMax = 1.0f / Traits<T>::kIntMax;
  const size_t row = static_cast<size_t>(g.C) * g.K;
  const size_t plane = static_cast<size_t>(g.P) * row;
#pragma unroll(V >= 16 ? 2 : 4)
  for (int p = a; p < b; ++p) {
    const Pack<T, V> xr = load_pack<T, V>(xbase + p * row);
    const Pack<T, V> xi = load_pack<T, V>(xbase + p * row + plane);
    const Pack<M, V> fr = load_pack<M, V>(fbase_re + p * g.f_row);
    const Pack<M, V> fi = load_pack<M, V>(fbase_im + p * g.f_row);
    const float s = kQuant ? sbase[static_cast<size_t>(p) * g.C] * kInvMax : 1.0f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (kMasked && !((live >> v) & 1u)) continue;
      float r = to_f32(xr.v[v]), i = to_f32(xi.v[v]);
      if (kQuant) {
        r *= s;
        i *= s;
      }
      cmac(ar[v], ai[v], r, i, to_f32(fr.v[v]), to_f32(fi.v[v]));
    }
  }
}

// kProbe: slots [a, b) read as mac_slots reads them, the compute stripped
// (header); the filter's re row is loaded at the chunk heads only
template <typename T, typename M, int V>
__device__ __forceinline__ void probe_slots(float (&ar)[V], float (&ai)[V], const StepArgs<T, M>& g,
                                            const T* xbase, const M* fbase_re, int a, int b) {
  const size_t row = static_cast<size_t>(g.C) * g.K;
  const size_t plane = static_cast<size_t>(g.P) * row;
  for (int ch = a / g.pc; ch * g.pc < b; ++ch) {
    int lo = max(a, ch * g.pc);
    const int hi = min(b, (ch + 1) * g.pc);
    if (lo == ch * g.pc) {  // the chunk's head lies in this split
      const Pack<T, V> xr = load_pack<T, V>(xbase + lo * row);
      const Pack<T, V> xi = load_pack<T, V>(xbase + lo * row + plane);
      const Pack<M, V> fr = load_pack<M, V>(fbase_re + lo * g.f_row);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ar[v] = fmaf(to_f32(xr.v[v]), to_f32(fr.v[v]), ar[v]);
        ai[v] += to_f32(xi.v[v]);
      }
      ++lo;
    }
#pragma unroll(V >= 16 ? 2 : 4)
    for (int p = lo; p < hi; ++p) {
      const Pack<T, V> xr = load_pack<T, V>(xbase + p * row);
      const Pack<T, V> xi = load_pack<T, V>(xbase + p * row + plane);
#pragma unroll
      for (int v = 0; v < V; ++v) ai[v] += to_f32(xr.v[v]) + to_f32(xi.v[v]);
    }
  }
}

// grid (lane tiles of V * blockDim.x, channel groups of blockDim.y, S)
template <typename T, typename M, int V, int kSched>
__global__ void __launch_bounds__(kStepThreads) step_mac_kernel(StepArgs<T, M> g) {
  constexpr unsigned kAll = V >= 32 ? ~0u : (1u << V) - 1u;
  const int k0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int c = blockIdx.y * blockDim.y + threadIdx.y;
  if (k0 >= g.K || c >= g.C) return;
  const int p_beg = blockIdx.z * g.per, p_end = min(g.P, p_beg + g.per);
  const T* xbase = g.ring + static_cast<size_t>(c) * g.K + k0;
  const size_t foff = static_cast<size_t>(c) * g.f_c + k0;
  const M* fre = g.fre + foff;
  const M* fim = g.fim + foff;
  const float* sbase = g.scales + c;
  float ar[V], ai[V];
#pragma unroll
  for (int v = 0; v < V; ++v) ar[v] = ai[v] = 0.0f;
  if constexpr (kSched == kProbe) {
    probe_slots<T, M, V>(ar, ai, g, xbase, fre, p_beg, p_end);
  } else if (kSched == kDense) {
    mac_slots<T, M, V, false>(ar, ai, g, xbase, fre, fim, sbase, p_beg, p_end, kAll);
  } else {
    for (int ch = p_beg / g.pc; ch * g.pc < p_end; ++ch) {
      unsigned live;
      if (kSched == kWidths) {
        live = low_bits(g.wrow[ch] - k0) & kAll;
      } else {  // V divides k_tile: the thread's lanes lie in one k-tile
        live = g.trow[static_cast<size_t>(ch) * g.nk + k0 / g.k_tile] ? kAll : 0u;
      }
      if (!live) continue;
      const int a = max(p_beg, ch * g.pc), b = min(p_end, (ch + 1) * g.pc);
      if (live == kAll)
        mac_slots<T, M, V, false>(ar, ai, g, xbase, fre, fim, sbase, a, b, kAll);
      else
        mac_slots<T, M, V, true>(ar, ai, g, xbase, fre, fim, sbase, a, b, live);
    }
  }
  Pack<float, V> ore, oim;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ore.v[v] = ar[v];
    oim.v[v] = ai[v];
  }
  float* o = g.part + (static_cast<size_t>(blockIdx.z) * 2 * g.C + c) * g.K + k0;
  *reinterpret_cast<Pack<float, V>*>(o) = ore;
  *reinterpret_cast<Pack<float, V>*>(o + static_cast<size_t>(g.C) * g.K) = oim;
}

// The splits' partial sums part [S, 2, C, K] added in split order; lane 0
// := dcfix [2, C] when given; rounded to M. Re of (c, k) goes to
// acc[c * o_c + k], im to acc[c * o_c + o_im + k] (B2: [C, 2K], o_c = 2K,
// o_im = K; B1: [2, C, K], o_c = K, o_im = C * K).
template <typename M>
__global__ void __launch_bounds__(kReduceThreads) step_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ dcfix, float* __restrict__ acc, int S, int C,
    int K, long long o_c, long long o_im) {
  const size_t n = static_cast<size_t>(C) * K;
  for (size_t e = blockIdx.x * static_cast<size_t>(kReduceThreads) + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * kReduceThreads) {
    const int c = static_cast<int>(e / K), k = static_cast<int>(e % K);
    float re = 0.0f, im = 0.0f;
    for (int s = 0; s < S; ++s) {
      re += part[2 * s * n + e];
      im += part[(2 * s + 1) * n + e];
    }
    if (k == 0 && dcfix) {
      re = dcfix[c];
      im = dcfix[C + c];
    }
    float* o = acc + c * o_c + k;
    o[0] = round_to<M>(re);
    o[o_im] = round_to<M>(im);
  }
}

// a CTA: lane threads of one channel in x (up to kStepThreads), channels in y
template <typename T, typename M, int V, int kSched>
int launch_step_mac_v(const StepArgs<T, M>& g, int S, cudaStream_t st) {
  const int lanes = (g.K + V - 1) / V;  // threads a channel
  const int tx = lanes >= kStepThreads ? kStepThreads : (lanes + 31) / 32 * 32;
  const int ty = kStepThreads / tx < g.C ? kStepThreads / tx : g.C;
  const dim3 grid((lanes + tx - 1) / tx, (g.C + ty - 1) / ty, S);
  step_mac_kernel<T, M, V, kSched><<<grid, dim3(tx, ty), 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// V lanes a thread: 1, 4 (B1/B4) or 16 / sizeof(T) (B2), with K % V == 0
template <typename T, typename M, int kSched>
int launch_step_mac(const StepArgs<T, M>& g, int S, int vec, cudaStream_t st) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  if (vec < 1 || g.K % vec) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 1) return launch_step_mac_v<T, M, 1, kSched>(g, S, st);
  if (vec == 4) return launch_step_mac_v<T, M, 4, kSched>(g, S, st);
  if (vec == kV) return launch_step_mac_v<T, M, kV, kSched>(g, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename M>
int launch_step_reduce(const void* part, const void* dcfix, void* acc, int S, int C, int K, long long o_c,
                       long long o_im, cudaStream_t st) {
  const size_t n = static_cast<size_t>(C) * K;
  const size_t blocks = (n + kReduceThreads - 1) / kReduceThreads;
  step_reduce_kernel<M><<<static_cast<int>(blocks < 4096 ? blocks : 4096), kReduceThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(dcfix), static_cast<float*>(acc), S, C, K,
      o_c, o_im);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
