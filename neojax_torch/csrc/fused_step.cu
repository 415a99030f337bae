// B2 and B3, the fused per-block pipeline of the uniformly-partitioned
// convolver (packed-512 layout, ring FDL), as stage kernels that the
// wrappers of kernels/fused_step.py launch in order on one stream.
//
// Replaces neojax/kernels/fused_step.py :: fused_block_step (Pallas body
// _mk_kernel) and :: fused_stream (body _mk_stream_kernel). The function is
// theirs: frame rounded to the matrix dtype -> packed forward DFT ->
// quantize (per-(block, channel) peak scale, rint, x / scale * int_max,
// clamp) or cast -> ring row written with its scale -> MAC over P against
// the rotated filter, reading the new row back in its storage dtype and
// scale, seeded from acc_add when given -> lane 0 := dcfix -> accumulator
// rounded to the matrix dtype -> inverse (all N samples for B2, the UPOLS
// tail half for B3).
//
// On the H100 the block-by-block loop of the TPU kernel is bound by bytes:
// every block re-reads the whole ring (252 MB split at P = 960, C = 64,
// B = 512). The design here takes the work that does not depend on the
// ring out of the loop and batches the MAC over time. B3 walks its nb
// blocks in windows of W (kernels/fused_step.py :: WINDOW):
//
//   1. transform.cu: the window's forward DFTs, one shared-memory FFT a row
//   2. quantize_kernel: spectra -> staged rows X_new [W, 2, C, B] in the
//      storage dtype and their scales [W, C]
//   3. stream_mac_kernel: the time-batched MAC. Block i's sum
//      sum_a filt[a] X[i - a] is a causal convolution along time, so a
//      thread keeps 16 blocks' accumulators in registers and slides a
//      register window of 31 history rows along the taps (oldest first,
//      the small terms of the decaying filter before the large): each history
//      element and each filter element it loads feeds 16 complex
//      multiply-adds, and a ring row is read once per 16 blocks instead of
//      once per block. History rows inside the window come from X_new,
//      older ones from the ring (not yet overwritten: step 4 comes after).
//      Bound: operations (16.1 GFLOP for 64 blocks at the headline shape).
//   4. writeback_kernel: X_new and its scales into the ring slots, in their
//      own launch after the MAC (the last write wins when W > P)
//   5. transform.cu: the inverse FFTs, straight into the output
//
// B2 (one block) has no reuse across blocks: its MAC is bound by the ring's
// bytes. It writes the new row first (writeback_kernel, in place), then
// step_mac_kernel reads the ring with 16-byte loads along the lanes on a
// (lane tile, channel, P split) grid, and step_reduce_kernel adds the P
// splits' partial sums in a fixed order (no atomics), sets lane 0 and
// rounds. Both live in step_mac.cuh, shared with the unfused MAC (B1, B4 in
// fdl_mac.cu), which takes its filter as planes with strides.
//
// Sparse filters: widths_kernel turns the chunk schedule (the full [P, L]
// tables) into a [P, P / pc] table of live lane widths (0: not flagged).
// Block i honours row (pos0 + i) % P: slot p contributes on lanes k <
// width[row, p / pc]. The MACs skip (tap chunk, block tile, lane tile)
// tiles that are dead for every block of the tile and mask the terms of
// mixed tiles, in the dense kernel's summation order, so the scheduled
// kernels equal the dense ones on a masked filter.
#include "step_mac.cuh"

namespace {

using namespace neo;

constexpr int kRowThreads = 256;

// ---- 2. quantize or cast: one CTA a spectrum row (block i, channel c) of
// s [wc, C, 2B]; rows of x [wc, 2, C, B], scales scl [wc, C]
template <typename T>
__global__ void __launch_bounds__(kRowThreads) quantize_kernel(const float* __restrict__ s,
                                                               T* __restrict__ x,
                                                               float* __restrict__ scl, int C,
                                                               int B) {
  constexpr bool kQuant = Traits<T>::kQuant;
  constexpr float kIntMax = Traits<T>::kIntMax;
  __shared__ float red[kRowThreads / 32];
  const int r = blockIdx.x, i = r / C, c = r % C, tid = threadIdx.x;
  const int w = 2 * B;
  const float* row = s + static_cast<size_t>(r) * w;
  float scale = 1.0f;
  if (kQuant) {
    float m = 0.0f;
    for (int j = tid; j < w; j += kRowThreads) m = fmaxf(m, fabsf(row[j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    float peak = 0.0f;
#pragma unroll
    for (int k = 0; k < kRowThreads / 32; ++k) peak = fmaxf(peak, red[k]);
    scale = peak > 0.0f ? peak : 1.0f;
    if (tid == 0) scl[r] = scale;
  }
  T* dst = x + static_cast<size_t>(i) * 2 * C * B + static_cast<size_t>(c) * B;
  const size_t plane = static_cast<size_t>(C) * B;
  for (int j = tid; j < w; j += kRowThreads) {
    float v = row[j];
    if (kQuant) v = fminf(fmaxf(rintf(v / scale * kIntMax), -kIntMax), kIntMax);
    store(dst + (j / B) * plane + (j % B), v);
  }
}

// ---- 4. ring write-back: staged block i -> slot (pos_first + i) % P for
// the last min(wc, P) blocks (the earlier ones would be overwritten)
template <typename T>
__global__ void __launch_bounds__(kRowThreads) writeback_kernel(
    const T* __restrict__ x, const float* __restrict__ scl, T* __restrict__ fdl,
    float* __restrict__ scales, int P, int C, int B, int wc, int first, int pos_first) {
  const int r = blockIdx.x, i = first + r / C, c = r % C;
  const int slot = (pos_first + i) % P;
  const size_t plane = static_cast<size_t>(C) * B;
  const T* src = x + static_cast<size_t>(i) * 2 * plane + static_cast<size_t>(c) * B;
  T* dst = fdl + static_cast<size_t>(slot) * plane + static_cast<size_t>(c) * B;
  const size_t ring_plane = static_cast<size_t>(P) * plane;
  for (int j = threadIdx.x; j < 2 * B; j += kRowThreads)
    dst[(j / B) * ring_plane + (j % B)] = src[(j / B) * plane + (j % B)];
  if (scl && threadIdx.x == 0) scales[static_cast<size_t>(slot) * C + c] = scl[static_cast<size_t>(i) * C + c];
}

// ---- the chunk schedule as live widths: tab [P, nchunks], one CTA a row
__global__ void __launch_bounds__(kRowThreads) widths_kernel(const int* __restrict__ c_idx,
                                                             const int* __restrict__ c_flags,
                                                             int* __restrict__ tab, int L,
                                                             int nchunks, int B, int n_codes) {
  const int row = blockIdx.x;
  int* t = tab + static_cast<size_t>(row) * nchunks;
  for (int j = threadIdx.x; j < nchunks; j += kRowThreads) t[j] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += kRowThreads) {
    const size_t e = static_cast<size_t>(row) * L + j;
    if (c_flags[e] != 1) continue;
    const int v = c_idx[e];
    const int code = v >> 16, chunk = v & 0xFFFF;
    if (chunk < nchunks) atomicMax(t + chunk, code < n_codes ? B >> code : B);
  }
}

// ---- 3. the time-batched MAC (B3)
constexpr int kWT = 16;           // blocks a thread; also taps a chunk
constexpr int kMacThreads = 128;  // lanes a CTA

template <typename T, typename M>
struct MacArgs {
  const T* ring;        // [2, P, C, B]
  const float* scales;  // [P, C] (int storages)
  const T* xnew;        // [wc, 2, C, B] staged rows of this window
  const float* snew;    // [wc, C]
  const M* rim;         // [2P, Cf, 2B]
  const float* seed;    // [wc, 2, C, B] or null
  const float* dcfix;   // [wc, 2, C]
  const int* wtab;      // [P, nchunks] or null
  float* acc;           // [wc, C, 2B]
  int P, C, B, Cf, wc, pos_first, pc, nchunks;
};

// One chunk of kWT taps from a0 for the thread's kWT blocks. Block u at
// ring position pos[u] meets tap a at filter row P-1-a (a <= pos[u]) or
// 2P-1-a (the rows the block-by-block kernel reads; one filter when the
// rim is tiled). f0 holds the row of a pure chunk, f1 the 2P-1-a row of a
// mixed one (kMixed). kMasked: term (u, t) only on lanes k < wd[u][t].
// Taps go from the oldest to the newest (t descending): the filter decays,
// so the small terms are summed before the large ones.
template <bool kMasked, bool kMixed, typename M>
__device__ __forceinline__ void mac_chunk(float (&ar)[kWT], float (&ai)[kWT],
                                          const float (&xr)[2 * kWT - 1],
                                          const float (&xi)[2 * kWT - 1], const M* fbase,
                                          size_t frow, int B, int P, int a0, bool hi, int k,
                                          const int* pos, const int (*wd)[kWT]) {
#pragma unroll
  for (int t = kWT - 1; t >= 0; --t) {
    const int a = a0 + t;
    float f0r = 0.0f, f0i = 0.0f, f1r = 0.0f, f1i = 0.0f;
    if (a < P) {
      const M* f = fbase + static_cast<size_t>((hi && !kMixed ? 2 * P : P) - 1 - a) * frow;
      f0r = to_f32(f[0]);
      f0i = to_f32(f[B]);
      if (kMixed) {
        f += static_cast<size_t>(P) * frow;
        f1r = to_f32(f[0]);
        f1i = to_f32(f[B]);
      }
    }
#pragma unroll
    for (int u = 0; u < kWT; ++u) {
      if (kMasked && k >= wd[u][t]) continue;
      const bool up = kMixed && a > pos[u];
      cmac(ar[u], ai[u], xr[u - t + kWT - 1], xi[u - t + kWT - 1], up ? f1r : f0r, up ? f1i : f0i);
    }
  }
}

// grid (block tiles of kWT, lane tiles of kMacThreads, C)
template <typename T, typename M, bool kSched>
__global__ void __launch_bounds__(kMacThreads) stream_mac_kernel(MacArgs<T, M> g) {
  constexpr bool kQuant = Traits<T>::kQuant;
  constexpr float kInvMax = 1.0f / Traits<T>::kIntMax;
  __shared__ int wd[2][kWT][kWT];  // scheduled: live width of (block, tap) in a chunk
  __shared__ int pos[kWT];         // ring position of each block of the tile
  const int u0 = blockIdx.x * kWT;
  const int kbase = blockIdx.y * kMacThreads;
  const int k = kbase + threadIdx.x;
  const int c = blockIdx.z;
  const bool on = k < g.B;
  const int kk = on ? k : 0;
  const size_t row = static_cast<size_t>(g.C) * g.B;
  const size_t plane = static_cast<size_t>(g.P) * row;
  const size_t frow = static_cast<size_t>(g.Cf) * 2 * g.B;
  const M* fbase = g.rim + (g.Cf == 1 ? 0 : static_cast<size_t>(c) * 2 * g.B) + kk;
  const size_t cb = static_cast<size_t>(c) * g.B + kk;
  const int nu = min(kWT, g.wc - u0);  // blocks of this tile
  if (threadIdx.x < kWT) pos[threadIdx.x] = (g.pos_first + u0 + threadIdx.x) % g.P;
  __syncthreads();
  int pmin = g.P, pmax = -1;
  for (int u = 0; u < nu; ++u) {
    pmin = min(pmin, pos[u]);
    pmax = max(pmax, pos[u]);
  }

  // history block d (window-relative; d < 0: ring slot (pos_first + d) mod P)
  auto load_x = [&](int d, float& xr, float& xi) {
    if (!on || d >= g.wc) {
      xr = xi = 0.0f;
      return;
    }
    float s = 1.0f;
    if (d >= 0) {
      const T* src = g.xnew + static_cast<size_t>(d) * 2 * row + cb;
      xr = to_f32(src[0]);
      xi = to_f32(src[row]);
      if (kQuant) s = g.snew[static_cast<size_t>(d) * g.C + c] * kInvMax;
    } else {
      int slot = (g.pos_first + d) % g.P;
      if (slot < 0) slot += g.P;
      const T* src = g.ring + static_cast<size_t>(slot) * row + cb;
      xr = to_f32(src[0]);
      xi = to_f32(src[plane]);
      if (kQuant) s = g.scales[static_cast<size_t>(slot) * g.C + c] * kInvMax;
    }
    if (kQuant) {
      xr *= s;
      xi *= s;
    }
  };

  float ar[kWT], ai[kWT];
#pragma unroll
  for (int u = 0; u < kWT; ++u) {
    const bool live = on && u < nu && g.seed;
    ar[u] = live ? g.seed[static_cast<size_t>(u0 + u) * 2 * row + cb] : 0.0f;
    ai[u] = live ? g.seed[static_cast<size_t>(u0 + u) * 2 * row + row + cb] : 0.0f;
  }
  // xr[v] = X[u0 - a0 - (kWT - 1) + v]: block u at tap a0 + t reads v = u - t + kWT - 1.
  // Chunks go from the oldest taps to the newest (see mac_chunk); from chunk
  // a0 to a0 - kWT the window moves up by kWT rows.
  float xr[2 * kWT - 1], xi[2 * kWT - 1];
  bool carry = false;
  const int kend = min(g.B, kbase + kMacThreads);
  const int n_chunks = (g.P + kWT - 1) / kWT;
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int a0 = ch * kWT;
    bool masked = false;
    if (kSched) {
      int any = 0, all = 1;
      for (int e = threadIdx.x; e < kWT * kWT; e += kMacThreads) {
        const int u = e / kWT, t = e % kWT, a = a0 + t;
        int w = g.B;
        if (u < nu && a < g.P) {
          int slot = (pos[u] - a) % g.P;
          if (slot < 0) slot += g.P;
          w = g.wtab[static_cast<size_t>(pos[u]) * g.nchunks + slot / g.pc];
          any |= w > kbase;
          all &= w >= kend;
        }
        wd[ch & 1][u][t] = w;
      }
      const int live = __syncthreads_or(any);
      const int full = __syncthreads_and(all);
      if (!live) {
        carry = false;
        continue;
      }
      masked = !full;
    }
    if (carry) {
#pragma unroll
      for (int v = 0; v < kWT - 1; ++v) {
        xr[v] = xr[v + kWT];
        xi[v] = xi[v + kWT];
      }
    } else {
#pragma unroll
      for (int v = 0; v < kWT - 1; ++v) load_x(u0 - a0 - (kWT - 1) + v, xr[v], xi[v]);
    }
#pragma unroll
    for (int v = kWT - 1; v < 2 * kWT - 1; ++v) load_x(u0 - a0 - (kWT - 1) + v, xr[v], xi[v]);
    carry = true;
    // a pure chunk meets one filter row a tap for all its blocks
    const int alast = min(a0 + kWT, g.P) - 1;
    const bool lo = alast <= pmin, hi = a0 > pmax;
    const int(*w)[kWT] = wd[ch & 1];
    if (kSched && masked) {
      if (lo || hi)
        mac_chunk<true, false>(ar, ai, xr, xi, fbase, frow, g.B, g.P, a0, hi, k, pos, w);
      else
        mac_chunk<true, true>(ar, ai, xr, xi, fbase, frow, g.B, g.P, a0, hi, k, pos, w);
    } else {
      if (lo || hi)
        mac_chunk<false, false>(ar, ai, xr, xi, fbase, frow, g.B, g.P, a0, hi, k, pos, w);
      else
        mac_chunk<false, true>(ar, ai, xr, xi, fbase, frow, g.B, g.P, a0, hi, k, pos, w);
    }
  }
  if (!on) return;
#pragma unroll
  for (int u = 0; u < kWT; ++u) {
    if (u >= nu) break;
    const int i = u0 + u;
    if (k == 0) {
      ar[u] = g.dcfix[static_cast<size_t>(i) * 2 * g.C + c];
      ai[u] = g.dcfix[static_cast<size_t>(i) * 2 * g.C + g.C + c];
    }
    float* o = g.acc + (static_cast<size_t>(i) * g.C + c) * 2 * g.B + k;
    o[0] = round_to<M>(ar[u]);
    o[g.B] = round_to<M>(ai[u]);
  }
}

template <typename T>
int launch_quantize(const void* s, void* x, void* scl, int rows, int C, int B, cudaStream_t st) {
  quantize_kernel<T><<<rows, kRowThreads, 0, st>>>(static_cast<const float*>(s), static_cast<T*>(x),
                                                   static_cast<float*>(scl), C, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_writeback(const void* x, const void* scl, void* fdl, void* scales, int P, int C, int B,
                     int wc, int pos_first, cudaStream_t st) {
  const int first = wc > P ? wc - P : 0;
  writeback_kernel<T><<<(wc - first) * C, kRowThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scl), static_cast<T*>(fdl),
      static_cast<float*>(scales), P, C, B, wc, first, pos_first);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename M>
int launch_stream_mac(const MacArgs<T, M>& g, cudaStream_t st) {
  const dim3 grid((g.wc + kWT - 1) / kWT, (g.B + kMacThreads - 1) / kMacThreads, g.C);
  if (g.wtab)
    stream_mac_kernel<T, M, true><<<grid, kMacThreads, 0, st>>>(g);
  else
    stream_mac_kernel<T, M, false><<<grid, kMacThreads, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

bool bad_ring(int P, int C, int B) { return P < 1 || C < 1 || C > 65535 || B < 1; }

}  // namespace

// s [rows, 2B] f32 (rows = wc * C) -> x [wc, 2, C, B] storage dtype, scl [wc, C]
extern "C" int neo_fs_quantize(int storage, const void* s, void* x, void* scl, int rows, int C, int B,
                               void* stream) {
  if (rows < 1 || C < 1 || B < 1 || rows % C || ((storage == kInt16 || storage == kInt8) && !scl))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kSplit: return launch_quantize<float>(s, x, scl, rows, C, B, st);
    case kBf16: return launch_quantize<__nv_bfloat16>(s, x, scl, rows, C, B, st);
    case kInt16: return launch_quantize<int16_t>(s, x, scl, rows, C, B, st);
    case kInt8: return launch_quantize<int8_t>(s, x, scl, rows, C, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [wc, 2, C, B], scl [wc, C] or null -> fdl [2, P, C, B] slots (pos_first + i) % P, scales [P, C]
extern "C" int neo_fs_writeback(int storage, const void* x, const void* scl, void* fdl, void* scales,
                                int P, int C, int B, int wc, int pos_first, void* stream) {
  if (bad_ring(P, C, B) || wc < 1 || pos_first < 0 || pos_first >= P || (scl != nullptr) != (scales != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kSplit: return launch_writeback<float>(x, scl, fdl, scales, P, C, B, wc, pos_first, st);
    case kBf16: return launch_writeback<__nv_bfloat16>(x, scl, fdl, scales, P, C, B, wc, pos_first, st);
    case kInt16: return launch_writeback<int16_t>(x, scl, fdl, scales, P, C, B, wc, pos_first, st);
    case kInt8: return launch_writeback<int8_t>(x, scl, fdl, scales, P, C, B, wc, pos_first, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// c_idx, c_flags [P, L] int32 -> tab [P, nchunks] int32 live widths
extern "C" int neo_fs_widths(const void* c_idx, const void* c_flags, void* tab, int P, int L,
                             int nchunks, int B, int n_codes, void* stream) {
  if (P < 1 || L < 1 || nchunks < 1 || B < 1 || n_codes < 1) return static_cast<int>(cudaErrorInvalidValue);
  widths_kernel<<<P, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(c_idx), static_cast<const int*>(c_flags), static_cast<int*>(tab), L,
      nchunks, B, n_codes);
  return static_cast<int>(cudaGetLastError());
}

// The time-batched MAC of one window: acc [wc, C, 2B] f32, rounded to the
// matrix dtype. seed [wc, 2, C, B] and wtab [P, nchunks] may be null.
extern "C" int neo_fs_stream_mac(int storage, const void* ring, const void* scales, const void* xnew,
                                 const void* snew, const void* rim, const void* seed,
                                 const void* dcfix, const void* wtab, void* acc, int P, int C, int B,
                                 int Cf, int wc, int pos_first, int pc, int nchunks, void* stream) {
  if (bad_ring(P, C, B) || wc < 1 || (Cf != 1 && Cf != C) || pos_first < 0 || pos_first >= P ||
      (wtab && (pc < 1 || nchunks < 1 || nchunks * pc != P)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NEO_MAC(T, M)                                                                           \
  return launch_stream_mac<T, M>(                                                               \
      MacArgs<T, M>{static_cast<const T*>(ring), static_cast<const float*>(scales),             \
                    static_cast<const T*>(xnew), static_cast<const float*>(snew),               \
                    static_cast<const M*>(rim), static_cast<const float*>(seed),                \
                    static_cast<const float*>(dcfix), static_cast<const int*>(wtab),            \
                    static_cast<float*>(acc), P, C, B, Cf, wc, pos_first, pc, nchunks},         \
      st)
  switch (storage) {
    case kSplit: NEO_MAC(float, float);
    case kBf16: NEO_MAC(__nv_bfloat16, __nv_bfloat16);
    case kInt16: NEO_MAC(int16_t, float);
    case kInt8: NEO_MAC(int8_t, __nv_bfloat16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NEO_MAC
}

// One block's MAC over S splits of per slots: part [S, 2, C, K]. The
// filter: (p, c, k) at fre / fim + p * f_row + c * f_c + k; wrow [P / pc]
// or null; vec lanes a thread (1, or 16 / sizeof(storage) with K % vec == 0
// and 16-byte-aligned rows).
extern "C" int neo_fs_step_mac(int storage, const void* ring, const void* scales, const void* fre,
                               const void* fim, long long f_row, long long f_c, const void* wrow,
                               void* part, int P, int C, int K, int pc, int S, int per, int vec,
                               void* stream) {
  if (bad_ring(P, C, K) || S < 1 || S > 65535 || per < 1 || static_cast<long long>(S) * per < P ||
      (wrow && (pc < 1 || P % pc)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NEO_STEP(T, M)                                                                            \
  {                                                                                               \
    const StepArgs<T, M> g{static_cast<const T*>(ring), static_cast<const float*>(scales),       \
                           static_cast<const M*>(fre), static_cast<const M*>(fim), f_row, f_c,   \
                           static_cast<const int*>(wrow), nullptr, static_cast<float*>(part),    \
                           P, C, K, pc, per, 1, 1};                                              \
    return wrow ? launch_step_mac<T, M, kWidths>(g, S, vec, st)                              \
                : launch_step_mac<T, M, kDense>(g, S, vec, st);                               \
  }
  switch (storage) {
    case kSplit: NEO_STEP(float, float);
    case kBf16: NEO_STEP(__nv_bfloat16, __nv_bfloat16);
    case kInt16: NEO_STEP(int16_t, float);
    case kInt8: NEO_STEP(int8_t, __nv_bfloat16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NEO_STEP
}

// part [S, 2, C, K] -> acc [C, 2K] rounded to the matrix dtype (mat_bf16),
// lane 0 from dcfix [2, C] when given
extern "C" int neo_fs_step_reduce(int mat_bf16, const void* part, const void* dcfix, void* acc, int S,
                                  int C, int K, void* stream) {
  if (S < 1 || C < 1 || K < 1 || (mat_bf16 != 0 && mat_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mat_bf16 ? launch_step_reduce<__nv_bfloat16>(part, dcfix, acc, S, C, K, 2 * K, K, st)
                  : launch_step_reduce<float>(part, dcfix, acc, S, C, K, 2 * K, K, st);
}

extern "C" int neo_transform(int mat_bf16, int inverse, const void* in, int i_inner, long long i_so,
                             long long i_si, void* out, int o_inner, long long o_so, long long o_si,
                             const void* tw, int rows, int B, int n_out, void* stream);

// B2 in one call: the stage launches of one block on one stream (a block's
// device time is ~0.1 ms, so a launch per stage from the host would cost
// more than the work). frame [C, N], y [C, N]; tw the transforms' twiddles
// W_N^q [N] float2; c_idx / c_flags the [P, L] chunk tables or null. The
// wrapper allocates the staging: spec, acc [C, 2B] f32; x [2, C, B] storage
// dtype; scl [C] f32 (int storages, else null); mpart [S, 2, C, B] f32; tab
// [P, P / pc] int32 (with a schedule, else null). S / per / vec are
// step_mac's geometry. counts [7] gets one added per stage as its launch
// succeeds: window_forward, quantize_rows, ring_writeback, sched_widths,
// step_mac, step_reduce, window_inverse.
extern "C" int neo_fused_block_step(int storage, const void* frame, void* fdl, const void* rim,
                                    void* scales, const void* dcfix, const void* tw, void* y,
                                    const void* c_idx, const void* c_flags, void* spec, void* x, void* scl,
                                    void* mpart, void* acc, void* tab, int* counts, int P, int C, int B,
                                    int Cf, int pos, int L, int pc, int n_codes, int S, int per, int vec,
                                    void* stream) {
  const bool quant = storage == kInt16 || storage == kInt8;
  const bool sched = c_idx != nullptr;
  if (bad_ring(P, C, B) || pos < 0 || pos >= P || (Cf != 1 && Cf != C) || quant != (scales != nullptr) ||
      quant != (scl != nullptr) || sched != (c_flags != nullptr) || sched != (tab != nullptr) ||
      (sched && (L < 1 || pc < 1 || P % pc)) || !tw || !spec || !x || !mpart || !acc || !counts ||
      storage < kSplit || storage > kInt8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = 2 * B;
  const bool mat_bf16 = storage == kBf16 || storage == kInt8;
  const size_t msize = mat_bf16 ? 2 : 4;
  int* wtab = static_cast<int*>(tab);
  // each stage adds to its count only when its launch returned no error
  int err = 0;
  auto stage = [&](int which, int code) {
    err = code;
    if (!err) ++counts[which];
  };
  // 1. forward: row c at frame + c * N, spectrum row c at spec + c * 2B
  stage(0, neo_transform(mat_bf16, 0, frame, 1, n, 0, spec, 1, n, 0, tw, C, B, n, stream));
  // 2-3. quantize into the staged row, then insert it as ring row pos
  if (!err) stage(1, neo_fs_quantize(storage, spec, x, scl, C, C, B, stream));
  if (!err) stage(2, neo_fs_writeback(storage, x, scl, fdl, scales, P, C, B, 1, pos, stream));
  // 4. the MAC over P splits (row pos of the schedule's widths), reduced in order
  if (!err && sched) stage(3, neo_fs_widths(c_idx, c_flags, wtab, P, L, P / pc, B, n_codes, stream));
  const char* fre = static_cast<const char*>(rim) + static_cast<size_t>(P - 1 - pos) * Cf * n * msize;
  if (!err)
    stage(4, neo_fs_step_mac(storage, fdl, scales, fre, fre + B * msize, static_cast<long long>(Cf) * n,
                             Cf == 1 ? 0 : n, sched ? wtab + static_cast<size_t>(pos) * (P / pc) : nullptr,
                             mpart, P, C, B, sched ? pc : 1, S, per, vec, stream));
  if (!err) stage(5, neo_fs_step_reduce(mat_bf16, mpart, dcfix, acc, S, C, B, stream));
  // 5. inverse: all N samples of each channel
  if (!err) stage(6, neo_transform(mat_bf16, 1, acc, 1, n, 0, y, 1, n, 0, tw, C, B, n, stream));
  return err;
}
