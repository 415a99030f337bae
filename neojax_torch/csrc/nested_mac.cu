// B5: the nested (meta-FDL) partition MAC with fused group dequantization.
//
// Replaces neojax/kernels/nested_mac.py :: nested_mac_pallas (Pallas body
// _kernel), used by conv.nested.process_nested and by the hybrid engine's
// chunk-rate tail (process_hybrid, HybridStream._tail_step):
//
//   acc[c, k, m] = sum_p2 dq(x[p2, c, k, m]) * filt[p2, k, m]      (complex)
//
// over split-complex planes [2, P2, C, K, L] (L = 2S meta-bins), with
// dq(x) = x * (scale[p2, c, k, m / (L/G)] * inv_max) for int8/int16 and the
// identity for f32/bf16. The dequant keeps the Pallas kernel's order: the
// scale times inv_max first, then x times that. On the TPU the G group
// scales were lane-expanded by a one-hot matmul; here each thread indexes
// its group directly. The filter is shared across channels and arrives
// already ring-rotated ([P2, K, L], a contiguous view of the tiled filter).
//
// Bound on the H100: device-memory bytes. Each chunk reads the whole meta
// ring once: at the headline nested int8 config (P2 = 8, C = 64, K = 513,
// L = 256, G = 64) 134 MB of planes + 67 MB of group scales + 8.4 MB of
// rotated filter (the P2 rows of both planes; the tiled copy in memory is
// twice that), for 8 flops per complex element. The loop over P2 is the
// only stream and nothing in it is reused, so the kernel should sit near
// the HBM rate once enough loads are in flight; whether it does is a card
// measurement.
//
// Design: one thread per output element (c, k, m), m fastest, so plane,
// filter and scale reads coalesce along L; the P2 reduction runs in f32
// registers (no atomics, no partial sums in memory); the storage dtype is
// read as stored.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) nested_mac_kernel(
    const T* __restrict__ planes, const float* __restrict__ scales,
    const float* __restrict__ filt_re, const float* __restrict__ filt_im,
    float* __restrict__ acc_re, float* __restrict__ acc_im,
    int P2, int C, int K, int L, int G) {
  constexpr bool kQuant = neo::Traits<T>::kQuant;
  constexpr float kInvMax = 1.0f / neo::Traits<T>::kIntMax;
  const size_t total = static_cast<size_t>(C) * K * L;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int m = static_cast<int>(idx % L);
  const size_t ck = idx / L;  // c * K + k
  const int k = static_cast<int>(ck % K);
  const size_t row = total;                          // plane elements per p2
  const size_t plane = static_cast<size_t>(P2) * row;
  const size_t frow = static_cast<size_t>(K) * L;    // filter elements per p2
  const T* xr = planes + idx;
  const T* xi = xr + plane;
  const float* fr = filt_re + static_cast<size_t>(k) * L + m;
  const float* fi = filt_im + static_cast<size_t>(k) * L + m;
  const float* sc = kQuant ? scales + ck * G + m / (L / G) : nullptr;
  const size_t srow = static_cast<size_t>(C) * K * G;  // scale elements per p2
  float ar = 0.0f, ai = 0.0f;
#pragma unroll 4
  for (int p = 0; p < P2; ++p) {
    float r = neo::to_f32(xr[p * row]);
    float i = neo::to_f32(xi[p * row]);
    if (kQuant) {
      const float s = sc[p * srow] * kInvMax;
      r *= s;
      i *= s;
    }
    const float a = fr[p * frow];
    const float b = fi[p * frow];
    ar += r * a - i * b;
    ai += r * b + i * a;
  }
  acc_re[idx] = ar;
  acc_im[idx] = ai;
}

template <typename T>
int launch(const void* planes, const void* scales, const void* filt_re, const void* filt_im,
           void* acc_re, void* acc_im, int P2, int C, int K, int L, int G, cudaStream_t s) {
  const size_t total = static_cast<size_t>(C) * K * L;
  const unsigned grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  nested_mac_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(planes), static_cast<const float*>(scales),
      static_cast<const float*>(filt_re), static_cast<const float*>(filt_im),
      static_cast<float*>(acc_re), static_cast<float*>(acc_im), P2, C, K, L, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int neo_nested_mac(int storage, const void* planes, const void* scales,
                              const void* filt_re, const void* filt_im, void* acc_re,
                              void* acc_im, int P2, int C, int K, int L, int G, void* stream) {
  const bool quant = storage == neo::kInt16 || storage == neo::kInt8;
  if (P2 < 1 || C < 1 || K < 1 || L < 1 || G < 1 || L % G ||
      static_cast<size_t>(C) * K * L > (static_cast<size_t>(kThreads) << 31) ||
      (quant && scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case neo::kSplit:
      return launch<float>(planes, scales, filt_re, filt_im, acc_re, acc_im, P2, C, K, L, G, s);
    case neo::kBf16:
      return launch<__nv_bfloat16>(planes, scales, filt_re, filt_im, acc_re, acc_im, P2, C, K, L, G, s);
    case neo::kInt16:
      return launch<int16_t>(planes, scales, filt_re, filt_im, acc_re, acc_im, P2, C, K, L, G, s);
    case neo::kInt8:
      return launch<int8_t>(planes, scales, filt_re, filt_im, acc_re, acc_im, P2, C, K, L, G, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
