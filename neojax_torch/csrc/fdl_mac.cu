// B1: the FDL complex MAC-reduce, split-complex planes, f32 accumulation.
//
// Replaces neojax/kernels/fdl_mac.py :: fdl_mac_pallas (Pallas bodies
// _kernel / _kernel_quant):
//
//   acc[c, k] = sum_p fdl[p, c, k] * filt[p, c', k]      (complex)
//
// with the int8/int16 dequant x * (scale[p, c] * inv_max) fused in, in the
// Pallas kernel's order (scale * inv_max first, then x * that).
//
// Bound on the H100: device-memory bytes. Every call reads the whole ring
// (2 * P * C * K storage elements; 252 MB split at P=960, C=64, K=512) plus
// the rotated filter for 8 flops per complex element, far below the
// card's flop/byte balance. Design: one thread per output lane (loads
// coalesced along k), a grid of (k-tiles, channels), and the P reduction
// in registers — no cross-CTA atomics and no partial sums in memory. The
// storage dtype is read as stored, so narrower rings move fewer bytes.
// No divisibility requirement on P.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads) fdl_mac_kernel(
    const T* __restrict__ fdl, const float* __restrict__ filt_re,
    const float* __restrict__ filt_im, const float* __restrict__ scales,
    float* __restrict__ acc_re, float* __restrict__ acc_im,
    int P, int C, int K, int Cf) {
  constexpr bool kQuant = neo::Traits<T>::kQuant;
  constexpr float kInvMax = 1.0f / neo::Traits<T>::kIntMax;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y;
  if (k >= K) return;
  const size_t row = static_cast<size_t>(C) * K;  // ring elements per partition
  const size_t plane = static_cast<size_t>(P) * row;
  const size_t frow = static_cast<size_t>(Cf) * K;
  const int fc = Cf == 1 ? 0 : c;
  const T* xr = fdl + static_cast<size_t>(c) * K + k;
  const T* xi = xr + plane;
  const float* fr = filt_re + static_cast<size_t>(fc) * K + k;
  const float* fi = filt_im + static_cast<size_t>(fc) * K + k;
  float ar = 0.0f, ai = 0.0f;
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    float r = neo::to_f32(xr[p * row]);
    float i = neo::to_f32(xi[p * row]);
    if (kQuant) {
      const float s = scales[static_cast<size_t>(p) * C + c] * kInvMax;
      r *= s;
      i *= s;
    }
    const float a = fr[p * frow];
    const float b = fi[p * frow];
    ar += r * a - i * b;
    ai += r * b + i * a;
  }
  acc_re[static_cast<size_t>(c) * K + k] = ar;
  acc_im[static_cast<size_t>(c) * K + k] = ai;
}

template <typename T>
int launch(const void* fdl, const void* filt_re, const void* filt_im, const void* scales,
           void* acc_re, void* acc_im, int P, int C, int K, int Cf, cudaStream_t stream) {
  const dim3 grid((K + kThreads - 1) / kThreads, C);
  fdl_mac_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(fdl), static_cast<const float*>(filt_re),
      static_cast<const float*>(filt_im), static_cast<const float*>(scales),
      static_cast<float*>(acc_re), static_cast<float*>(acc_im), P, C, K, Cf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int neo_fdl_mac(int storage, const void* fdl, const void* filt_re,
                           const void* filt_im, const void* scales, void* acc_re,
                           void* acc_im, int P, int C, int K, int Cf, void* stream) {
  if (P < 1 || C < 1 || K < 1 || C > 65535 || (Cf != 1 && Cf != C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case neo::kSplit:
      return launch<float>(fdl, filt_re, filt_im, scales, acc_re, acc_im, P, C, K, Cf, s);
    case neo::kBf16:
      return launch<__nv_bfloat16>(fdl, filt_re, filt_im, scales, acc_re, acc_im, P, C, K, Cf, s);
    case neo::kInt16:
      return launch<int16_t>(fdl, filt_re, filt_im, scales, acc_re, acc_im, P, C, K, Cf, s);
    case neo::kInt8:
      return launch<int8_t>(fdl, filt_re, filt_im, scales, acc_re, acc_im, P, C, K, Cf, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* neo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
