// B4: the tile-sparse FDL complex MAC-reduce (B1 over a schedule row).
//
// Replaces neojax/kernels/sparse_mac.py :: sparse_fdl_mac_pallas (Pallas
// body _mk_kernel):
//
//   acc[c, k] = sum over the (k-tile, p-chunk) pairs of row pos of the
//               schedule whose k-tile holds k, of
//               sum_{p in chunk} fdl[p, c, k] * filt[p, c', k]   (complex)
//
// The schedule (build_sparse_schedule) lists, for every ring position, the
// active (k_idx, p_idx) pairs of the rotated masked filter, k-major with
// the chunks ascending, padded with flag-0 entries. The wrapper passes the
// row of the current position (three [L] int32 pointers into the [P, L]
// tables on the device), so no table is copied to the host.
//
// Design: B1's (one thread per output lane, a grid of (lane blocks,
// channels), the partition sum in registers, the storage dtype read as
// stored, int dequant x * (scale[p, c] * inv_max) in the Pallas order). A
// CTA covers kThreads lanes, which may be part of a k-tile or straddle two
// (k_tile is the schedule's lookup width, not the CTA's): each thread
// looks up its own tile, k / k_tile. For each flag-1 entry of that tile it
// loops the chunk's pc rows in ascending order, so over a masked filter the
// sum equals B1's bit for bit apart from the sign of zero (every skipped
// product is an exact zero). Lanes in tiles the row never visits are
// written 0; lanes >= K (a ragged last tile, K = B+1 = 513) are not
// written.
//
// Bytes: only the active tiles' ring and filter rows are read — about the
// tile density of B1's (0.31 of 252 MB at the band30 mask, split, P = 960,
// C = 64, K = 512). Like B1 it is latency-bound while each thread has one
// load in flight.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads) sparse_fdl_mac_kernel(
    const T* __restrict__ fdl, const float* __restrict__ filt_re,
    const float* __restrict__ filt_im, const float* __restrict__ scales,
    const int* __restrict__ k_row, const int* __restrict__ p_row, const int* __restrict__ f_row,
    float* __restrict__ acc_re, float* __restrict__ acc_im,
    int P, int C, int K, int Cf, int L, int pc, int k_tile) {
  constexpr bool kQuant = neo::Traits<T>::kQuant;
  constexpr float kInvMax = 1.0f / neo::Traits<T>::kIntMax;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y;
  if (k >= K) return;
  const int tile = k / k_tile;
  const size_t row = static_cast<size_t>(C) * K;  // ring elements per partition
  const size_t plane = static_cast<size_t>(P) * row;
  const size_t frow = static_cast<size_t>(Cf) * K;
  const int fc = Cf == 1 ? 0 : c;
  const T* xr = fdl + static_cast<size_t>(c) * K + k;
  const T* xi = xr + plane;
  const float* fr = filt_re + static_cast<size_t>(fc) * K + k;
  const float* fi = filt_im + static_cast<size_t>(fc) * K + k;
  float ar = 0.0f, ai = 0.0f;
  for (int j = 0; j < L; ++j) {
    if (f_row[j] != 1 || k_row[j] != tile) continue;
    const int p0 = p_row[j] * pc;
#pragma unroll 4
    for (int p = p0; p < p0 + pc; ++p) {
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
  }
  acc_re[static_cast<size_t>(c) * K + k] = ar;
  acc_im[static_cast<size_t>(c) * K + k] = ai;
}

template <typename T>
int launch(const void* fdl, const void* filt_re, const void* filt_im, const void* scales,
           const void* k_row, const void* p_row, const void* f_row, void* acc_re, void* acc_im,
           int P, int C, int K, int Cf, int L, int pc, int k_tile, cudaStream_t stream) {
  const dim3 grid((K + kThreads - 1) / kThreads, C);
  sparse_fdl_mac_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(fdl), static_cast<const float*>(filt_re),
      static_cast<const float*>(filt_im), static_cast<const float*>(scales),
      static_cast<const int*>(k_row), static_cast<const int*>(p_row),
      static_cast<const int*>(f_row), static_cast<float*>(acc_re), static_cast<float*>(acc_im),
      P, C, K, Cf, L, pc, k_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int neo_sparse_fdl_mac(int storage, const void* fdl, const void* filt_re,
                                  const void* filt_im, const void* scales, const void* k_row,
                                  const void* p_row, const void* f_row, void* acc_re,
                                  void* acc_im, int P, int C, int K, int Cf, int L, int pc,
                                  int k_tile, void* stream) {
  if (P < 1 || C < 1 || K < 1 || C > 65535 || (Cf != 1 && Cf != C) || L < 1 || pc < 1 ||
      P % pc || k_tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case neo::kSplit:
      return launch<float>(fdl, filt_re, filt_im, scales, k_row, p_row, f_row, acc_re, acc_im,
                           P, C, K, Cf, L, pc, k_tile, s);
    case neo::kBf16:
      return launch<__nv_bfloat16>(fdl, filt_re, filt_im, scales, k_row, p_row, f_row, acc_re,
                                   acc_im, P, C, K, Cf, L, pc, k_tile, s);
    case neo::kInt16:
      return launch<int16_t>(fdl, filt_re, filt_im, scales, k_row, p_row, f_row, acc_re, acc_im,
                             P, C, K, Cf, L, pc, k_tile, s);
    case neo::kInt8:
      return launch<int8_t>(fdl, filt_re, filt_im, scales, k_row, p_row, f_row, acc_re, acc_im,
                            P, C, K, Cf, L, pc, k_tile, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
