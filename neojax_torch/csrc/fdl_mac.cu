// B1: the FDL complex MAC-reduce, and its tile-sparse form B4, on the
// partition MAC of step_mac.cuh (which B2's step_mac runs too).
//
// Replaces neojax/kernels/fdl_mac.py :: fdl_mac_pallas (Pallas bodies
// _kernel / _kernel_quant):
//
//   acc[c, k] = sum_p fdl[p, c, k] * filt[p, c', k]      (complex)
//
// with the int8/int16 dequant x * (scale[p, c] * inv_max) fused in, in the
// Pallas kernel's order (scale * inv_max first, then x * that); and
// neojax/kernels/sparse_mac.py :: sparse_fdl_mac_pallas (body _mk_kernel):
// the same sum over the (k-tile, p-chunk) pairs of one row of the schedule,
// lanes of unvisited tiles 0.
//
// Bound on the H100: device-memory bytes. Every call reads the whole ring
// (2 * P * C * K storage elements; 252 MB split at P=960, C=64, K=512), or
// B4 its live tiles, plus the rotated filter for 8 flops per complex
// element, far below the card's flop/byte balance. The MAC runs on a (lane
// tile, channel, P split) grid, 4 lanes a thread (one 16-byte load of each
// filter plane); S > 1 splits add their partial sums in split order in a
// second launch (no atomics), S = 1 writes acc in the one launch. B4 reads
// live [P / pc, nk] (uint8, the row of the schedule's tile-live table for
// this ring position) and skips the chunks a thread's lanes never visit, in
// B1's summation order: on a masked filter B4 equals B1 bit for bit, apart
// from the sign of zero.
#include "step_mac.cuh"

namespace {

using namespace neo;

template <typename T>
int launch(const void* fdl, const void* filt_re, const void* filt_im, const void* scales, const void* live,
           void* acc, void* part, int P, int C, int K, int Cf, int pc, int k_tile, int nk, int S, int per,
           int vec, cudaStream_t st) {
  const StepArgs<T, float> g{static_cast<const T*>(fdl), static_cast<const float*>(scales),
                             static_cast<const float*>(filt_re), static_cast<const float*>(filt_im),
                             static_cast<long long>(Cf) * K, Cf == 1 ? 0 : K, nullptr,
                             static_cast<const uint8_t*>(live), static_cast<float*>(S == 1 ? acc : part),
                             P, C, K, pc, per, k_tile, nk};
  int err = live ? launch_step_mac<T, float, kTiles>(g, S, vec, st)
                 : launch_step_mac<T, float, kDense>(g, S, vec, st);
  if (!err && S > 1)
    err = launch_step_reduce<float>(part, nullptr, acc, S, C, K, K, static_cast<long long>(C) * K, st);
  return err;
}

}  // namespace

// acc [2, C, K] f32 (re plane, im plane) = the MAC of fdl [2, P, C, K] and
// the filter planes [P, Cf, K] f32, over S splits of per slots (part
// [S, 2, C, K] f32 when S > 1, else null); vec lanes a thread (1, 4 or
// 16 / sizeof(storage), K % vec == 0, ring and filter planes aligned to vec
// elements). live [P / pc, nk] uint8 (B4; k_tile % vec == 0) or null (B1).
extern "C" int neo_fdl_mac(int storage, const void* fdl, const void* filt_re, const void* filt_im,
                           const void* scales, const void* live, void* acc, void* part, int P, int C, int K,
                           int Cf, int pc, int k_tile, int nk, int S, int per, int vec, void* stream) {
  const bool quant = storage == kInt16 || storage == kInt8;
  if (P < 1 || C < 1 || K < 1 || C > 65535 || (Cf != 1 && Cf != C) || S < 1 || S > 65535 || per < 1 ||
      static_cast<long long>(S) * per < P || (S > 1) != (part != nullptr) || quant != (scales != nullptr) ||
      (live && (pc < 1 || P % pc || k_tile < 1 || k_tile % vec || nk != (K + k_tile - 1) / k_tile)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NEO_MAC(T) \
  return launch<T>(fdl, filt_re, filt_im, scales, live, acc, part, P, C, K, Cf, pc, k_tile, nk, S, per, vec, s)
  switch (storage) {
    case kSplit: NEO_MAC(float);
    case kBf16: NEO_MAC(__nv_bfloat16);
    case kInt16: NEO_MAC(int16_t);
    case kInt8: NEO_MAC(int8_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NEO_MAC
}

extern "C" const char* neo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
