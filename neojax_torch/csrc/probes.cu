// Measurement probes T1 and T2: B1's ring read and B3's partial pipelines.
//
// T1 neo_probe_ring_read replaces tools/roofline_cal.py :: dma_only (Pallas
// body _stripped): B1's read of the ring with its compute stripped. It runs
// on B1's grid ((K / 128) k-tiles x C channels, one thread per lane, the P
// loop in registers), so its time is B1's read time. It loads every
// element of both planes of all P rows:
//
//   out0[c, k] = sum_j fdl[0, j*pc, c, k] * fr[j*pc, k]     (j < P / pc)
//   out1[c, k] = sum of every other loaded element of (c, k): all of
//                plane 1 and the rows of plane 0 that are not chunk heads
//
// out0 is the TPU probe's function at choose_chunks' geometry (pc rows a
// chunk); out1 keeps the compiler from eliding a load and lets both be
// checked. Bound: bytes (the ring, 252 MB f32 at [2, 960, 64, 512]).
//
// T2 replaces tools/fused_probe.py :: run_empty (body k_empty) and run_tf
// (body k_tf): B3's partial pipelines. Since B3 runs as stage kernels
// (fused_step.cu, transform.cu), T2 runs B3's own stages up to a point
// (kernels/probes.py :: probe_stream): "win_fwd" is B3's windowed forward
// product followed by neo_probe_fold's fold, "win_fwd_inv" is the forward
// and then B3's inverse product; "empty" is neo_probe_fold's zero fill of
// the output, the floor of one launch.
#include "common.cuh"

namespace {

using namespace neo;

constexpr int kReadThreads = 128;  // B1's CTA width (fdl_mac.cu)

template <typename T>
__global__ void __launch_bounds__(kReadThreads) ring_read_kernel(
    const T* __restrict__ fdl, const float* __restrict__ fr, float* __restrict__ out0,
    float* __restrict__ out1, int P, int C, int K, int pc) {
  const int k = blockIdx.x * kReadThreads + threadIdx.x;
  const int c = blockIdx.y;
  if (k >= K) return;
  const size_t row = static_cast<size_t>(C) * K;
  const size_t plane = static_cast<size_t>(P) * row;
  const T* xr = fdl + static_cast<size_t>(c) * K + k;
  const T* xi = xr + plane;
  const float* f = fr + k;
  float a0 = 0.0f, a1 = 0.0f;
  for (int p0 = 0; p0 < P; p0 += pc) {
    a0 += to_f32(xr[p0 * row]) * f[static_cast<size_t>(p0) * K];
    a1 += to_f32(xi[p0 * row]);
#pragma unroll 4
    for (int p = p0 + 1; p < p0 + pc; ++p) a1 += to_f32(xr[p * row]) + to_f32(xi[p * row]);
  }
  out0[static_cast<size_t>(c) * K + k] = a0;
  out1[static_cast<size_t>(c) * K + k] = a1;
}

constexpr int kFoldThreads = 256;

// mode 0: out [C, nb * B] = 0. mode 1: out[c, (i0 + i) * B + k] = spec[i, c, k]
// + spec[i, c, B + k] for the wc blocks of a window's spectra [wc, C, 2B].
__global__ void __launch_bounds__(kFoldThreads) fold_kernel(const float* __restrict__ spec,
                                                            float* __restrict__ out, int C, int B,
                                                            int nb, int wc, int i0, int mode) {
  const size_t n = static_cast<size_t>(C) * (mode ? wc : nb) * B;
  for (size_t e = blockIdx.x * static_cast<size_t>(kFoldThreads) + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * kFoldThreads) {
    if (mode == 0) {
      out[e] = 0.0f;
      continue;
    }
    const int k = static_cast<int>(e % B);
    const size_t r = e / B;  // i * C + c
    const int c = static_cast<int>(r % C), i = static_cast<int>(r / C);
    const float* sp = spec + r * 2 * B;
    out[(static_cast<size_t>(c) * nb + i0 + i) * B + k] = sp[k] + sp[B + k];
  }
}

}  // namespace

// storage: 0 split (f32 ring) or 1 bf16; fr [P, K] f32; pc divides P.
extern "C" int neo_probe_ring_read(int storage, const void* fdl, const void* fr, void* out0,
                                   void* out1, int P, int C, int K, int pc, void* stream) {
  if (P < 1 || C < 1 || K < 1 || C > 65535 || pc < 1 || P % pc)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((K + kReadThreads - 1) / kReadThreads, C);
  switch (storage) {
    case kSplit:
      ring_read_kernel<float><<<grid, kReadThreads, 0, s>>>(
          static_cast<const float*>(fdl), static_cast<const float*>(fr),
          static_cast<float*>(out0), static_cast<float*>(out1), P, C, K, pc);
      break;
    case kBf16:
      ring_read_kernel<__nv_bfloat16><<<grid, kReadThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(fdl), static_cast<const float*>(fr),
          static_cast<float*>(out0), static_cast<float*>(out1), P, C, K, pc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// mode 0: zero out [C, nb * B]; mode 1: fold spec [wc, C, 2B] into blocks
// i0 .. i0 + wc - 1 of out.
extern "C" int neo_probe_fold(int mode, const void* spec, void* out, int C, int B, int nb, int wc,
                              int i0, void* stream) {
  if (C < 1 || B < 1 || nb < 1 || (mode != 0 && mode != 1) ||
      (mode == 1 && (wc < 1 || i0 < 0 || i0 + wc > nb || spec == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(C) * (mode ? wc : nb) * B;
  const size_t want = (n + kFoldThreads - 1) / kFoldThreads;
  fold_kernel<<<static_cast<int>(want < 4096 ? want : 4096), kFoldThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(spec),
                                                     static_cast<float*>(out), C, B, nb, wc, i0, mode);
  return static_cast<int>(cudaGetLastError());
}
