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
// T2 neo_probe_stream replaces tools/fused_probe.py :: run_empty (body
// k_empty) and run_tf (body k_tf): B3's grid (one CTA per channel looping
// over nb blocks, B3's block size and launch bounds) and B3's own stage
// code (fused_block.cuh), in three modes:
//
//   0 empty       : out block = 0
//   1 win_fwd     : frame load + forward DFT; out = spec[:B] + spec[B:]
//   2 win_fwd_inv : frame load + forward DFT, the spectrum rounded to the
//                   matrix dtype, then B3's tail-half inverse
//
// on B3's matrix layout (cs [N, 2B], abt [2B, B]) in f32 or bf16. The
// TPU's double-buffered window DMA and its semaphores have no counterpart:
// B3 reads its frame straight from device memory, and so does T2.
#include "fused_block.cuh"

namespace {

using namespace neo;
using namespace neo::fused;

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

template <typename M>
__global__ void __launch_bounds__(kThreads, 1) stream_probe_kernel(
    const float* __restrict__ sigpad, const M* __restrict__ cs, const M* __restrict__ abt,
    float* __restrict__ out, int B, int nb, int mode) {
  __shared__ Shared sh;
  const int c = blockIdx.x;
  const size_t bb = static_cast<size_t>(B);
  const float* sig = sigpad + c * (static_cast<size_t>(nb) + 1) * bb;
  float* o = out + c * static_cast<size_t>(nb) * bb;
  for (int i = 0; i < nb; ++i) {
    float* oi = o + i * bb;
    if (mode == 0) {
      for (int t = threadIdx.x; t < B; t += kThreads) oi[t] = 0.0f;
      continue;
    }
    load_frame<M>(sh, sig + i * bb, B);
    forward_dft<M>(sh, cs, bb, 2 * bb, B);
    if (mode == 1) {
      for (int t = threadIdx.x; t < B; t += kThreads) oi[t] = sh.spec[t] + sh.spec[B + t];
      __syncthreads();  // spec is rewritten by the next block
      continue;
    }
    for (int j = threadIdx.x; j < 2 * B; j += kThreads) sh.acc[j] = round_to<M>(sh.spec[j]);
    __syncthreads();
    inverse_dft<M>(sh, abt, bb * bb, bb, oi, B, B);
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

// mat_bf16: 0 f32 matrices, 1 bf16; mode 0 empty, 1 win_fwd, 2 win_fwd_inv.
extern "C" int neo_probe_stream(int mat_bf16, int mode, const void* sigpad, const void* cs,
                                const void* abt, void* out, int C, int B, int nb, void* stream) {
  if (C < 1 || B < 2 || B > kMaxB || (B & 1) || nb < 1 || mode < 0 || mode > 2 ||
      (mat_bf16 != 0 && mat_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mat_bf16)
    stream_probe_kernel<__nv_bfloat16><<<C, kThreads, 0, s>>>(
        static_cast<const float*>(sigpad), static_cast<const __nv_bfloat16*>(cs),
        static_cast<const __nv_bfloat16*>(abt), static_cast<float*>(out), B, nb, mode);
  else
    stream_probe_kernel<float><<<C, kThreads, 0, s>>>(
        static_cast<const float*>(sigpad), static_cast<const float*>(cs),
        static_cast<const float*>(abt), static_cast<float*>(out), B, nb, mode);
  return static_cast<int>(cudaGetLastError());
}
