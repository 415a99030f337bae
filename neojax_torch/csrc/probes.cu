// Measurement probes T1 and T2: B1's ring read and B3's partial pipelines.
//
// T1 neo_probe_ring_read replaces tools/roofline_cal.py :: dma_only (line
// 143; Pallas body _stripped): B1's read of the ring with its compute
// stripped. It loads every element of both planes of all P rows:
//
//   out0[c, k] = sum_j fdl[0, j*pc, c, k] * fr[j*pc, k]     (j < P / pc)
//   out1[c, k] = sum of every other loaded element of (c, k): all of
//                plane 1 and the rows of plane 0 that are not chunk heads
//
// out0 is the TPU probe's function at choose_chunks' geometry (pc rows a
// chunk); out1 keeps the compiler from eliding a load and lets both be
// checked. Its grid is B1's by construction: it is step_mac.cuh's
// partition MAC in its kProbe mode, at the (S splits, slots a split, V
// lanes a thread) that kernels.fdl_mac.mac_geometry gives B1 on the same
// ring and filter (kernels/probes.py :: ring_read_geometry): the same
// (lane tile, channel, P split) grid and CTAs, the same vector loads of the
// ring, and with S > 1 the splits' partial (out0, out1) added in split
// order by step_reduce_kernel (no atomics). Bound: bytes, the ring read
// once (252.0 MB split, 126.1 MB bf16 at [2, 960, 64, 512]: 0.0752 /
// 0.0377 ms at 3.35 TB/s, bench.headline.ring_read_work).
//
// T2 replaces tools/fused_probe.py :: run_empty (body k_empty) and run_tf
// (body k_tf): B3's partial pipelines. Since B3 runs as stage kernels
// (fused_step.cu, transform.cu), T2 runs B3's own stages up to a point
// (kernels/probes.py :: probe_stream): "win_fwd" is B3's windowed forward
// product followed by neo_probe_fold's fold, "win_fwd_inv" is the forward
// and then B3's inverse product; "empty" is neo_probe_fold's zero fill of
// the output, the floor of one launch.
#include "step_mac.cuh"

namespace {

using namespace neo;

template <typename T>
int ring_read(const void* fdl, const void* fr, void* out, void* part, int P, int C, int K, int pc, int S,
              int per, int vec, cudaStream_t st) {
  const float* f = static_cast<const float*>(fr);
  const StepArgs<T, float> g{static_cast<const T*>(fdl), nullptr, f, f, K, 0, nullptr, nullptr,
                             static_cast<float*>(S == 1 ? out : part), P, C, K, pc, per, 1, 1};
  int err = launch_step_mac<T, float, kProbe>(g, S, vec, st);
  if (!err && S > 1)
    err = launch_step_reduce<float>(part, nullptr, out, S, C, K, K, static_cast<long long>(C) * K, st);
  return err;
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

// out [2, C, K] f32 (out0, out1) of fdl [2, P, C, K] (storage 0 split: f32,
// 1 bf16) and fr [P, K] f32; pc divides P; S splits of per slots (part
// [S, 2, C, K] f32 when S > 1, else null); vec lanes a thread (1 or 4,
// K % vec == 0, ring and fr aligned to vec elements).
extern "C" int neo_probe_ring_read(int storage, const void* fdl, const void* fr, void* out, void* part,
                                   int P, int C, int K, int pc, int S, int per, int vec, void* stream) {
  if (P < 1 || C < 1 || K < 1 || C > 65535 || pc < 1 || P % pc || S < 1 || S > 65535 || per < 1 ||
      static_cast<long long>(S) * per < P || (S > 1) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kSplit: return ring_read<float>(fdl, fr, out, part, P, C, K, pc, S, per, vec, s);
    case kBf16: return ring_read<__nv_bfloat16>(fdl, fr, out, part, P, C, K, pc, S, per, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
