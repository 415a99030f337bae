// B2 and B3: the fused per-block pipeline of the uniformly-partitioned
// convolver (packed-512 layout, ring FDL).
//
// Replaces neojax/kernels/fused_step.py :: fused_block_step (Pallas body
// _mk_kernel) and :: fused_stream (Pallas body _mk_stream_kernel). Per block
// and channel:
//
//   1. frame -> shared memory (rounded to the matrix dtype)
//   2. forward packed DFT: a GEMV against the packed matrices, f32 sums
//   3. quantize (per-channel peak scale, rint = round half to even, op order
//      x / scale * int_max, clamp) or cast
//   4. ring-row insert at pos, in place (+ scales[pos, c])
//   5. MAC over P against the rotated filter rows filt_rim[P-1-pos + p];
//      slot pos is read back after the barrier, so it holds the NEW row and
//      scale. B3 may seed the accumulator from acc_add[i] (the hybrid
//      engine's chunk-rate tail sum, linearity of the partition sum); the
//      seed is taken before the MAC, as in the Pallas kernel. With a chunk
//      schedule (sparse filters) the MAC visits only the chunks of the
//      current position's row, each over its live lane prefix; the row and
//      scale are inserted whether or not their chunk is visited
//      (the TPU kernels' pre-paired rows and counts only fed their SMEM
//      prefetch, so the full tables are passed and indexed here)
//   6. lane 0 := the exact DC/Nyquist values (dcfix), after the MAC, so it
//      also overwrites the seed's lane 0 (the hybrid folds the tail's exact
//      DC/Nyquist into dcfix; the im-plane lane 0 holds Nyquist.re)
//   7. inverse packed DFT of the accumulator (rounded to the matrix dtype):
//      all N samples (B2) or only the UPOLS tail half (B3)
//
// One __device__ routine (channel_block) does one channel's block, as the
// stages of fused_block.cuh (shared with the T2 probes of probes.cu); two
// __global__ entry points use it. ONE CTA OWNS ONE CHANNEL — for B3 for all
// nb blocks. Channels are independent for the whole stream (per-channel
// scale and dcfix, read-only filter), so the CTA that writes a ring row is
// the only one that ever reads it, after __syncthreads(): no grid-wide sync.
// The row write of block i is separated from block i+1's MAC by a barrier,
// and block i's MAC from block i+1's row write, so there is no buffer race
// (the TPU kernel's 2-ahead prefetch into 2 slots is not carried over).
//
// Bound on the H100: bytes. Per block, each CTA reads its channel's ring
// slice (2 * P * B storage elements; 3.9 MB split at P=960, B=512) and the
// rotated filter rows (shared by all channels through L2), and re-reads the
// DFT matrices from L2 (4 MB forward + 2 MB tail inverse in f32).
// Known costs left for later work:
//   - B3 fills only C CTAs (64 of the 132 SMs at the headline config);
//   - every CTA re-reads the 4 MB f32 forward DFT matrix from L2 every block;
//     batching the channels into one tensor-core product removes that.
// Shared memory is static (about 25 KB at B <= 1024). The launch bounds
// name one CTA per SM (the grid is C CTAs, fewer than the SMs): without
// the minimum, ptxas held these kernels to 64 registers and spilled once the
// schedule loop was added; with it they take 86-96 and do not spill.
#include "fused_block.cuh"

namespace {

using namespace neo;
using namespace neo::fused;

// One channel's block: the stages of fused_block.cuh, in order.
template <typename T, typename M>
__device__ __forceinline__ void channel_block(
    Shared& sh, const float* __restrict__ frame_src, T* fdl, const M* __restrict__ rim,
    float* scales, float dc_fix, float ny_fix, const float* __restrict__ seed,
    const M* __restrict__ fwd, size_t fwd_plane, size_t fwd_row,
    const M* __restrict__ inv, size_t inv_plane, size_t inv_row,
    float* __restrict__ out, int n_out, int P, int C, int B, int Cf, int c, int pos,
    const Sched& sd) {
  load_frame<M>(sh, frame_src, B);
  forward_dft<M>(sh, fwd, fwd_plane, fwd_row, B);
  insert_row<T>(sh, fdl, scales, P, C, B, c, pos);
  mac<T, M>(sh, fdl, rim, scales, dc_fix, ny_fix, seed, P, C, B, Cf, c, pos, sd);
  inverse_dft<M>(sh, inv, inv_plane, inv_row, out, n_out, B);
}

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads, 1) fused_block_step_kernel(
    const float* __restrict__ frame, T* fdl, const M* __restrict__ rim, float* scales,
    const float* __restrict__ dcfix, const M* __restrict__ cs, const M* __restrict__ ab,
    float* __restrict__ y, Sched sd, int P, int C, int B, int Cf, int pos) {
  __shared__ Shared sh;
  const int c = blockIdx.x;
  const size_t n = 2 * static_cast<size_t>(B);
  channel_block<T, M>(sh, frame + c * n, fdl, rim, scales, dcfix[c], dcfix[C + c], nullptr,
                      cs, n * B, B, ab, B * n, n, y + c * n, static_cast<int>(n),
                      P, C, B, Cf, c, pos, sd);
}

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads, 1) fused_stream_kernel(
    const float* __restrict__ sigpad, T* fdl, const M* __restrict__ rim, float* scales,
    const float* __restrict__ dcfix_all, const float* __restrict__ acc_add,
    const M* __restrict__ cs, const M* __restrict__ abt,
    float* __restrict__ out, Sched sd, int P, int C, int B, int Cf, int nb, int pos0) {
  __shared__ Shared sh;
  const int c = blockIdx.x;
  const size_t bb = static_cast<size_t>(B);
  const float* sig = sigpad + c * (static_cast<size_t>(nb) + 1) * bb;
  float* o = out + c * static_cast<size_t>(nb) * bb;
  for (int i = 0; i < nb; ++i) {
    const int pos = (pos0 + i) % P;
    const float* dcf = dcfix_all + static_cast<size_t>(i) * 2 * C;
    const float* seed = acc_add ? acc_add + static_cast<size_t>(i) * 2 * C * bb : nullptr;
    channel_block<T, M>(sh, sig + i * bb, fdl, rim, scales, dcf[c], dcf[C + c], seed,
                        cs, bb, 2 * bb, abt, bb * bb, bb, o + i * bb, B,
                        P, C, B, Cf, c, pos, sd);
  }
}

bool bad_shape(int P, int C, int B, int Cf, const Sched& sd) {
  return P < 1 || C < 1 || B < 2 || B > kMaxB || (B & 1) || (Cf != 1 && Cf != C) ||
         (sd.c != nullptr) != (sd.f != nullptr) || (sd.c && (sd.L < 1 || sd.pc < 1 || P % sd.pc));
}

template <typename T, typename M>
int launch_step(const void* frame, void* fdl, const void* rim, void* scales, const void* dcfix,
                const void* cs, const void* ab, void* y, const Sched& sd, int P, int C, int B,
                int Cf, int pos, cudaStream_t s) {
  fused_block_step_kernel<T, M><<<C, kThreads, 0, s>>>(
      static_cast<const float*>(frame), static_cast<T*>(fdl), static_cast<const M*>(rim),
      static_cast<float*>(scales), static_cast<const float*>(dcfix),
      static_cast<const M*>(cs), static_cast<const M*>(ab), static_cast<float*>(y), sd,
      P, C, B, Cf, pos);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename M>
int launch_stream(const void* sigpad, void* fdl, const void* rim, void* scales,
                  const void* dcfix_all, const void* acc_add, const void* cs, const void* abt,
                  void* out, const Sched& sd, int P, int C, int B, int Cf, int nb, int pos0,
                  cudaStream_t s) {
  fused_stream_kernel<T, M><<<C, kThreads, 0, s>>>(
      static_cast<const float*>(sigpad), static_cast<T*>(fdl), static_cast<const M*>(rim),
      static_cast<float*>(scales), static_cast<const float*>(dcfix_all),
      static_cast<const float*>(acc_add), static_cast<const M*>(cs),
      static_cast<const M*>(abt), static_cast<float*>(out), sd, P, C, B, Cf, nb, pos0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c_idx / c_flags: the full [P, L] int32 chunk-schedule tables on the
// device, or null for the dense schedule; pc rows a chunk; n_codes =
// len(lane_widths(B)).
extern "C" int neo_fused_block_step(int storage, const void* frame, void* fdl, const void* rim,
                                    void* scales, const void* dcfix, const void* cs,
                                    const void* ab, void* y, const void* c_idx,
                                    const void* c_flags, int P, int C, int B, int Cf, int pos,
                                    int L, int pc, int n_codes, void* stream) {
  const Sched sd{static_cast<const int*>(c_idx), static_cast<const int*>(c_flags), L, pc, n_codes};
  if (bad_shape(P, C, B, Cf, sd) || pos < 0 || pos >= P)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case neo::kSplit:
      return launch_step<float, float>(frame, fdl, rim, scales, dcfix, cs, ab, y, sd,
                                       P, C, B, Cf, pos, s);
    case neo::kBf16:
      return launch_step<__nv_bfloat16, __nv_bfloat16>(frame, fdl, rim, scales, dcfix, cs, ab, y,
                                                       sd, P, C, B, Cf, pos, s);
    case neo::kInt16:
      return launch_step<int16_t, float>(frame, fdl, rim, scales, dcfix, cs, ab, y, sd,
                                         P, C, B, Cf, pos, s);
    case neo::kInt8:
      return launch_step<int8_t, __nv_bfloat16>(frame, fdl, rim, scales, dcfix, cs, ab, y, sd,
                                                P, C, B, Cf, pos, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int neo_fused_stream(int storage, const void* sigpad, void* fdl, const void* rim,
                                void* scales, const void* dcfix_all, const void* acc_add,
                                const void* cs, const void* abt, void* out, const void* c_idx,
                                const void* c_flags, int P, int C, int B, int Cf, int nb,
                                int pos0, int L, int pc, int n_codes, void* stream) {
  const Sched sd{static_cast<const int*>(c_idx), static_cast<const int*>(c_flags), L, pc, n_codes};
  if (bad_shape(P, C, B, Cf, sd) || nb < 1 || pos0 < 0 || pos0 >= P)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case neo::kSplit:
      return launch_stream<float, float>(sigpad, fdl, rim, scales, dcfix_all, acc_add, cs, abt,
                                         out, sd, P, C, B, Cf, nb, pos0, s);
    case neo::kBf16:
      return launch_stream<__nv_bfloat16, __nv_bfloat16>(sigpad, fdl, rim, scales, dcfix_all,
                                                         acc_add, cs, abt, out, sd, P, C, B, Cf,
                                                         nb, pos0, s);
    case neo::kInt16:
      return launch_stream<int16_t, float>(sigpad, fdl, rim, scales, dcfix_all, acc_add, cs, abt,
                                           out, sd, P, C, B, Cf, nb, pos0, s);
    case neo::kInt8:
      return launch_stream<int8_t, __nv_bfloat16>(sigpad, fdl, rim, scales, dcfix_all, acc_add,
                                                  cs, abt, out, sd, P, C, B, Cf, nb, pos0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
