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
// One __device__ routine (channel_block) does one channel's block; two
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
#include "common.cuh"

namespace {

using namespace neo;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 1024;
constexpr int kPer = 2 * kMaxB / kThreads;  // outputs per thread of a 2B-wide loop

// The chunk schedule (build_chunk_schedule): the full [P, L] int32 tables
// c_idx (chunk | width code << 16) and flags, or c == nullptr for the dense
// loop; pc rows a chunk; codes >= n_codes mean full width.
struct Sched {
  const int* c;
  const int* f;
  int L, pc, n_codes;
};

struct Shared {
  float frame[2 * kMaxB];  // N frame samples, matrix-dtype rounded
  float spec[2 * kMaxB];   // [re | im] packed spectrum
  float acc[2 * kMaxB];    // [re | im] accumulator, matrix-dtype rounded
  float red[kWarps];
  float scale;
};

// Matrices are addressed as element (plane, r, col) at
//   base[plane * plane_stride + r * row_stride + col]
// which covers both kernels' layouts:
//   B2  cs [2, N, B]  -> (N*B, B)     ab  [2, B, N] -> (B*N, N)
//   B3  cs [N, 2B]    -> (B, 2B)      abt [2B, B]   -> (B*B, B)
template <typename T, typename M>
__device__ __forceinline__ void channel_block(
    Shared& sh, const float* __restrict__ frame_src, T* fdl, const M* __restrict__ rim,
    float* scales, float dc_fix, float ny_fix, const float* __restrict__ seed,
    const M* __restrict__ fwd, size_t fwd_plane, size_t fwd_row,
    const M* __restrict__ inv, size_t inv_plane, size_t inv_row,
    float* __restrict__ out, int n_out, int P, int C, int B, int Cf, int c, int pos,
    const Sched& sd) {
  constexpr bool kQuant = Traits<T>::kQuant;
  constexpr float kIntMax = Traits<T>::kIntMax;
  constexpr float kInvMax = 1.0f / Traits<T>::kIntMax;
  const int tid = threadIdx.x;
  const int n = 2 * B;
  const int w = 2 * B;  // packed spectrum width [re | im]

  // 1. frame, rounded to the matrix dtype
  for (int t = tid; t < n; t += kThreads) sh.frame[t] = round_to<M>(frame_src[t]);
  __syncthreads();

  // 2. forward packed DFT: spec[j] = sum_t frame[t] * fwd(j / B, t, j % B)
  {
    const int nu = tid < w ? (w - tid + kThreads - 1) / kThreads : 0;
    const M* col[kPer];
    float acc[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = u < nu ? tid + u * kThreads : 0;
      col[u] = fwd + (j / B) * fwd_plane + (j % B);
      acc[u] = 0.0f;
    }
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float f = sh.frame[t];
      const size_t off = static_cast<size_t>(t) * fwd_row;
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (u < nu) acc[u] += f * to_f32(col[u][off]);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (u < nu) sh.spec[tid + u * kThreads] = acc[u];
  }
  __syncthreads();

  // 3 + 4. quantize / cast and insert the row at pos (in place)
  const size_t row = static_cast<size_t>(C) * B;
  const size_t plane = static_cast<size_t>(P) * row;
  float scale = 1.0f;
  if (kQuant) {
    float m = 0.0f;
    for (int j = tid; j < w; j += kThreads) m = fmaxf(m, fabsf(sh.spec[j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((tid & 31) == 0) sh.red[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
      float peak = 0.0f;
      for (int i = 0; i < kWarps; ++i) peak = fmaxf(peak, sh.red[i]);
      sh.scale = peak > 0.0f ? peak : 1.0f;
      scales[static_cast<size_t>(pos) * C + c] = sh.scale;
    }
    __syncthreads();
    scale = sh.scale;
  }
  T* dst = fdl + static_cast<size_t>(pos) * row + static_cast<size_t>(c) * B;
  for (int j = tid; j < w; j += kThreads) {
    float v = sh.spec[j];
    if (kQuant) v = fminf(fmaxf(rintf(v / scale * kIntMax), -kIntMax), kIntMax);
    store(dst + (j / B) * plane + (j % B), v);
  }
  __syncthreads();  // the new row and scale are visible to the whole CTA

  // 5 + 6. rotated-filter MAC over P (seeded from acc_add when given), then
  // the lane-0 DC/Nyquist overwrite. With a chunk schedule (row pos of the
  // [P, L] tables, read here) only the flag-1 chunks are summed, each
  // over its first B >> code lanes, rows ascending as in the dense loop; a
  // code outside lane_widths(B) falls back to the full width (exact: the
  // masked filter bins are zero).
  const size_t frow = static_cast<size_t>(Cf) * w;
  const M* frot = rim + static_cast<size_t>(P - 1 - pos) * frow +
                  static_cast<size_t>(Cf == 1 ? 0 : c) * w;
  for (int k = tid; k < B; k += kThreads) {
    const T* xr = fdl + static_cast<size_t>(c) * B + k;
    const T* xi = xr + plane;
    const M* fr = frot + k;
    const M* fi = fr + B;
    // seed [2, C, B]: plane 0 re, plane 1 im
    float ar = seed ? seed[static_cast<size_t>(c) * B + k] : 0.0f;
    float ai = seed ? seed[static_cast<size_t>(C + c) * B + k] : 0.0f;
    auto mac_rows = [&](int p0, int p1) {
#pragma unroll 4
      for (int p = p0; p < p1; ++p) {
        float r = to_f32(xr[p * row]);
        float i = to_f32(xi[p * row]);
        if (kQuant) {
          const float s = scales[static_cast<size_t>(p) * C + c] * kInvMax;
          r *= s;
          i *= s;
        }
        const float a = to_f32(fr[p * frow]);
        const float b = to_f32(fi[p * frow]);
        ar += r * a - i * b;
        ai += r * b + i * a;
      }
    };
    if (sd.c) {
      const int* c_row = sd.c + static_cast<size_t>(pos) * sd.L;
      const int* f_row = sd.f + static_cast<size_t>(pos) * sd.L;
      for (int j = 0; j < sd.L; ++j) {
        if (f_row[j] != 1) continue;
        const int v = c_row[j];
        const int code = v >> 16;
        if (k >= (code < sd.n_codes ? B >> code : B)) continue;
        const int p0 = (v & 0xFFFF) * sd.pc;
        mac_rows(p0, p0 + sd.pc);
      }
    } else {
      mac_rows(0, P);
    }
    if (k == 0) {
      ar = dc_fix;
      ai = ny_fix;
    }
    sh.acc[k] = round_to<M>(ar);
    sh.acc[B + k] = round_to<M>(ai);
  }
  __syncthreads();

  // 7. inverse packed DFT: out[t] = sum_j acc[j] * inv(j / B, j % B, t)
  {
    const int nu = tid < n_out ? (n_out - tid + kThreads - 1) / kThreads : 0;
    float acc[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) acc[u] = 0.0f;
    for (int pl = 0; pl < 2; ++pl) {
      const M* base = inv + pl * inv_plane + tid;
#pragma unroll 4
      for (int k = 0; k < B; ++k) {
        const float a = sh.acc[pl * B + k];
        const M* r = base + static_cast<size_t>(k) * inv_row;
#pragma unroll
        for (int u = 0; u < kPer; ++u)
          if (u < nu) acc[u] += a * to_f32(r[u * kThreads]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (u < nu) out[tid + u * kThreads] = acc[u];
  }
  __syncthreads();  // smem and the ring are reused by the next block
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
