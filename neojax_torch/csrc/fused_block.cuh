// The stages of one channel's fused block (B2/B3, csrc/fused_step.cu), as
// device functions that the production kernels and the probes
// (csrc/probes.cu, T2) share, so that a probe times B3's own code.
//
// One CTA of kThreads threads owns one channel. Each stage reads and writes
// the CTA's shared memory (Shared) and ends at a __syncthreads(), so a
// caller strings them together in order:
//
//   load_frame -> forward_dft -> insert_row -> mac -> inverse_dft
//
// Matrices are addressed as element (plane, r, col) at
//   base[plane * plane_stride + r * row_stride + col]
// which covers both kernels' layouts:
//   B2  cs [2, N, B]  -> (N*B, B)     ab  [2, B, N] -> (B*N, N)
//   B3  cs [N, 2B]    -> (B, 2B)      abt [2B, B]   -> (B*B, B)
#pragma once

#include "common.cuh"

namespace neo {
namespace fused {

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

// 1. the frame's N = 2B samples into shared memory, rounded to the matrix dtype
template <typename M>
__device__ __forceinline__ void load_frame(Shared& sh, const float* __restrict__ frame_src, int B) {
  const int n = 2 * B;
  for (int t = threadIdx.x; t < n; t += kThreads) sh.frame[t] = round_to<M>(frame_src[t]);
  __syncthreads();
}

// 2. forward packed DFT: spec[j] = sum_t frame[t] * fwd(j / B, t, j % B)
template <typename M>
__device__ __forceinline__ void forward_dft(Shared& sh, const M* __restrict__ fwd, size_t fwd_plane,
                                            size_t fwd_row, int B) {
  const int tid = threadIdx.x;
  const int n = 2 * B;
  const int w = 2 * B;
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
  __syncthreads();
}

// 3 + 4. quantize (per-channel peak scale, rint, x / scale * int_max,
// clamp) or cast the spectrum, and insert it as ring row pos (in place),
// with its scale at scales[pos, c]
template <typename T>
__device__ __forceinline__ void insert_row(Shared& sh, T* fdl, float* scales, int P, int C, int B,
                                           int c, int pos) {
  constexpr bool kQuant = Traits<T>::kQuant;
  constexpr float kIntMax = Traits<T>::kIntMax;
  const int tid = threadIdx.x;
  const int w = 2 * B;
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
}

// 5 + 6. rotated-filter MAC over P into acc (seeded from seed when given),
// then the lane-0 DC/Nyquist overwrite; acc is rounded to the matrix dtype.
// With a chunk schedule (row pos of the [P, L] tables) only the flag-1
// chunks are summed, each over its first B >> code lanes, rows ascending as
// in the dense loop; a code outside lane_widths(B) falls back to the full
// width (exact: the masked filter bins are zero).
template <typename T, typename M>
__device__ __forceinline__ void mac(Shared& sh, const T* fdl, const M* __restrict__ rim,
                                    const float* scales, float dc_fix, float ny_fix,
                                    const float* __restrict__ seed, int P, int C, int B, int Cf,
                                    int c, int pos, const Sched& sd) {
  constexpr bool kQuant = Traits<T>::kQuant;
  constexpr float kInvMax = 1.0f / Traits<T>::kIntMax;
  const int w = 2 * B;
  const size_t row = static_cast<size_t>(C) * B;
  const size_t plane = static_cast<size_t>(P) * row;
  const size_t frow = static_cast<size_t>(Cf) * w;
  const M* frot = rim + static_cast<size_t>(P - 1 - pos) * frow +
                  static_cast<size_t>(Cf == 1 ? 0 : c) * w;
  for (int k = threadIdx.x; k < B; k += kThreads) {
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
}

// 7. inverse packed DFT: out[t] = sum_j acc[j] * inv(j / B, j % B, t) for
// t < n_out (all N samples for B2, the UPOLS tail half for B3)
template <typename M>
__device__ __forceinline__ void inverse_dft(Shared& sh, const M* __restrict__ inv, size_t inv_plane,
                                            size_t inv_row, float* __restrict__ out, int n_out,
                                            int B) {
  const int tid = threadIdx.x;
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
  __syncthreads();  // smem and the ring are reused by the next block
}

}  // namespace fused
}  // namespace neo
