// The packed real DFTs of B2 and B3 (and of the T2 probe), as shared-memory
// FFTs: every row of a window of blocks is one transform.
//
// Replaces the forward and inverse DFT steps of the TPU kernels
// neojax/kernels/fused_step.py :: fused_block_step (Pallas body _mk_kernel)
// and :: fused_stream (body _mk_stream_kernel), which run each as an MXU
// product of a block's channels against the packed DFT matrices
// (fft/matmul_backend.py :: packed_mats / packed_stream_mats). The function
// is theirs:
//   forward: a frame of N = 2B real samples, rounded to the matrix dtype ->
//     its spectrum, unnormalized, packed: re lanes 0..B-1 | im lanes 1..B-1,
//     with the Nyquist real part in im lane 0;
//   inverse: a packed row [2B], rounded to the matrix dtype, im lane 0 read
//     as the Nyquist real part -> the real N-point transform scaled by 1/N,
//     its last n_out samples (B3's tail half: B; B2: all N).
// Rows come through two-level row maps, so the forward reads its frames
// straight from the signal (row (i, c) at c * L + i * B: overlapping
// windows, no copy) and the inverse writes straight into the stream output.
//
// Bound on the H100: bytes. A headline window (4096 rows, N = 1024) moves
// 25.3 MB (the signal once, the spectra once) and needs ~0.1 GFLOP as an
// FFT, against 8.6 GFLOP as the dense product the TPU ran. The design:
//   - the real N-point transform as an N/2-point complex FFT of the
//     even/odd samples (z[n] = x[2n] + i x[2n+1]) and one twiddle pass that
//     writes the packed layout (the inverse runs that pass first, backwards);
//   - the complex FFT in shared memory: for B = 2^a * m, one direct DFT
//     stage of the odd factor m, then Stockham radix-8/4/2 stages, each
//     thread holding at most 8 points in registers between two barriers
//     (in place: one padded buffer a row, a pad every 8 points against bank
//     conflicts on the strided writes);
//   - 32, 64 or 128 threads a row (B up to 256, 512, 1024) and CTAs of up
//     to 128 threads (4, 2 or 1 rows), held to 64 registers: 16 CTAs of
//     8.3 KB an SM at the headline, so that one CTA's loads overlap
//     another's stages (larger CTAs of up to 80 registers ran slower on the
//     card); fewer rows
//     a CTA when the launch has few rows, so that B2's 64 rows still spread
//     over 64 SMs; 16-byte global loads and stores where the rows'
//     alignment allows (the same arithmetic either way);
//   - twiddles W_N^q computed in float64 on the host, stored as f32; f32
//     arithmetic throughout, explicit fmaf / __fmul_rn so that no contraction
//     choice of the compiler can make a row's bits depend on its code path.
// A row's bits depend on nothing but its input: no depth split, no atomics,
// and every row of every launch runs the same instruction sequence.
#include <type_traits>

#include "common.cuh"

namespace {

using namespace neo;

// Row r at (r / inner) * s_outer + (r % inner) * s_inner.
struct RowMap {
  int inner;
  long long s_outer, s_inner;
  __device__ __forceinline__ long long at(int r) const {
    return static_cast<long long>(r / inner) * s_outer + static_cast<long long>(r % inner) * s_inner;
  }
};

struct Fft {
  const float* in;
  RowMap im;
  float* out;
  RowMap om;
  const float2* tw;  // W_N^q = exp(-2 pi i q / N), q < N
  int rows, m;       // rows; complex points a row (M = B)
  int odd;           // the odd factor of M
  int tpr, rpc;      // threads a row, rows a CTA
  int n_out;         // inverse: the last n_out of the N samples are written
  int vec_in, vec_out;
  float inv_n;
};

constexpr int kThreads = 128, kMinBlocks = 8;  // 64 registers: 1024 threads an SM

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, __fmul_rn(-a.y, b.y)), fmaf(a.x, b.y, __fmul_rn(a.y, b.x)));
}
// a * (-i) forward, a * (+i) inverse
template <bool kInv> __device__ __forceinline__ float2 rot90(float2 a) {
  return kInv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
// W_N^q forward, its conjugate inverse
template <bool kInv> __device__ __forceinline__ float2 twid(const float2* tw, int q) {
  const float2 w = __ldg(tw + q);
  return kInv ? make_float2(w.x, -w.y) : w;
}

template <typename M> __device__ __forceinline__ float2 round2(float a, float b) {
  return make_float2(round_to<M>(a), round_to<M>(b));
}

// ---- in-register DFTs of 2, 4 and 8 points (natural order in and out)
template <bool kInv> __device__ __forceinline__ void dft(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <bool kInv> __device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2, float2& x3) {
  const float2 t0 = cadd(x0, x2), t1 = csub(x0, x2), t2 = cadd(x1, x3), t3 = rot90<kInv>(csub(x1, x3));
  x0 = cadd(t0, t2);
  x2 = csub(t0, t2);
  x1 = cadd(t1, t3);
  x3 = csub(t1, t3);
}

template <bool kInv> __device__ __forceinline__ void dft(float2 (&v)[4]) { dft4<kInv>(v[0], v[1], v[2], v[3]); }

template <bool kInv> __device__ __forceinline__ void dft(float2 (&v)[8]) {
  constexpr float c = 0.70710678118654752f;
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4<kInv>(e0, e1, e2, e3);
  dft4<kInv>(o0, o1, o2, o3);
  // o_k *= W_8^k (conjugated for the inverse)
  o1 = kInv ? make_float2(__fmul_rn(c, __fsub_rn(o1.x, o1.y)), __fmul_rn(c, __fadd_rn(o1.x, o1.y)))
            : make_float2(__fmul_rn(c, __fadd_rn(o1.x, o1.y)), __fmul_rn(c, __fsub_rn(o1.y, o1.x)));
  o2 = rot90<kInv>(o2);
  o3 = kInv ? make_float2(__fmul_rn(-c, __fadd_rn(o3.x, o3.y)), __fmul_rn(c, __fsub_rn(o3.x, o3.y)))
            : make_float2(__fmul_rn(c, __fsub_rn(o3.y, o3.x)), __fmul_rn(-c, __fadd_rn(o3.x, o3.y)));
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// One Stockham radix-R stage over a row of M points in z (padded), after
// stages whose radices multiply to Ns: butterfly j reads z[j + r M/R],
// twiddles by W_{Ns R}^{(j % Ns) r} (the stage's table, st[(r - 1) Ns + k],
// so that neighbouring threads read neighbouring twiddles), and writes
// z[(j / Ns) Ns R + j % Ns + r Ns]. M <= 8 tpr, so a thread holds at most
// 8 / R butterflies.
template <int R, bool kInv>
__device__ __forceinline__ void radix_stage(float2* z, int M, int Ns, int lt, int tpr, const float2* st) {
  constexpr int U = 8 / R;
  const int nbf = M / R;
  float2 v[U][R];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = lt + u * tpr;
    if (j < nbf) {
      const int k = j % Ns;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 a = z[pad(j + r * nbf)];
        v[u][r] = r == 0 ? a : cmul(a, twid<kInv>(st, (r - 1) * Ns + k));
      }
      dft<kInv>(v[u]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = lt + u * tpr;
    if (j < nbf) {
      const int k = j % Ns, base = (j / Ns) * Ns * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) z[pad(base + r * Ns)] = v[u][r];
    }
  }
  __syncthreads();
}

// The first stage when M has an odd factor m > 1: a direct m-point DFT of
// the points j, j + M/m, ... (output o = j m + s, s < m, at z[o]).
template <bool kInv>
__device__ __forceinline__ void odd_stage(float2* z, int M, int m, int lt, int tpr, const float2* tw) {
  const int stride = M / m, tstep = 2 * stride;  // W_m^q = W_N^{q N / m}
  float2 acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int o = lt + u * tpr;
    acc[u] = make_float2(0.0f, 0.0f);
    if (o < M) {
      const int j = o / m, s = o % m;
      int q = 0;
      for (int r = 0; r < m; ++r) {
        acc[u] = cadd(acc[u], cmul(z[pad(j + r * stride)], twid<kInv>(tw, q * tstep)));
        q += s;
        if (q >= m) q -= m;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int o = lt + u * tpr;
    if (o < M) z[pad(o)] = acc[u];
  }
  __syncthreads();
}

// The complex M-point DFT of a row in place (natural order in and out),
// unnormalized; every thread of the CTA calls it (it holds barriers). The
// stages' tables follow W_N^q (q < N) in tw, in stage order; the radices
// are kernels/fused_step.py :: fft_radices, which builds them.
template <bool kInv, bool kOdd>
__device__ __forceinline__ void cfft(float2* z, int M, int odd, int lt, int tpr, const float2* tw) {
  int ns = 1;
  if (kOdd) {
    odd_stage<kInv>(z, M, odd, lt, tpr, tw);
    ns = odd;
  }
  const float2* st = tw + 2 * M;
  while (ns < M) {
    const int rem = M / ns;
    if (rem == 2) {
      radix_stage<2, kInv>(z, M, ns, lt, tpr, st);
      st += ns;
      ns *= 2;
    } else if (rem == 4 || rem == 16) {
      radix_stage<4, kInv>(z, M, ns, lt, tpr, st);
      st += 3 * ns;
      ns *= 4;
    } else {
      radix_stage<8, kInv>(z, M, ns, lt, tpr, st);
      st += 7 * ns;
      ns *= 8;
    }
  }
}

// Forward bin k < M of the real transform from the half-length spectrum Z:
// X[k] = E + W_N^k O, E = (Z[k] + conj Z[M-k]) / 2, O = -i (Z[k] - conj Z[M-k]) / 2.
__device__ __forceinline__ float2 real_bin(const float2* z, int M, int k, const float2* tw) {
  const float2 a = z[pad(k)], bc = z[pad(k == 0 ? 0 : M - k)];
  const float2 b = make_float2(bc.x, -bc.y);
  const float2 e = make_float2(__fmul_rn(0.5f, __fadd_rn(a.x, b.x)), __fmul_rn(0.5f, __fadd_rn(a.y, b.y)));
  const float2 d = csub(a, b);
  const float2 o = make_float2(__fmul_rn(0.5f, d.y), __fmul_rn(-0.5f, d.x));
  return cadd(e, cmul(o, __ldg(tw + k)));
}

// Inverse pre-pass: Z[k] = E + i O with E = X[k] + conj X[M-k],
// O = (X[k] - conj X[M-k]) W_N^-k (the 1/2s fold into the final 1/N).
__device__ __forceinline__ float2 half_bin(float2 xk, float2 xmk, int k, const float2* tw) {
  const float2 c = make_float2(xmk.x, -xmk.y);
  const float2 e = cadd(xk, c);
  const float2 o = cmul(csub(xk, c), twid<true>(tw, k));
  return make_float2(__fsub_rn(e.x, o.y), __fadd_rn(e.y, o.x));
}

// kBf16 (the bf16 and int8 storages' matrices) only rounds the input to
// bf16; kOdd: B has an odd factor (the direct stage runs first).
template <bool kBf16, bool kOdd>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fft_forward_kernel(Fft g) {
  using Mt = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  extern __shared__ float2 smem[];
  const int M = g.m, slot = threadIdx.x / g.tpr, lt = threadIdx.x % g.tpr;
  const int r = blockIdx.x * g.rpc + slot;
  const bool active = r < g.rows;
  float2* z = smem + slot * (M + (M >> 3) + 1);
  if (active) {
    const float* src = g.in + g.im.at(r);
    if (g.vec_in) {
      for (int q = lt; q < M / 2; q += g.tpr) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src) + q);
        z[pad(2 * q)] = round2<Mt>(v.x, v.y);
        z[pad(2 * q + 1)] = round2<Mt>(v.z, v.w);
      }
    } else {
      for (int n = lt; n < M; n += g.tpr) z[pad(n)] = round2<Mt>(__ldg(src + 2 * n), __ldg(src + 2 * n + 1));
    }
  }
  __syncthreads();
  cfft<false, kOdd>(z, M, g.odd, lt, g.tpr, g.tw);
  if (!active) return;
  float* re = g.out + g.om.at(r);
  float* im = re + M;
  const float nyq = __fsub_rn(z[0].x, z[0].y);  // X[M] = E - O at k = 0
  if (g.vec_out) {
    for (int q = lt; q < M / 4; q += g.tpr) {
      float2 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = real_bin(z, M, 4 * q + u, g.tw);
      reinterpret_cast<float4*>(re)[q] = make_float4(x[0].x, x[1].x, x[2].x, x[3].x);
      reinterpret_cast<float4*>(im)[q] = make_float4(q == 0 ? nyq : x[0].y, x[1].y, x[2].y, x[3].y);
    }
  } else {
    for (int k = lt; k < M; k += g.tpr) {
      const float2 x = real_bin(z, M, k, g.tw);
      re[k] = x.x;
      im[k] = k == 0 ? nyq : x.y;
    }
  }
}

template <bool kBf16, bool kOdd>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fft_inverse_kernel(Fft g) {
  using Mt = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  extern __shared__ float2 smem[];
  const int M = g.m, slot = threadIdx.x / g.tpr, lt = threadIdx.x % g.tpr;
  const int r = blockIdx.x * g.rpc + slot;
  const bool active = r < g.rows;
  float2* z = smem + slot * (M + (M >> 3) + 1);
  // the packed row as X[k] = (re[k], im[k]), X[0] = (re[0], Nyquist)
  if (active) {
    const float* re = g.in + g.im.at(r);
    const float* im = re + M;
    if (g.vec_in) {
      for (int q = lt; q < M / 4; q += g.tpr) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(re) + q);
        const float4 b = __ldg(reinterpret_cast<const float4*>(im) + q);
        z[pad(4 * q)] = round2<Mt>(a.x, b.x);
        z[pad(4 * q + 1)] = round2<Mt>(a.y, b.y);
        z[pad(4 * q + 2)] = round2<Mt>(a.z, b.z);
        z[pad(4 * q + 3)] = round2<Mt>(a.w, b.w);
      }
    } else {
      for (int k = lt; k < M; k += g.tpr) z[pad(k)] = round2<Mt>(__ldg(re + k), __ldg(im + k));
    }
  }
  __syncthreads();
  // the half-length spectrum, in place: a thread owns the pair (k, M - k)
  for (int k = lt; k <= M / 2; k += g.tpr) {
    if (k == 0) {
      const float2 x = z[0];
      z[0] = half_bin(make_float2(x.x, 0.0f), make_float2(x.y, 0.0f), 0, g.tw);
    } else {
      const float2 a = z[pad(k)], b = z[pad(M - k)];
      z[pad(k)] = half_bin(a, b, k, g.tw);
      if (M - k != k) z[pad(M - k)] = half_bin(b, a, M - k, g.tw);
    }
  }
  __syncthreads();
  cfft<true, kOdd>(z, M, g.odd, lt, g.tpr, g.tw);
  if (!active) return;
  // samples t in [N - n_out, N): z[n] holds (y[2n], y[2n + 1]) * N
  const int n0 = M - g.n_out / 2;
  float* dst = g.out + g.om.at(r);
  if (g.vec_out) {
    for (int p = lt; p < (M - n0) / 2; p += g.tpr) {
      const float2 a = z[pad(n0 + 2 * p)], b = z[pad(n0 + 2 * p + 1)];
      reinterpret_cast<float4*>(dst)[p] = make_float4(__fmul_rn(a.x, g.inv_n), __fmul_rn(a.y, g.inv_n),
                                                      __fmul_rn(b.x, g.inv_n), __fmul_rn(b.y, g.inv_n));
    }
  } else {
    for (int n = n0 + lt; n < M; n += g.tpr) {
      const float2 a = z[pad(n)];
      dst[2 * (n - n0)] = __fmul_rn(a.x, g.inv_n);
      dst[2 * (n - n0) + 1] = __fmul_rn(a.y, g.inv_n);
    }
  }
}

// whether every row start of a map is 16-byte aligned (strides in floats)
bool aligned16(const void* base, int inner, long long s_outer, long long s_inner) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && s_outer % 4 == 0 && (inner == 1 || s_inner % 4 == 0);
}

}  // namespace

// The packed real DFT of `rows` rows of block B (N = 2B points), f32 in and
// out; mat_bf16 rounds the input to bf16 first. Row maps (inner, s_outer,
// s_inner) in floats for the input rows (forward: N samples; inverse: a
// packed row [2B]) and the output rows (forward: a packed row [2B];
// inverse: the last n_out of the N samples, n_out in {B, N}). tw: W_N^q,
// q < N, float2, then each radix stage's table (kernels/fused_step.py ::
// twiddles).
extern "C" int neo_transform(int mat_bf16, int inverse, const void* in, int i_inner, long long i_so,
                             long long i_si, void* out, int o_inner, long long o_so, long long o_si,
                             const void* tw, int rows, int B, int n_out, void* stream) {
  if (rows < 1 || B < 2 || B % 2 || B > 1024 || i_inner < 1 || o_inner < 1 || tw == nullptr ||
      (mat_bf16 != 0 && mat_bf16 != 1) || (inverse && n_out != B && n_out != 2 * B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = B;
  int odd = M;
  while (odd % 2 == 0) odd /= 2;
  const int tpr = M <= 256 ? 32 : M <= 512 ? 64 : 128;  // M <= 8 tpr
  const int want = (rows + 263) / 264;                  // two CTAs an SM before rows are grouped
  const int rpc = want < kThreads / tpr ? want : kThreads / tpr;
  Fft g{static_cast<const float*>(in), RowMap{i_inner, i_so, i_si}, static_cast<float*>(out),
        RowMap{o_inner, o_so, o_si}, static_cast<const float2*>(tw), rows, M, odd, tpr, rpc,
        inverse ? n_out : 2 * B, 0, 0, 1.0f / static_cast<float>(2 * B)};
  if (inverse) {
    g.vec_in = M % 4 == 0 && aligned16(in, i_inner, i_so, i_si);
    g.vec_out = (M - n_out / 2) % 2 == 0 && n_out % 4 == 0 && aligned16(out, o_inner, o_so, o_si);
  } else {
    g.vec_in = aligned16(in, i_inner, i_so, i_si);
    g.vec_out = M % 4 == 0 && aligned16(out, o_inner, o_so, o_si);
  }
  const dim3 grid((rows + rpc - 1) / rpc);
  const size_t smem = static_cast<size_t>(rpc) * (M + (M >> 3) + 1) * sizeof(float2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(Fft);
  if (inverse)
    kernel = mat_bf16 ? (odd > 1 ? fft_inverse_kernel<true, true> : fft_inverse_kernel<true, false>)
                      : (odd > 1 ? fft_inverse_kernel<false, true> : fft_inverse_kernel<false, false>);
  else
    kernel = mat_bf16 ? (odd > 1 ? fft_forward_kernel<true, true> : fft_forward_kernel<true, false>)
                      : (odd > 1 ? fft_forward_kernel<false, true> : fft_forward_kernel<false, false>);
  kernel<<<grid, rpc * tpr, smem, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}
