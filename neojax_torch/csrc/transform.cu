// The packed-DFT transforms of B2 and B3 (and of the T2 probe): one matrix
// product over every row of a window of blocks.
//
// Replaces the forward and inverse DFT steps of the TPU kernels
// neojax/kernels/fused_step.py :: fused_block_step (Pallas body _mk_kernel)
// and :: fused_stream (body _mk_stream_kernel), which run each as one MXU
// product of a block's channels against the packed matrices. Here all
// rows (block, channel) of a window go through one product:
//
//   out(r, j) = sum_t round_M(A(r, t)) * Mat(t, j)      r < R, j < Ncol, t < K
//
// with two-level row maps, so that the forward product reads its frames
// straight from the signal (row (i, c) starts at c * (nb + 1) * B + i * B:
// overlapping windows, no copy) and the inverse product writes its rows
// straight into the stream output, and a column map that takes both matrix
// layouts, B3's cs [N, 2B] and B2's cs [2, N, B] (column j at plane j / B).
//
// Bound on the H100: operations (a window's forward product at the headline
// shape is 4096 x 1024 x 1024, 8.6 GFLOP, against 4 MB of matrix and 17 MB
// of frames). The design: 64 x 64 output tiles, the depth streamed through
// double-buffered shared memory (global loads for the next depth slice are
// in registers while the current one is consumed), each matrix element read
// once per 64 rows instead of once per channel and block.
//   - f32 matrices (split, int16 storages): FFMA only, 4 x 4 outputs a
//     thread. The TPU runs these products at Precision.HIGHEST; no TF32.
//   - bf16 matrices (bf16, int8 storages): tensor cores, mma.sync
//     m16n8k16 with bf16 operands (A rounded to bf16 on its way into shared
//     memory) and f32 accumulation: the TPU's DEFAULT pass.
// When the tiles alone cannot fill the card (B2: 64 rows), the depth is
// split over gridDim.z into partial sums that a second pass adds in a fixed
// order (no atomics).
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

// Matrix element (t, j) at (j / split) * plane + t * ld + j % split.
struct MatMap {
  int split;
  long long plane, ld;
  __device__ __forceinline__ long long at(int t, int j) const {
    return static_cast<long long>(j / split) * plane + static_cast<long long>(t) * ld + (j % split);
  }
};

struct Gemm {
  const float* a;
  RowMap am;
  const void* mat;
  MatMap mm;
  float* out;   // with om, when the depth is not split
  RowMap om;
  float* part;  // [ksplit, R, Ncol] partial sums when it is
  int R, K, Ncol, kchunk;
};

constexpr int kBM = 64, kBN = 64, kThreads = 256;

__device__ __forceinline__ void put(const Gemm& g, int r, int j, float v) {
  if (r >= g.R || j >= g.Ncol) return;
  if (gridDim.z > 1)
    g.part[(static_cast<size_t>(blockIdx.z) * g.R + r) * g.Ncol + j] = v;
  else
    g.out[g.om.at(r) + j] = v;
}

// ---- f32: FFMA, depth slices of 16
constexpr int kBK = 16;

// kInverse only names the kernel apart (a profiler tells forward from inverse)
template <bool kInverse>
__global__ void __launch_bounds__(kThreads) gemm_f32_kernel(Gemm g) {
  __shared__ float As[2][kBK][kBM + 4];
  __shared__ float Bs[2][kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * g.kchunk, kend = min(g.K, kbeg + g.kchunk);
  const float* mat = static_cast<const float*>(g.mat);
  const int ar = tid / 4, ak = (tid % 4) * 4;   // A: one row, 4 depths
  const int bk = tid / 16, bj = (tid % 16) * 4;  // B: one depth, 4 columns
  const bool a_ok = r0 + ar < g.R;
  const float* arow = g.a + (a_ok ? g.am.at(r0 + ar) : 0);
  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = k0 + ak + u;
      ra[u] = (a_ok && t < kend) ? arow[t] : 0.0f;
      const int tb = k0 + bk, j = j0 + bj + u;
      rb[u] = (tb < kend && j < g.Ncol) ? mat[g.mm.at(tb, j)] : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      As[buf][ak + u][ar] = ra[u];
      Bs[buf][bk][bj + u] = rb[u];
    }
  };
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.0f;
  int buf = 0;
  load(kbeg);
  store(0);
  __syncthreads();
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    const bool more = k0 + kBK < kend;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) av[m] = As[buf][kk][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) bv[n] = Bs[buf][kk][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) put(g, r0 + ty + 16 * m, j0 + tx + 16 * n, acc[m][n]);
}

// ---- bf16: mma.sync m16n8k16, depth slices of 32. Eight warps as 4 (rows)
// x 2 (columns): each warp owns 16 rows x 32 columns, four n8 tiles.
constexpr int kBKh = 32, kPadH = 8, kLdh = kBKh + kPadH;  // 80-byte rows: no bank conflicts

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads) gemm_bf16_kernel(Gemm g) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM][kLdh];  // [row][depth]
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBN][kLdh];  // [column][depth]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4, gq = lane >> 2, q = lane & 3;
  const int r0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * g.kchunk, kend = min(g.K, kbeg + g.kchunk);
  const __nv_bfloat16* mat = static_cast<const __nv_bfloat16*>(g.mat);
  const int ar = tid / 4, ak = (tid % 4) * 8;   // A: one row, 8 depths
  const int bk = tid / 8, bj = (tid % 8) * 8;   // B: one depth, 8 columns
  const bool a_ok = r0 + ar < g.R;
  const float* arow = g.a + (a_ok ? g.am.at(r0 + ar) : 0);
  __nv_bfloat16 ra[8], rb[8];
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = k0 + ak + u;
      ra[u] = (a_ok && t < kend) ? __float2bfloat16_rn(arow[t]) : zero;
      const int tb = k0 + bk, j = j0 + bj + u;
      rb[u] = (tb < kend && j < g.Ncol) ? mat[g.mm.at(tb, j)] : zero;
    }
  };
  auto store = [&](int buf) {
    uint4 v;
    v.x = pack2(ra[0], ra[1]);
    v.y = pack2(ra[2], ra[3]);
    v.z = pack2(ra[4], ra[5]);
    v.w = pack2(ra[6], ra[7]);
    *reinterpret_cast<uint4*>(&As[buf][ar][ak]) = v;
#pragma unroll
    for (int u = 0; u < 8; ++u) Bs[buf][bj + u][bk] = rb[u];
  };
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  int buf = 0;
  load(kbeg);
  store(0);
  __syncthreads();
  for (int k0 = kbeg; k0 < kend; k0 += kBKh) {
    const bool more = k0 + kBKh < kend;
    if (more) load(k0 + kBKh);
#pragma unroll
    for (int kk = 0; kk < kBKh; kk += 16) {
      const __nv_bfloat16* a = &As[buf][wm * 16][kk];
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a + gq * kLdh + 2 * q);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a + (gq + 8) * kLdh + 2 * q);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a + gq * kLdh + 2 * q + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(a + (gq + 8) * kLdh + 2 * q + 8);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const __nv_bfloat16* b = &Bs[buf][wn * 32 + n * 8 + gq][kk];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b + 2 * q);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + 2 * q + 8);
        mma_bf16(acc[n], a0, a1, a2, a3, b0, b1);
      }
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  const int rr = r0 + wm * 16 + gq;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int jj = j0 + wn * 32 + n * 8 + 2 * q;
    put(g, rr, jj, acc[n][0]);
    put(g, rr, jj + 1, acc[n][1]);
    put(g, rr + 8, jj, acc[n][2]);
    put(g, rr + 8, jj + 1, acc[n][3]);
  }
}

// Second pass of a split depth: out(r, j) = sum over z of part[z, r, j], z ascending.
template <bool kInverse>
__global__ void __launch_bounds__(kThreads) split_sum_kernel(Gemm g, int ksplit) {
  const size_t n = static_cast<size_t>(g.R) * g.Ncol;
  for (size_t e = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * kThreads) {
    float s = 0.0f;
    for (int z = 0; z < ksplit; ++z) s += g.part[z * n + e];
    const int r = static_cast<int>(e / g.Ncol), j = static_cast<int>(e % g.Ncol);
    g.out[g.om.at(r) + j] = s;
  }
}

}  // namespace

// mat_bf16: 0 f32 matrix (FFMA), 1 bf16 (tensor cores); inverse: 1 names
// the kernels as the inverse transform's. Row maps (inner,
// s_outer, s_inner) for A and out, column map (split, plane, ld) for the
// matrix; ksplit > 1 needs part [ksplit, R, Ncol] f32 and kchunk (a multiple
// of 32) depths a split; with ksplit = 1, kchunk >= K.
extern "C" int neo_transform(int mat_bf16, int inverse, const void* a, int a_inner, long long a_so, long long a_si,
                             const void* mat, int m_split, long long m_plane, long long m_ld,
                             void* out, int o_inner, long long o_so, long long o_si, void* part,
                             int ksplit, int kchunk, int R, int K, int Ncol, void* stream) {
  if (R < 1 || K < 1 || Ncol < 1 || a_inner < 1 || o_inner < 1 || m_split < 1 || ksplit < 1 ||
      kchunk < 1 || (ksplit > 1 && kchunk % 32) || static_cast<long long>(ksplit) * kchunk < K ||
      (ksplit > 1 && part == nullptr) || ksplit > 65535 || (mat_bf16 != 0 && mat_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Gemm g{static_cast<const float*>(a), RowMap{a_inner, a_so, a_si}, mat,
               MatMap{m_split, m_plane, m_ld}, static_cast<float*>(out),
               RowMap{o_inner, o_so, o_si}, static_cast<float*>(part), R, K, Ncol, kchunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Ncol + kBN - 1) / kBN, (R + kBM - 1) / kBM, ksplit);
  if (mat_bf16)
    (inverse ? gemm_bf16_kernel<true> : gemm_bf16_kernel<false>)<<<grid, kThreads, 0, s>>>(g);
  else
    (inverse ? gemm_f32_kernel<true> : gemm_f32_kernel<false>)<<<grid, kThreads, 0, s>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(R) * Ncol;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 2048 ? want : 2048);
  (inverse ? split_sum_kernel<true> : split_sum_kernel<false>)<<<blocks, kThreads, 0, s>>>(g, ksplit);
  return static_cast<int>(cudaGetLastError());
}
