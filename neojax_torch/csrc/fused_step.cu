// B2 and B3, the fused per-block pipeline of the uniformly-partitioned
// convolver (packed-512 layout, ring FDL), as stage kernels that the
// wrappers of kernels/fused_step.py launch in order on one stream.
//
// Replaces neojax/kernels/fused_step.py :: fused_block_step (Pallas body
// _mk_kernel) and :: fused_stream (body _mk_stream_kernel). The function is
// theirs: frame rounded to the matrix dtype -> packed forward DFT ->
// quantize (per-(block, channel) peak scale, rint, x / scale * int_max,
// clamp) or cast -> ring row written with its scale -> MAC over P against
// the rotated filter, reading the new row back in its storage dtype and
// scale, seeded from acc_add when given -> lane 0 := dcfix -> accumulator
// rounded to the matrix dtype -> inverse (all N samples for B2, the UPOLS
// tail half for B3).
//
// On the H100 the block-by-block loop of the TPU kernel is bound by bytes:
// every block re-reads the whole ring (252 MB split at P = 960, C = 64,
// B = 512). The design here takes the work that does not depend on the
// ring out of the loop and batches the MAC over time. B3 walks its nb
// blocks in windows of W (kernels/fused_step.py :: WINDOW):
//
//   1. transform.cu: the window's forward DFTs, one shared-memory FFT a row
//   2. quantize_kernel: spectra -> staged rows X_new [W, 2, C, B] in the
//      storage dtype and their scales [W, C]
//   3. stream_mac_kernel: the time-batched MAC, the MAC of fused_stream.
//      Block i's sum sum_a filt[a] X[i - a] is, for each lane, a complex
//      product of a Toeplitz matrix of filter rows [blocks, history rows]
//      by the history [history rows, channels]. Bound: operations (16.1
//      GFLOP for 64 blocks at the headline shape, 0.24 ms of f32 FFMA; the
//      ring's bytes 0.075 ms). A CTA owns 8 lanes x 16 channels x 64
//      blocks and walks the history rows, oldest first, in steps of 16:
//      cp.async copies each step's history tile and the filter taps it
//      meets into shared memory, three stages deep, and a thread keeps 8
//      blocks x 4 channels of its lane in registers, so each value it
//      reads from shared memory feeds 8 blocks or 4 channels and the
//      filter values slide along the Toeplitz diagonal in registers.
//      History rows inside the window come from X_new, older ones from the
//      ring (not yet overwritten: step 4 comes after).
//   4. writeback_kernel: X_new and its scales into the ring slots, in their
//      own launch after the MAC (the last write wins when W > P)
//   5. transform.cu: the inverse FFTs, straight into the output
//
// B2 (one block) has no reuse across blocks: its MAC is bound by the ring's
// bytes. It writes the new row first (writeback_kernel, in place), then
// step_mac_kernel reads the ring with 16-byte loads along the lanes on a
// (lane tile, channel, P split) grid, and step_reduce_kernel adds the P
// splits' partial sums in a fixed order (no atomics), sets lane 0 and
// rounds. Both live in step_mac.cuh, shared with the unfused MAC (B1, B4 in
// fdl_mac.cu), which takes its filter as planes with strides.
//
// Sparse filters: widths_kernel turns the chunk schedule (the full [P, L]
// tables) into a [P, P / pc] table of live lane widths (0: not flagged).
// Block i honours row (pos0 + i) % P: slot p contributes on lanes k <
// width[row, p / pc]. The MACs skip what is dead for every term of a tile
// (B3: a step of history rows on a CTA's lanes; B2: a chunk of slots) and
// mask the terms of mixed tiles, in the dense kernel's summation order, so
// the scheduled kernels equal the dense ones on a masked filter. B3 also
// takes a finer table of its own, live by (tap, lane tile of kLanes) and
// the same at every ring position: stream_mac_tiles_kernel below.
#include "step_mac.cuh"

namespace {

using namespace neo;

constexpr int kRowThreads = 256;

// ---- 2. quantize or cast: one CTA a spectrum row (block i, channel c) of
// s [wc, C, 2B]; rows of x [wc, 2, C, B], scales scl [wc, C]
template <typename T>
__global__ void __launch_bounds__(kRowThreads) quantize_kernel(const float* __restrict__ s,
                                                               T* __restrict__ x,
                                                               float* __restrict__ scl, int C,
                                                               int B) {
  constexpr bool kQuant = Traits<T>::kQuant;
  constexpr float kIntMax = Traits<T>::kIntMax;
  __shared__ float red[kRowThreads / 32];
  const int r = blockIdx.x, i = r / C, c = r % C, tid = threadIdx.x;
  const int w = 2 * B;
  const float* row = s + static_cast<size_t>(r) * w;
  float scale = 1.0f;
  if (kQuant) {
    float m = 0.0f;
    for (int j = tid; j < w; j += kRowThreads) m = fmaxf(m, fabsf(row[j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    float peak = 0.0f;
#pragma unroll
    for (int k = 0; k < kRowThreads / 32; ++k) peak = fmaxf(peak, red[k]);
    scale = peak > 0.0f ? peak : 1.0f;
    if (tid == 0) scl[r] = scale;
  }
  T* dst = x + static_cast<size_t>(i) * 2 * C * B + static_cast<size_t>(c) * B;
  const size_t plane = static_cast<size_t>(C) * B;
  for (int j = tid; j < w; j += kRowThreads) {
    float v = row[j];
    if (kQuant) v = fminf(fmaxf(rintf(v / scale * kIntMax), -kIntMax), kIntMax);
    store(dst + (j / B) * plane + (j % B), v);
  }
}

// ---- 4. ring write-back: staged block i -> slot (pos_first + i) % P for
// the last min(wc, P) blocks (the earlier ones would be overwritten)
template <typename T>
__global__ void __launch_bounds__(kRowThreads) writeback_kernel(
    const T* __restrict__ x, const float* __restrict__ scl, T* __restrict__ fdl,
    float* __restrict__ scales, int P, int C, int B, int wc, int first, int pos_first) {
  const int r = blockIdx.x, i = first + r / C, c = r % C;
  const int slot = (pos_first + i) % P;
  const size_t plane = static_cast<size_t>(C) * B;
  const T* src = x + static_cast<size_t>(i) * 2 * plane + static_cast<size_t>(c) * B;
  T* dst = fdl + static_cast<size_t>(slot) * plane + static_cast<size_t>(c) * B;
  const size_t ring_plane = static_cast<size_t>(P) * plane;
  for (int j = threadIdx.x; j < 2 * B; j += kRowThreads)
    dst[(j / B) * ring_plane + (j % B)] = src[(j / B) * plane + (j % B)];
  if (scl && threadIdx.x == 0) scales[static_cast<size_t>(slot) * C + c] = scl[static_cast<size_t>(i) * C + c];
}

// ---- the chunk schedule as live widths: tab [P, nchunks], one CTA a row
__global__ void __launch_bounds__(kRowThreads) widths_kernel(const int* __restrict__ c_idx,
                                                             const int* __restrict__ c_flags,
                                                             int* __restrict__ tab, int L,
                                                             int nchunks, int B, int n_codes) {
  const int row = blockIdx.x;
  int* t = tab + static_cast<size_t>(row) * nchunks;
  for (int j = threadIdx.x; j < nchunks; j += kRowThreads) t[j] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += kRowThreads) {
    const size_t e = static_cast<size_t>(row) * L + j;
    if (c_flags[e] != 1) continue;
    const int v = c_idx[e];
    const int code = v >> 16, chunk = v & 0xFFFF;
    if (chunk < nchunks) atomicMax(t + chunk, code < n_codes ? B >> code : B);
  }
}

// ---- 3. the time-batched MAC (B3): stream_mac_kernel
//
// Replaces the MAC of neojax/kernels/fused_step.py :: fused_stream (the
// `accumulate` of _mk_stream_kernel). Block i of the window (ring position
// pos_i) sums seed_i + sum over the taps a < P of filt_i[a] * X[i - a]:
// history row d = i - a is the window's staged row d (d >= 0) or ring slot
// (pos_first + d) mod P, each dequantized with its own scale; tap a meets
// filter row P - 1 - a when a <= pos_i, else 2P - 1 - a (the two halves of
// the untiled rim; equivalently, rows d < thr_i = i - pos_i meet the upper
// half). For one lane this is a complex product acc [blocks, channels] =
// T H of the Toeplitz matrix T [blocks, history rows] of the filter rows
// and the history H [history rows, channels].
//
// Bound: operations, 8 flops a (block, tap, channel, lane): 16.1 GFLOP for
// the headline window (64 blocks, P = 960, C = 64, B = 512), 0.24 ms at the
// H100's 67 TFLOP/s of f32 FFMA; the ring's bytes, read once, take 0.075 ms.
//
// Design. A CTA owns kLanes lanes, a tile of Ct = 4 NC channels and
// kBlocks blocks, and walks the history rows its blocks meet, oldest
// first, in steps of kRows. Each step's history tile [kRows, 2, Ct,
// kLanes] (storage dtype, and the rows' scales) goes global -> shared by
// cp.async into a ring of kStages stages: the copies of the next two steps
// are in flight during this step's FFMAs, and one barrier a step hands a
// stage over. The filter taps live in a ring of their own in shared memory
// ([2 halves, 2 planes, Ct', kRing + kTail, kLanes] in the matrix dtype;
// tap a at slot a mod kRing, the first kTail slots mirrored after the
// last so that a thread's taps of a step are contiguous): a step copies
// only the kRows taps its rows meet first, each tap is copied once a CTA,
// and a half no block of the CTA meets is not copied. T is never formed.
// A warp is kMB consecutive blocks x 8 lanes x 4 channel groups; a thread
// keeps its lane's kMB blocks x NC channels in registers (64 f32 at NC =
// 4). Each history value it reads from shared memory feeds kMB blocks and
// each filter value NC channels; where its blocks all meet one half over
// the step, block j meets at row r the value block j - 1 met at row r - 1
// (T's diagonal), so the values slide through registers and a row costs
// 2 NC + 2 shared reads for 4 kMB NC FFMAs (2 NC + 4 where the warp's
// blocks straddle a wrap of the ring, whose two sides meet two halves).
// Values are widened to f32 (int rows times their scale) as they leave
// shared memory. The first and last steps of a warp, and the steps of a
// schedule that are live on some but not all of the CTA's terms, mask
// each (block, row) term by one bit (its tap in [0, P), its lane live);
// a step in which a block's filter half changes, a warp with fewer than
// kMB blocks and P < kMB take the general loop, which checks each (block,
// row). With a schedule a step whose terms are dead on every lane of the
// CTA copies no history and runs nothing. The unrolled rows are
// kept to groups of 4 (a whole step is ~2300 instructions, and warps in
// different variants of it at once thrash the instruction cache).
// Occupancy: at most 128 registers a thread (launch bounds), two CTAs of
// 8 warps an SM at the headline (74 KB of shared memory each): 256 CTAs,
// one wave on 132 SMs. Per-channel filters (Cf = C) keep each channel's
// taps, so their tile is NC = 1 (Ct = 4).
//
// Summation order: each (block, channel, lane) sum is one f32 accumulator,
// seeded, that takes its taps by ascending history row (oldest first: the
// small terms of the decaying filter before the large) through cmac,
// skipping the taps outside [0, P) and a schedule's dead terms (exact zeros
// of the dense sum). No split over taps, no atomics: a block's bits do not
// depend on its place in the window, on wc, on the steps' alignment, on
// the channel count, the channel or lane tile or on the grid.
constexpr int kLanes = 8;                        // lanes a CTA
constexpr int kMB = 8;                           // consecutive blocks a thread (and a warp)
constexpr int kBlocks = 64;                      // blocks a CTA: a warp each kMB
constexpr int kRows = 16;                        // history rows a step
constexpr int kStages = 3;                       // cp.async stages of the history
constexpr int kRing = 128;                       // filter tap slots (>= the kBlocks + kRows - 1 taps
                                                 // of a step and the 2 kRows copied ahead)
constexpr int kTail = 32;                        // mirrored slots: a thread's kMB + kRows - 1 taps
constexpr int kMacThreads = 32 * kBlocks / kMB;  // 256

template <typename T, typename M>
struct MacArgs {
  const T* ring;        // [2, P, C, B]
  const float* scales;  // [P, C] (int storages)
  const T* xnew;        // [wc, 2, C, B] staged rows of this window
  const float* snew;    // [wc, C]
  const M* rim;         // [2P, Cf, 2B]
  const float* seed;    // [wc, 2, C, B] or null
  const float* dcfix;   // [wc, 2, C]
  const int* wtab;      // [P, nchunks] or null
  float* acc;           // [wc, C, 2B]
  int P, C, B, Cf, wc, pos_first, pc, nchunks;
  int vec_h, vec_f;     // cp.async piece bytes of the history and filter tiles (0: element by element)
  // stream_mac_tiles_kernel only (else null): the tap-tile table [P, nt]
  // (1: some kept bin of lane tile t at tap a), by lane tile the steps'
  // live warps [nt, ns] (bit w: warp w meets a live tap), and the work
  // items (lane tile, channel tile, block tile, the steps walked lo | hi <<
  // 16), heaviest first
  const unsigned char* ttab;
  const unsigned char* tsteps;
  const int4* items;
  int nt, ns;
};

// The taps a CTA's lane tile does not keep are staged as zeros, copied
// from here (kLanes values of any filter dtype)
__device__ __align__(16) float kZeroTaps[kLanes] = {};

// Shared bytes, each region a multiple of 16: the filter ring [2, 2, ctf,
// kRing + kTail, kLanes] M, then kStages stages of history [kRows, 2, Ct,
// kLanes] T, scales [kRows, Ct] f32 (int storages) and live widths
// [kBlocks, kRows] int16. Mirrored by kernels/fused_step.py ::
// stream_mac_geometry.
struct MacLayout {
  int filt, hist, scl, wd;
  __host__ __device__ int stage() const { return hist + scl + wd; }
  __host__ __device__ int total() const { return filt + kStages * stage(); }
};

__host__ __device__ inline MacLayout mac_layout(int t_size, int m_size, int ct, int ctf, bool quant) {
  return MacLayout{4 * ctf * (kRing + kTail) * kLanes * m_size, kRows * 2 * ct * kLanes * t_size,
                   quant ? kRows * ct * 4 : 0, kBlocks * kRows * 2};
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n segments of kLanes elements E (lanes < nv of each) from src_of(s)
// (null: not needed) to dst_of(s), split over the CTA's threads in pieces
// of v bytes (v = 0: element by element, through registers, where the rows
// are not 4-byte aligned).
template <typename E, typename S, typename D>
__device__ __forceinline__ void stage_segments(int n, int nv, int v, S src_of, D dst_of) {
  if (v > 0) {
    const int lanes = v / static_cast<int>(sizeof(E));  // lanes a piece
    const int sh = __ffs(kLanes / lanes) - 1;           // log2(pieces a segment)
    for (int e = threadIdx.x; e < (n << sh); e += kMacThreads) {
      const int s = e >> sh, l0 = (e & ((1 << sh) - 1)) * lanes;
      if (l0 >= nv) continue;
      const E* src = src_of(s);
      if (src) cp_async(dst_of(s) + l0, src + l0, v);
    }
  } else {
    for (int e = threadIdx.x; e < n * kLanes; e += kMacThreads) {
      const int s = e / kLanes, l = e % kLanes;
      if (l >= nv) continue;
      const E* src = src_of(s);
      if (src) dst_of(s)[l] = src[l];
    }
  }
}

// The thread's NC history values of row r of a stage, widened to f32 and
// dequantized as x * (scale * inv_max).
template <typename T, int NC>
__device__ __forceinline__ void load_x(float (&xr)[NC], float (&xi)[NC], const T* hs, const float* ss,
                                       int r) {
  constexpr int Ct = 4 * NC;
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    xr[q] = to_f32(hs[(2 * r * Ct + 4 * q) * kLanes]);
    xi[q] = to_f32(hs[((2 * r + 1) * Ct + 4 * q) * kLanes]);
    if (Traits<T>::kQuant) {
      const float s = ss[r * Ct + 4 * q] * (1.0f / Traits<T>::kIntMax);
      xr[q] *= s;
      xi[q] *= s;
    }
  }
}

// A step in which each of the thread's blocks meets one filter half: fre /
// fim point at the
// value block 0 meets at row 0 (gre / gim: the same index in the half of
// the blocks j >= jw, kSplit), block j at row r reads index j - r. That is
// the value block j - 1 read at row r - 1, so the values slide through
// registers: a row loads block 0's value (and, kSplit, block jw's, where
// the blocks after a wrap of the ring meet the other half). kMasked: term
// (r, j) only where bit 16 j + r of live (two blocks a word) is set: its
// tap is in [0, P) and, with a schedule, live on the lane. The rows run
// in groups of kGroup unrolled rows: a fully
// unrolled step of 4 channels is ~2300 instructions, and warps running
// different variants of it at once thrash the instruction cache.
template <typename T, typename M, int NC, bool kSplit, bool kMasked>
__device__ __forceinline__ void mac_fast(float (&ar)[kMB][NC], float (&ai)[kMB][NC], const T* hs,
                                         const float* ss, const M* fre, const M* fim, const M* gre,
                                         const M* gim, int jw, const unsigned (&live)[kMB / 2]) {
  constexpr int Ct = 4 * NC;
  constexpr int kGroup = NC > 1 ? 4 : kRows;
  float fr[kMB], fi[kMB];
#pragma unroll
  for (int j = 0; j < kMB; ++j) {
    const bool g1 = kSplit && j >= jw;
    fr[j] = to_f32((g1 ? gre : fre)[j * kLanes]);
    fi[j] = to_f32((g1 ? gim : fim)[j * kLanes]);
  }
#pragma unroll 1
  for (int r0 = 0; r0 < kRows; r0 += kGroup) {
    const T* h = hs + r0 * 2 * Ct * kLanes;
    const float* sc = ss + r0 * Ct;
    unsigned lv[kMB / 2];
#pragma unroll
    for (int w = 0; w < kMB / 2; ++w) lv[w] = live[w] >> r0;
    const M *fr0 = fre - r0 * kLanes, *fi0 = fim - r0 * kLanes;
    const M *gr0 = gre + (jw - r0) * kLanes, *gi0 = gim + (jw - r0) * kLanes;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      float xr[NC], xi[NC];
      load_x<T, NC>(xr, xi, h, sc, i);
#pragma unroll
      for (int j = 0; j < kMB; ++j) {
        if (kMasked && !(lv[j / 2] >> (j % 2 * kRows + i) & 1u)) continue;
#pragma unroll
        for (int q = 0; q < NC; ++q) cmac(ar[j][q], ai[j][q], xr[q], xi[q], fr[j], fi[j]);
      }
      if (i < kGroup - 1 || r0 + kGroup < kRows) {  // the window of the next row
#pragma unroll
        for (int j = kMB - 1; j > 0; --j) {
          fr[j] = fr[j - 1];
          fi[j] = fi[j - 1];
        }
        fr[0] = to_f32(fr0[-(i + 1) * kLanes]);
        fi[0] = to_f32(fi0[-(i + 1) * kLanes]);
        if (kSplit) {
          const float vr = to_f32(gr0[-(i + 1) * kLanes]), vi = to_f32(gi0[-(i + 1) * kLanes]);
#pragma unroll
          for (int j = 1; j < kMB; ++j)
            if (j == jw) {
              fr[j] = vr;
              fi[j] = vi;
            }
        }
      }
    }
  }
}

// Any other step: each (block j, row r) checked for its tap a = u0 + j - d
// in [0, P), its filter half (d < thr_j: the upper one, 2 planes further)
// and, with a schedule, the live width wd[j * kRows + r] of the lane k.
// f0 points at slot 0 of the lower half's re plane.
template <typename T, typename M, int NC>
__device__ __forceinline__ void mac_general(float (&ar)[kMB][NC], float (&ai)[kMB][NC], const T* hs,
                                            const float* ss, const M* f0, int fplane, const short* wd,
                                            int k, int u0, int u_end, int d0, int P, int pos_first) {
  int thr[kMB];
#pragma unroll
  for (int j = 0; j < kMB; ++j) thr[j] = u0 + j - (pos_first + u0 + j) % P;
#pragma unroll 1
  for (int r = 0; r < kRows; ++r) {
    const int d = d0 + r;
    float xr[NC], xi[NC];
    load_x<T, NC>(xr, xi, hs, ss, r);
#pragma unroll
    for (int j = 0; j < kMB; ++j) {
      const int a = u0 + j - d;
      if (u0 + j >= u_end || a < 0 || a >= P) continue;
      if (wd && k >= wd[j * kRows + r]) continue;
      const M* f = f0 + (d < thr[j] ? 2 * fplane : 0) + (a % kRing) * kLanes;
      const float fr = to_f32(f[0]), fi = to_f32(f[fplane]);
#pragma unroll
      for (int q = 0; q < NC; ++q) cmac(ar[j][q], ai[j][q], xr[q], xi[q], fr, fi);
    }
  }
}

// One CTA's walk: lane tile `tile`, channel tile `ctile` of 4 NC channels,
// block tile `btile`. kTiles: a work item of stream_mac_tiles_kernel, which
// walks the steps [span & 0xFFFF, span >> 16): its first to its last live
// one.
template <typename T, typename M, int NC, bool kTiles>
__device__ __forceinline__ void stream_mac_cta(const MacArgs<T, M>& g, int tile, int ctile, int btile,
                                               int span) {
  constexpr bool kQuant = Traits<T>::kQuant;
  constexpr int Ct = 4 * NC;
  constexpr int kSlots = kRing + kTail;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool per_chan = g.Cf != 1;
  const int ctf = per_chan ? Ct : 1;
  const MacLayout lay = mac_layout(sizeof(T), sizeof(M), Ct, ctf, kQuant);
  const int fplane = ctf * kSlots * kLanes;  // one plane of one filter half
  M* const fring = reinterpret_cast<M*>(smem);

  const int P = g.P;
  const int kbase = tile * kLanes, c0 = ctile * Ct, u_base = btile * kBlocks;
  const int u_end = min(g.wc, u_base + kBlocks);  // the CTA's blocks [u_base, u_end)
  const int nv = min(kLanes, g.B - kbase);         // its lanes
  const int tid = threadIdx.x, warp = tid >> 5;
  const int l = tid & (kLanes - 1), cg = (tid >> 3) & 3;  // lane, channel group
  const int k = kbase + l;
  const int u0 = u_base + warp * kMB;  // the thread's blocks u0 .. u0 + kMB - 1
  const size_t row = static_cast<size_t>(g.C) * g.B;
  const size_t plane = static_cast<size_t>(P) * row;
  // history rows: from the oldest that block u_base meets to the newest block
  const int d_first = u_base - (P - 1), d_last = u_end - 1;
  const int nsteps = (d_last - d_first) / kRows + 1;
  const int s_lo = kTiles ? min(span & 0xFFFF, nsteps) : 0, s_hi = kTiles ? min(span >> 16, nsteps) : nsteps;
  // kTiles: the warps that hold blocks, and by stage the live ones (8 bits each)
  const unsigned warps_in = (1u << (u_end - u_base + kMB - 1) / kMB) - 1;
  unsigned warp_bits = 0;

  float ar[kMB][NC], ai[kMB][NC];
#pragma unroll
  for (int j = 0; j < kMB; ++j)
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int u = u0 + j, c = c0 + cg + 4 * q;
      const bool live = g.seed && u < u_end && c < g.C && l < nv;
      const size_t o = static_cast<size_t>(u) * 2 * row + static_cast<size_t>(c) * g.B + k;
      ar[j][q] = live ? g.seed[o] : 0.0f;
      ai[j][q] = live ? g.seed[o + row] : 0.0f;
    }

  unsigned live_bits = 0, full_bits = 0;  // by stage: the step has a live term / all its terms are live
  // schedules: ring positions of the thread's width-table blocks, and the
  // slot of its row in the next step to issue
  constexpr int kWdPer = kBlocks * kRows / kMacThreads, kWdStride = kMacThreads / kRows;
  int wpos[kWdPer];
#pragma unroll
  for (int q = 0; q < kWdPer; ++q) wpos[q] = (g.pos_first + u_base + tid / kRows + kWdStride * q) % P;
  int wslot = ((g.pos_first + d_first + tid % kRows) % P + P) % P;
  // step s: its first taps into the filter ring; with a schedule its live
  // widths; then (if any term is live) its history into stage s % kStages
  auto issue = [&](int s) {
    if (s < s_hi) {
      const int buf = s % kStages;
      unsigned char* st = smem + lay.filt + buf * lay.stage();
      const int d0 = d_first + s * kRows;
      {
        // taps [a0, a0 + n): the smallest the step meets (all of them for the first step)
        const int a0 = u_base - d0 - (kRows - 1), n = s != s_lo ? kRows : kBlocks + kRows - 1;
        const int pos_lo = (g.pos_first + u_base) % P;
        const bool wraps = pos_lo + (u_end - 1 - u_base) >= P;
        const int pos_min = wraps ? 0 : pos_lo, pos_max = wraps ? P - 1 : pos_lo + (u_end - 1 - u_base);
        // tap a meets the lower half for blocks at pos >= a, the upper one for pos < a
        auto src_of = [&](int sg) -> const M* {
          const int t = sg % n, q = sg / n, cl = q % ctf, hp = q / ctf, h = hp >> 1, pl = hp & 1;
          const int a = a0 + t, cf = per_chan ? c0 + cl : 0;
          if (a < 0 || a >= P || (h ? a <= pos_min : a > pos_max) || cf >= g.C) return nullptr;
          if (kTiles && !g.ttab[static_cast<size_t>(a) * g.nt + tile]) return reinterpret_cast<const M*>(kZeroTaps);
          return g.rim + (static_cast<size_t>((h ? 2 * P : P) - 1 - a) * g.Cf + cf) * 2 * g.B + pl * g.B + kbase;
        };
        auto slot_of = [&](int sg, int mirror) -> M* {
          const int t = sg % n, q = sg / n, slot = (a0 + t) % kRing + mirror * kRing;
          return fring + (q * kSlots + slot) * kLanes;
        };
        stage_segments<M>(4 * ctf * n, nv, g.vec_f, src_of, [&](int sg) { return slot_of(sg, 0); });
        stage_segments<M>(4 * ctf * n, nv, g.vec_f,  // and the mirrored slots
                          [&](int sg) -> const M* { return (a0 + sg % n) % kRing < kTail ? src_of(sg) : nullptr; },
                          [&](int sg) { return slot_of(sg, 1); });
      }
      int live = 1, full = 1;
      if (kTiles) {  // the step's live warps, from the table; every term of theirs is run
        const unsigned w = g.tsteps[static_cast<size_t>(tile) * g.ns + s] & warps_in;
        warp_bits = (warp_bits & ~(0xFFu << 8 * buf)) | w << 8 * buf;
        live = w != 0;
      } else if (g.wtab) {
        // entries (block tid / kRows + kWdStride q, row tid % kRows) of the
        // step's live widths; 0 where the tap is outside [0, P)
        short* wd = reinterpret_cast<short*>(st + lay.hist + lay.scl);
        const int kend = kbase + nv, d = d0 + tid % kRows, chunk = wslot / g.pc;
        int any = 0, all = 1;
#pragma unroll
        for (int q = 0; q < kWdPer; ++q) {
          const int u = u_base + tid / kRows + kWdStride * q, a = u - d;
          int w = 0;
          if (u < u_end && a >= 0 && a < P) {
            w = g.wtab[static_cast<size_t>(wpos[q]) * g.nchunks + chunk];
            any |= w > kbase;
            all &= w >= kend;
          }
          wd[tid + kMacThreads * q] = static_cast<short>(w);
        }
        wslot = (wslot + kRows) % P;
        live = __syncthreads_or(any);
        full = __syncthreads_and(all);
      }
      live_bits = (live_bits & ~(1u << buf)) | (live ? 1u << buf : 0u);
      full_bits = (full_bits & ~(1u << buf)) | (full ? 1u << buf : 0u);
      if (live) {
        T* hs = reinterpret_cast<T*>(st);
        stage_segments<T>(
            kRows * 2 * Ct, nv, g.vec_h,
            [&](int sg) -> const T* {
              const int cl = sg % Ct, pl = (sg / Ct) & 1, d = d0 + sg / (2 * Ct), c = c0 + cl;
              if (d > d_last || c >= g.C) return nullptr;
              if (d >= 0)
                return g.xnew + static_cast<size_t>(2 * d + pl) * row + static_cast<size_t>(c) * g.B + kbase;
              const int slot = g.pos_first + d < 0 ? g.pos_first + d + P : g.pos_first + d;
              return g.ring + pl * plane + static_cast<size_t>(slot) * row + static_cast<size_t>(c) * g.B + kbase;
            },
            [&](int sg) { return hs + sg * kLanes; });
        if (kQuant) {
          float* ss = reinterpret_cast<float*>(st + lay.hist);
          for (int e = tid; e < kRows * Ct; e += kMacThreads) {
            const int d = d0 + e / Ct, c = c0 + e % Ct;
            if (d > d_last || c >= g.C) continue;
            const int slot = g.pos_first + d < 0 ? g.pos_first + d + P : g.pos_first + d;
            cp_async(ss + e, d >= 0 ? g.snew + static_cast<size_t>(d) * g.C + c
                                    : g.scales + static_cast<size_t>(slot) * g.C + c, 4);
          }
        }
      }
    }
    cp_commit();
  };

  // the warp's blocks meet the upper half at rows d < thr0 (blocks j < jw) or
  // d < thr0 + P (j >= jw: the blocks after the ring wraps); jw = kMB: none wraps
  const int pos0 = (g.pos_first + u0) % P;
  const int thr0 = u0 - pos0, jw = min(kMB, P - pos0);
  const M* const f0 = fring + (per_chan ? cg : 0) * kSlots * kLanes + l;

#pragma unroll 1
  for (int s = s_lo; s < s_lo + kStages - 1; ++s) issue(s);
#pragma unroll 1
  for (int s = s_lo; s < s_hi; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();  // step s has landed; every thread is done with step s - 1's stage
    issue(s + kStages - 1);
    const int buf = s % kStages;
    const int d0 = d_first + s * kRows;
    const int umax = min(u0 + kMB, u_end) - 1;  // the warp's last block
    if (!(live_bits >> buf & 1) || umax < u0 || d0 > umax || d0 + kRows - 1 < u0 - (P - 1)) continue;
    if (kTiles && !(warp_bits >> (8 * buf + warp) & 1)) continue;
    const unsigned char* st = smem + lay.filt + buf * lay.stage();
    const T* hs = reinterpret_cast<const T*>(st) + cg * kLanes + l;
    const float* ss = reinterpret_cast<const float*>(st + lay.hist) + cg;
    // each block's half the same over the step
    const bool fast = u0 + kMB <= u_end && P >= kMB;
    const bool lo0 = d0 >= thr0, hi0 = d0 + kRows - 1 < thr0;
    const bool lo1 = d0 >= thr0 + P, hi1 = d0 + kRows - 1 < thr0 + P;
    const short* wd = reinterpret_cast<const short*>(st + lay.hist + lay.scl) + warp * kMB * kRows;
    if (fast && (lo0 || hi0) && (jw == kMB || lo1 || hi1)) {
      // block j at row r meets tap c - (r - j)
      const int c = u0 - d0;
      const bool full = full_bits >> buf & 1, all = full && c >= kRows - 1 && c <= P - kMB;
      unsigned live[kMB / 2] = {};
      if (!all) {  // bit 16 j + r: the tap in [0, P) and, mixed schedule, live on lane k
#pragma unroll
        for (int j = 0; j < kMB; ++j) {
          unsigned m = 0;
          if (full) {  // rows r with c + j - r in [0, P)
            const int lo = max(0, c + j - P + 1), hi = min(kRows - 1, c + j);
            m = hi < lo ? 0u : (2u << hi) - (1u << lo);
          } else {  // the widths are 0 where the tap is outside [0, P)
#pragma unroll
            for (int r = 0; r < kRows; ++r) m |= k < wd[j * kRows + r] ? 1u << r : 0u;
          }
          live[j / 2] |= m << (j % 2 * kRows);
        }
      }
      const M* fre = f0 + (((c - (kRows - 1)) % kRing + kRing) % kRing + kRows - 1) * kLanes;
      const int h0 = hi0 ? 2 * fplane : 0, h1 = hi1 ? 2 * fplane : 0;
      const bool split = !(jw == kMB || hi0 == hi1);
#define NEO_FAST(S, K) \
  mac_fast<T, M, NC, S, K>(ar, ai, hs, ss, fre + h0, fre + h0 + fplane, fre + h1, fre + h1 + fplane, jw, live)
      if (all && !split)
        NEO_FAST(false, false);
      else if (all)
        NEO_FAST(true, false);
      else if (!split)
        NEO_FAST(false, true);
      else
        NEO_FAST(true, true);
#undef NEO_FAST
    } else {
      mac_general<T, M, NC>(ar, ai, hs, ss, f0, fplane, !kTiles && g.wtab ? wd : nullptr, k, u0, u_end, d0,
                            P, g.pos_first);
    }
  }
  cp_wait<0>();
  if (l >= nv) return;
#pragma unroll
  for (int j = 0; j < kMB; ++j) {
    const int u = u0 + j;
    if (u >= u_end) break;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int c = c0 + cg + 4 * q;
      if (c >= g.C) break;
      float re = ar[j][q], im = ai[j][q];
      if (k == 0) {
        re = g.dcfix[static_cast<size_t>(u) * 2 * g.C + c];
        im = g.dcfix[static_cast<size_t>(u) * 2 * g.C + g.C + c];
      }
      float* o = g.acc + (static_cast<size_t>(u) * g.C + c) * 2 * g.B + k;
      o[0] = round_to<M>(re);
      o[g.B] = round_to<M>(im);
    }
  }
}

// grid (lane tiles of kLanes, channel tiles of 4 NC, block tiles of kBlocks)
template <typename T, typename M, int NC>
__global__ void __launch_bounds__(kMacThreads, 2) stream_mac_kernel(MacArgs<T, M> g) {
  stream_mac_cta<T, M, NC, false>(g, blockIdx.x, blockIdx.y, blockIdx.z, 1);
}

// ---- the scheduled MAC of a tap-tile table (B3 with a sparse filter)
//
// The chunk schedule bottoms out at lane widths of 128 (sparse_mac.py ::
// lane_widths), and a perceptual mask keeps its lowest bins in every
// partition, so every ring position keeps lanes < 128 at every tap: with
// the widths the CTAs of those lanes walk their whole history, and with
// one CTA a slot (256 CTAs, one wave on 132 SMs) the heaviest CTA is the
// kernel's time. This kernel takes instead a table by (tap, lane tile of
// kLanes), live where the filter keeps some bin of the tile at the tap. The
// tap is the partition, whatever the ring position, so the table and what
// it skips are the same in every window. From it the host builds, once a
// filter (kernels/fused_step.py :: stream_mac_plan): for each lane tile
// and step of kRows history rows, the warps that meet a live tap; and a
// list of work items, one a CTA, every (lane tile, channel tile of 4 NC,
// block tile) once, heaviest first: the hardware hands out the CTAs in
// list order, so the heavy items start first and the light ones fill the
// slots as they free (a list schedule, longest first). The host picks NC
// by the schedule's makespan: where one lane tile carries most of the
// work (a perceptual mask keeps its lowest bins at every tap) NC = 1
// spreads it over C / 4 CTAs, no item holding more than a quarter of a
// dense CTA's terms (at 1.48-1.51 times the cost a term of NC = 4, on the
// H100); where the tiles weigh alike (a band mask: a range of partitions)
// NC = 4 keeps the cheaper terms. B3 hands this kernel windows of two block
// tiles (kernels/fused_step.py :: TILES_WINDOWS), so the items of a lane
// tile live at every tap split by blocks as well.
//
// A warp runs a step only where the table says it meets a live tap, a CTA
// stages the history of a step only where some warp runs it, and it walks
// from its first live step to its last (the first one staging all the
// taps it meets, as the dense walk's first step does). A tap the
// lane tile does not keep is staged as zeros, so a live step runs the
// dense kernel's FFMAs on the filter with the tile's dead taps zeroed, in
// its order: the output is the dense kernel's on that filter, and on a
// filter masked by the same mask (the convolver's) the dense kernel's bits
// (a skipped step only adds exact zeros). No split over taps, no atomics.
template <typename T, typename M, int NC>
__global__ void __launch_bounds__(kMacThreads, 2) stream_mac_tiles_kernel(MacArgs<T, M> g) {
  const int4 it = g.items[blockIdx.x];
  stream_mac_cta<T, M, NC, true>(g, it.x, it.y, it.z, it.w);
}

template <typename T>
int launch_quantize(const void* s, void* x, void* scl, int rows, int C, int B, cudaStream_t st) {
  quantize_kernel<T><<<rows, kRowThreads, 0, st>>>(static_cast<const float*>(s), static_cast<T*>(x),
                                                   static_cast<float*>(scl), C, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_writeback(const void* x, const void* scl, void* fdl, void* scales, int P, int C, int B,
                     int wc, int pos_first, cudaStream_t st) {
  const int first = wc > P ? wc - P : 0;
  writeback_kernel<T><<<(wc - first) * C, kRowThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scl), static_cast<T*>(fdl),
      static_cast<float*>(scales), P, C, B, wc, first, pos_first);
  return static_cast<int>(cudaGetLastError());
}

// Allow a kernel more than 48 KB of shared memory, once per kernel and size.
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

template <typename T, typename M, int NC>
int launch_stream_mac_nc(const MacArgs<T, M>& g, int smem, cudaStream_t st) {
  static int smem_allowed = 48 * 1024;  // above 48 KB only once the kernel is allowed more
  const cudaError_t e = allow_smem(stream_mac_kernel<T, M, NC>, smem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((g.B + kLanes - 1) / kLanes, (g.C + 4 * NC - 1) / (4 * NC), (g.wc + kBlocks - 1) / kBlocks);
  stream_mac_kernel<T, M, NC><<<grid, kMacThreads, smem, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename M, int NC>
int launch_stream_mac_tiles(const MacArgs<T, M>& g, int n_items, int smem, cudaStream_t st) {
  static int smem_allowed = 48 * 1024;
  const cudaError_t e = allow_smem(stream_mac_tiles_kernel<T, M, NC>, smem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  stream_mac_tiles_kernel<T, M, NC><<<n_items, kMacThreads, smem, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// nc, vec_h, vec_f and smem come from kernels/fused_step.py ::
// stream_mac_geometry and the operands' alignment; checked here against
// the layout and the pointers. With work items the tiles kernel runs them.
template <typename T, typename M>
int launch_stream_mac(const MacArgs<T, M>& g, int nc, int n_items, int smem, cudaStream_t st) {
  const int ct = 4 * nc;
  const MacLayout lay = mac_layout(sizeof(T), sizeof(M), ct, g.Cf != 1 ? ct : 1, Traits<T>::kQuant);
  auto bad_vec = [&](int v, int elem, const void* p0, const void* p1) {
    return v != 0 && ((v != 4 && v != 8 && v != 16) || v > kLanes * elem || (g.B * elem) % v ||
                      reinterpret_cast<uintptr_t>(p0) % v || reinterpret_cast<uintptr_t>(p1) % v);
  };
  if ((nc != 1 && nc != 4) || (nc == 4 && g.Cf != 1) || smem != lay.total() ||
      bad_vec(g.vec_h, sizeof(T), g.ring, g.xnew) || bad_vec(g.vec_f, sizeof(M), g.rim, g.rim))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.items)
    return nc == 4 ? launch_stream_mac_tiles<T, M, 4>(g, n_items, smem, st)
                   : launch_stream_mac_tiles<T, M, 1>(g, n_items, smem, st);
  return nc == 4 ? launch_stream_mac_nc<T, M, 4>(g, smem, st) : launch_stream_mac_nc<T, M, 1>(g, smem, st);
}

bool bad_ring(int P, int C, int B) { return P < 1 || C < 1 || C > 65535 || B < 1; }

}  // namespace

// s [rows, 2B] f32 (rows = wc * C) -> x [wc, 2, C, B] storage dtype, scl [wc, C]
extern "C" int neo_fs_quantize(int storage, const void* s, void* x, void* scl, int rows, int C, int B,
                               void* stream) {
  if (rows < 1 || C < 1 || B < 1 || rows % C || ((storage == kInt16 || storage == kInt8) && !scl))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kSplit: return launch_quantize<float>(s, x, scl, rows, C, B, st);
    case kBf16: return launch_quantize<__nv_bfloat16>(s, x, scl, rows, C, B, st);
    case kInt16: return launch_quantize<int16_t>(s, x, scl, rows, C, B, st);
    case kInt8: return launch_quantize<int8_t>(s, x, scl, rows, C, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [wc, 2, C, B], scl [wc, C] or null -> fdl [2, P, C, B] slots (pos_first + i) % P, scales [P, C]
extern "C" int neo_fs_writeback(int storage, const void* x, const void* scl, void* fdl, void* scales,
                                int P, int C, int B, int wc, int pos_first, void* stream) {
  if (bad_ring(P, C, B) || wc < 1 || pos_first < 0 || pos_first >= P || (scl != nullptr) != (scales != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kSplit: return launch_writeback<float>(x, scl, fdl, scales, P, C, B, wc, pos_first, st);
    case kBf16: return launch_writeback<__nv_bfloat16>(x, scl, fdl, scales, P, C, B, wc, pos_first, st);
    case kInt16: return launch_writeback<int16_t>(x, scl, fdl, scales, P, C, B, wc, pos_first, st);
    case kInt8: return launch_writeback<int8_t>(x, scl, fdl, scales, P, C, B, wc, pos_first, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// c_idx, c_flags [P, L] int32 -> tab [P, nchunks] int32 live widths
extern "C" int neo_fs_widths(const void* c_idx, const void* c_flags, void* tab, int P, int L,
                             int nchunks, int B, int n_codes, void* stream) {
  if (P < 1 || L < 1 || nchunks < 1 || B < 1 || n_codes < 1) return static_cast<int>(cudaErrorInvalidValue);
  widths_kernel<<<P, kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(c_idx), static_cast<const int*>(c_flags), static_cast<int*>(tab), L,
      nchunks, B, n_codes);
  return static_cast<int>(cudaGetLastError());
}

// The time-batched MAC of one window: acc [wc, C, 2B] f32, rounded to the
// matrix dtype. seed [wc, 2, C, B] and wtab [P, nchunks] may be null. nc
// (channels a thread: 4, or 1 for per-channel filters; the tiles kernel's
// from its plan), vec_h / vec_f (the cp.async piece bytes of the history and
// filter tiles, 0 for element copies) and smem (dynamic shared bytes) from
// stream_mac_geometry. With a tap-tile table ttab [P, nt] (else null, and
// no wtab with it): its steps' live warps tsteps [nt, ns] and the n_items
// work items [n_items, 4] int32 of kernels/fused_step.py ::
// stream_mac_plan, which the tiles kernel runs.
extern "C" int neo_fs_stream_mac(int storage, const void* ring, const void* scales, const void* xnew,
                                 const void* snew, const void* rim, const void* seed,
                                 const void* dcfix, const void* wtab, const void* ttab, const void* tsteps,
                                 const void* items, void* acc, int P, int C, int B, int Cf, int wc,
                                 int pos_first, int pc, int nchunks, int nt, int ns, int n_items, int nc,
                                 int vec_h, int vec_f, int smem, void* stream) {
  const bool tiles = ttab != nullptr;
  if (bad_ring(P, C, B) || wc < 1 || (Cf != 1 && Cf != C) || pos_first < 0 || pos_first >= P ||
      (wtab && (pc < 1 || nchunks < 1 || nchunks * pc != P)) || tiles != (tsteps != nullptr) ||
      tiles != (items != nullptr) ||
      (tiles && (wtab || n_items < 1 || nt != (B + kLanes - 1) / kLanes || ns < (kBlocks + P - 2) / kRows + 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NEO_MAC(T, M)                                                                           \
  return launch_stream_mac<T, M>(                                                               \
      MacArgs<T, M>{static_cast<const T*>(ring), static_cast<const float*>(scales),             \
                    static_cast<const T*>(xnew), static_cast<const float*>(snew),               \
                    static_cast<const M*>(rim), static_cast<const float*>(seed),                \
                    static_cast<const float*>(dcfix), static_cast<const int*>(wtab),            \
                    static_cast<float*>(acc), P, C, B, Cf, wc, pos_first, pc, nchunks,          \
                    vec_h, vec_f, static_cast<const unsigned char*>(ttab),                      \
                    static_cast<const unsigned char*>(tsteps), static_cast<const int4*>(items), \
                    nt, ns},                                                                    \
      nc, n_items, smem, st)
  switch (storage) {
    case kSplit: NEO_MAC(float, float);
    case kBf16: NEO_MAC(__nv_bfloat16, __nv_bfloat16);
    case kInt16: NEO_MAC(int16_t, float);
    case kInt8: NEO_MAC(int8_t, __nv_bfloat16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NEO_MAC
}

// One block's MAC over S splits of per slots: part [S, 2, C, K]. The
// filter: (p, c, k) at fre / fim + p * f_row + c * f_c + k; wrow [P / pc]
// or null; vec lanes a thread (1, or 16 / sizeof(storage) with K % vec == 0
// and 16-byte-aligned rows).
extern "C" int neo_fs_step_mac(int storage, const void* ring, const void* scales, const void* fre,
                               const void* fim, long long f_row, long long f_c, const void* wrow,
                               void* part, int P, int C, int K, int pc, int S, int per, int vec,
                               void* stream) {
  if (bad_ring(P, C, K) || S < 1 || S > 65535 || per < 1 || static_cast<long long>(S) * per < P ||
      (wrow && (pc < 1 || P % pc)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NEO_STEP(T, M)                                                                            \
  {                                                                                               \
    const StepArgs<T, M> g{static_cast<const T*>(ring), static_cast<const float*>(scales),       \
                           static_cast<const M*>(fre), static_cast<const M*>(fim), f_row, f_c,   \
                           static_cast<const int*>(wrow), nullptr, static_cast<float*>(part),    \
                           P, C, K, pc, per, 1, 1};                                              \
    return wrow ? launch_step_mac<T, M, kWidths>(g, S, vec, st)                              \
                : launch_step_mac<T, M, kDense>(g, S, vec, st);                               \
  }
  switch (storage) {
    case kSplit: NEO_STEP(float, float);
    case kBf16: NEO_STEP(__nv_bfloat16, __nv_bfloat16);
    case kInt16: NEO_STEP(int16_t, float);
    case kInt8: NEO_STEP(int8_t, __nv_bfloat16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NEO_STEP
}

// part [S, 2, C, K] -> acc [C, 2K] rounded to the matrix dtype (mat_bf16),
// lane 0 from dcfix [2, C] when given
extern "C" int neo_fs_step_reduce(int mat_bf16, const void* part, const void* dcfix, void* acc, int S,
                                  int C, int K, void* stream) {
  if (S < 1 || C < 1 || K < 1 || (mat_bf16 != 0 && mat_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return mat_bf16 ? launch_step_reduce<__nv_bfloat16>(part, dcfix, acc, S, C, K, 2 * K, K, st)
                  : launch_step_reduce<float>(part, dcfix, acc, S, C, K, 2 * K, K, st);
}

extern "C" int neo_transform(int mat_bf16, int inverse, const void* in, int i_inner, long long i_so,
                             long long i_si, void* out, int o_inner, long long o_so, long long o_si,
                             const void* tw, int rows, int B, int n_out, void* stream);

// B2 in one call: the stage launches of one block on one stream (a block's
// device time is ~0.1 ms, so a launch per stage from the host would cost
// more than the work). frame [C, N], y [C, N]; tw the transforms' twiddles
// W_N^q [N] float2; c_idx / c_flags the [P, L] chunk tables or null. The
// wrapper allocates the staging: spec, acc [C, 2B] f32; x [2, C, B] storage
// dtype; scl [C] f32 (int storages, else null); mpart [S, 2, C, B] f32; tab
// [P, P / pc] int32 (with a schedule, else null). S / per / vec are
// step_mac's geometry. counts [7] gets one added per stage as its launch
// succeeds: window_forward, quantize_rows, ring_writeback, sched_widths,
// step_mac, step_reduce, window_inverse.
extern "C" int neo_fused_block_step(int storage, const void* frame, void* fdl, const void* rim,
                                    void* scales, const void* dcfix, const void* tw, void* y,
                                    const void* c_idx, const void* c_flags, void* spec, void* x, void* scl,
                                    void* mpart, void* acc, void* tab, int* counts, int P, int C, int B,
                                    int Cf, int pos, int L, int pc, int n_codes, int S, int per, int vec,
                                    void* stream) {
  const bool quant = storage == kInt16 || storage == kInt8;
  const bool sched = c_idx != nullptr;
  if (bad_ring(P, C, B) || pos < 0 || pos >= P || (Cf != 1 && Cf != C) || quant != (scales != nullptr) ||
      quant != (scl != nullptr) || sched != (c_flags != nullptr) || sched != (tab != nullptr) ||
      (sched && (L < 1 || pc < 1 || P % pc)) || !tw || !spec || !x || !mpart || !acc || !counts ||
      storage < kSplit || storage > kInt8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = 2 * B;
  const bool mat_bf16 = storage == kBf16 || storage == kInt8;
  const size_t msize = mat_bf16 ? 2 : 4;
  int* wtab = static_cast<int*>(tab);
  // each stage adds to its count only when its launch returned no error
  int err = 0;
  auto stage = [&](int which, int code) {
    err = code;
    if (!err) ++counts[which];
  };
  // 1. forward: row c at frame + c * N, spectrum row c at spec + c * 2B
  stage(0, neo_transform(mat_bf16, 0, frame, 1, n, 0, spec, 1, n, 0, tw, C, B, n, stream));
  // 2-3. quantize into the staged row, then insert it as ring row pos
  if (!err) stage(1, neo_fs_quantize(storage, spec, x, scl, C, C, B, stream));
  if (!err) stage(2, neo_fs_writeback(storage, x, scl, fdl, scales, P, C, B, 1, pos, stream));
  // 4. the MAC over P splits (row pos of the schedule's widths), reduced in order
  if (!err && sched) stage(3, neo_fs_widths(c_idx, c_flags, wtab, P, L, P / pc, B, n_codes, stream));
  const char* fre = static_cast<const char*>(rim) + static_cast<size_t>(P - 1 - pos) * Cf * n * msize;
  if (!err)
    stage(4, neo_fs_step_mac(storage, fdl, scales, fre, fre + B * msize, static_cast<long long>(Cf) * n,
                             Cf == 1 ? 0 : n, sched ? wtab + static_cast<size_t>(pos) * (P / pc) : nullptr,
                             mpart, P, C, B, sched ? pc : 1, S, per, vec, stream));
  if (!err) stage(5, neo_fs_step_reduce(mat_bf16, mpart, dcfix, acc, S, C, B, stream));
  // 5. inverse: all N samples of each channel
  if (!err) stage(6, neo_transform(mat_bf16, 1, acc, 1, n, 0, y, 1, n, 0, tw, C, B, n, stream));
  return err;
}
