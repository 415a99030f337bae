// B3's time-batched MAC on its dense route: stream_mac_dense_kernel.
//
// The route: a filter shared by the channels (Cf = 1), no chunk schedule and
// no tap-tile table (kernels/fused_step.py :: stream_mac_route). Every other
// launch of stream_mac runs stream_mac_kernel or stream_mac_tiles_kernel
// (fused_step.cu), whose cost a term calibrates stream_mac_plan.
//
// Replaces, on that route, the MAC of neojax/kernels/fused_step.py ::
// fused_stream (the `accumulate` of _mk_stream_kernel). The function and the
// sums are stream_mac_kernel's: block i of the window (ring position pos_i)
// sums seed_i + sum over the taps a < P of filt_i[a] * X[i - a], where history
// row d = i - a is the window's staged row d (d >= 0) or ring slot
// (pos_first + d) mod P, and tap a meets rim row P - 1 - a when a <= pos_i,
// else 2P - 1 - a (rows d < thr_i = i - pos_i meet the upper half). Each
// (block, channel, lane) is one f32 accumulator, seeded, taking its taps by
// ascending history row through cmac; a term the kept kernel skips (tap
// outside [0, P)) is here an exact zero. So the outputs equal
// stream_mac_kernel's bit for bit, apart from the sign of a zero.
//
// Bound: operations, 8 flops a (block, tap, channel, lane): 16.1 GFLOP for
// the headline window (64 blocks, P = 960, C = 64, B = 512), 0.24 ms at the
// H100's 67 TFLOP/s of f32 FFMA; the ring's bytes, read once, 0.075 ms. Each
// of an SM's four schedulers issues one instruction a clock and its FP32
// pipe takes one warp FFMA a clock, so the design is about the instructions
// that are not FFMAs, and about never stalling both warps of a scheduler:
//
// - Tile. A CTA owns kLanes = 8 lanes x kCt = 16 channels x kBlocks = 64
//   blocks (stream_mac_kernel's tile and grid) and walks the history rows its
//   blocks meet, oldest first, in steps of kRows = 16, one barrier a step. A
//   warp is 8 consecutive blocks over the whole 8 x 16 tile; a thread keeps
//   8 blocks x 2 lanes x 2 channels (cc and cc + 8) in registers, so a
//   history value feeds 8 blocks and a filter value 2 channels. A row is 4
//   history loads of two lanes (8 bytes in f32, from the ring's own
//   [channel, lane] layout, conflict-free) and 2 filter loads for 128 FFMAs.
// - One inner step. Taps outside [0, P) and history rows past the window are
//   staged as zeros (never stale: a stale NaN times a zero tap is NaN), so
//   every row of every step runs the same FFMAs, with no per-term checks.
//   Block j at row r meets the tap block j - 1 met at row r - 1 (T's
//   diagonal), so the filter values slide through 8 register slots, block j
//   at row r in slot (j - r) mod 8, with the rows unrolled by 8: a row loads
//   block 0's new tap into the slot block 7 has left, and moves no register.
//   A step runs one straight-line body, chosen per warp and step (a branch
//   or a runtime slot inside the rows makes the compiler shuffle the slots
//   and accumulators between registers): the slide; the slide that also
//   reloads block K from its own half each row, where the CTA's 64 blocks
//   straddle a wrap of the ring at block K of a warp (past the wrap a warp's
//   blocks meet the other half; every warp of the CTA runs this body, since
//   two bodies on one scheduler overflow its instruction cache, and for the
//   others the reload is the value they slid); and, in a step holding a row
//   where a block's rim half changes (row thr of the warp's blocks; thr + P
//   past a wrap), the body that reloads every slot from its block's half,
//   each row. A warp's first step loads its 8 slots once, then slides.
// - Staging. cp.async, kStages = 4 deep, once a step after the barrier: the
//   step's history tile [16 rows, 2 planes, 16 channels, 8 lanes] (storage
//   dtype; int scales [16, 16]) and the 16 taps it meets first, of both rim
//   halves, into a ring of kRing tap slots (tap a at slot a mod kRing, the
//   first kTail slots mirrored past the end, so a step's taps are
//   contiguous). Each thread's pieces, pointers and shared offsets are set
//   up once from its index; a step adds its rows. Zeros by cp.async's
//   zero-fill, so the copies are straight-line code.
// - Registers. One CTA of 256 threads an SM (launch bounds): up to 255
//   registers a thread and no spills (64 accumulators, 32 filter slots, the
//   row's history and the next row's). Two CTAs an SM (128 registers) spill
//   and run slower.
//
// Four instances, one a storage: (float, float), (bf16, bf16), (int16, float)
// and (int8, bf16).
#include <type_traits>

#include "step_mac.cuh"

namespace {

using namespace neo;

namespace dense {
constexpr int kLanes = 8;                       // lanes a CTA
constexpr int kNC = 2;                          // channels a thread: cc + 8 h, h < kNC
constexpr int kCt = 8 * kNC;                    // channels a CTA
constexpr int kMB = 8;                          // consecutive blocks a warp (and a thread)
constexpr int kBlocks = 64;                     // blocks a CTA
constexpr int kRows = 16;                       // history rows a step
constexpr int kStages = 4;                      // cp.async stages
constexpr int kRing = 128;                      // tap slots: >= the kBlocks + kRows - 1 taps of a step
                                                // and the (kStages - 1) kRows staged ahead
constexpr int kTail = 32;                       // mirrored slots: a step reads slots up to kRing + 22
constexpr int kSlots = kRing + kTail;
constexpr int kThreads = 32 * kBlocks / kMB;    // 256
constexpr int kFPlane = kSlots * kLanes;        // elements of one (half, plane) of the tap ring
constexpr int kReload = kMB;                    // the step body that reloads every filter slot
static_assert(kBlocks + kRows - 1 + (kStages - 1) * kRows <= kRing, "tap ring too small");
static_assert((kStages & (kStages - 1)) == 0, "a step's stage is s & (kStages - 1)");
}  // namespace dense

template <typename T, typename M>
struct DenseArgs {
  const T* ring;        // [2, P, C, B]
  const float* scales;  // [P, C] (int storages)
  const T* xnew;        // [wc, 2, C, B] staged rows of this window
  const float* snew;    // [wc, C]
  const M* rim;         // [2P, 1, 2B]
  const float* seed;    // [wc, 2, C, B] or null
  const float* dcfix;   // [wc, 2, C]
  float* acc;           // [wc, C, 2B]
  int P, C, B, wc, pos_first;
  int vec_h, vec_f;     // cp.async piece bytes of history and filter (16, 8 for int8 history; 0: elements)
};

// Shared bytes, each region a multiple of 16: the tap ring [2 halves, 2
// planes, kSlots, kLanes] M, then kStages stages of history [kRows, 2, kCt,
// kLanes] T and (int storages) scales [kRows, kCt] f32. Mirrored by
// kernels/fused_step.py :: stream_mac_dense_geometry.
struct DenseLayout {
  int filt, hist, scl;
  __host__ __device__ int stage() const { return hist + scl; }
  __host__ __device__ int total() const { return filt + dense::kStages * stage(); }
};

__host__ __device__ inline DenseLayout dense_layout(int t_size, int m_size, bool quant) {
  using namespace dense;
  return DenseLayout{4 * kFPlane * m_size, kRows * 2 * kCt * kLanes * t_size, quant ? kRows * kCt * 4 : 0};
}

// Two adjacent lanes of a staged row (the first at p, 2-element aligned), widened to f32.
__device__ __forceinline__ void lanes2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void lanes2(const __nv_bfloat16* p, float& a, float& b) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ void lanes2(const int16_t* p, float& a, float& b) {
  const int w = *reinterpret_cast<const int*>(p);
  a = static_cast<float>(static_cast<int16_t>(w));
  b = static_cast<float>(w >> 16);
}
__device__ __forceinline__ void lanes2(const int8_t* p, float& a, float& b) {
  const int w = *reinterpret_cast<const short*>(p);
  a = static_cast<float>(static_cast<int8_t>(w));
  b = static_cast<float>(w >> 8);
}

// One element from src, or a zero where src is null.
template <typename E>
__device__ __forceinline__ void put(E* dst, const E* src) {
  if (src)
    *dst = *src;
  else if constexpr (sizeof(E) == 4)
    *reinterpret_cast<unsigned*>(dst) = 0u;
  else if constexpr (sizeof(E) == 2)
    *reinterpret_cast<unsigned short*>(dst) = 0;
  else
    *reinterpret_cast<unsigned char*>(dst) = 0;
}

// grid (lane tiles of kLanes, channel tiles of kCt, block tiles of kBlocks)
template <typename T, typename M>
__global__ void __launch_bounds__(dense::kThreads, 1) stream_mac_dense_kernel(DenseArgs<T, M> g) {
  using namespace dense;
  constexpr bool kQuant = Traits<T>::kQuant;
  constexpr int kRowElems = 2 * kCt * kLanes;  // a history row of a stage: [2 planes, kCt, kLanes]
  extern __shared__ __align__(16) unsigned char smem[];
  const DenseLayout lay = dense_layout(sizeof(T), sizeof(M), kQuant);
  M* const fring = reinterpret_cast<M*>(smem);

  const int P = g.P, C = g.C, B = g.B;
  const int kbase = blockIdx.x * kLanes, c0 = blockIdx.y * kCt, u_base = blockIdx.z * kBlocks;
  const int u_end = min(g.wc, u_base + kBlocks);  // the CTA's blocks [u_base, u_end)
  const int nv = min(kLanes, B - kbase);          // its lanes
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lp = tid & 3, cc = (tid >> 2) & 7;  // lanes 2 lp, 2 lp + 1 and channels cc + 8 h of the tile
  const int u0 = u_base + warp * kMB;                   // the thread's blocks u0 .. u0 + kMB - 1
  const size_t row = static_cast<size_t>(C) * B;
  const size_t plane = static_cast<size_t>(P) * row;
  // history rows: from the oldest that block u_base meets to the newest block
  const int d_first = u_base - (P - 1), d_last = u_end - 1;
  const int nsteps = (d_last - d_first) / kRows + 1;

  float ar[kMB][2][kNC], ai[kMB][2][kNC];  // [block][lane][channel]
#pragma unroll
  for (int j = 0; j < kMB; ++j)
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int h = 0; h < kNC; ++h) {
        const int u = u0 + j, c = c0 + cc + 8 * h, l = 2 * lp + v;
        const bool live = g.seed && u < u_end && c < C && l < nv;
        const size_t o = static_cast<size_t>(u) * 2 * row + static_cast<size_t>(c) * B + kbase + l;
        ar[j][v][h] = live ? g.seed[o] : 0.0f;
        ai[j][v][h] = live ? g.seed[o + row] : 0.0f;
      }

  // The thread's copies of a step, fixed by its index (set up once): kHN
  // history pieces of kHLP lanes (16 bytes; 8 for int8) of the stage's
  // [kRows, 2, kCt, kHPS] pieces, piece tid + kThreads i at row hr0 + kHRS i
  // of plane hpl, channel hch, lanes hl0 ..; with tid < kFN, the filter
  // piece (tap ft of the step's kRows, segment (half, plane) fhp, lanes fl0
  // ..) of kFLP lanes (16 bytes); int storages, the scale of row tid / kCt,
  // channel tid % kCt.
  constexpr int kHLP = 16 / sizeof(T) < kLanes ? 16 / sizeof(T) : kLanes, kHPS = kLanes / kHLP;
  constexpr int kHN = 2 * kRows * kCt * kHPS / kThreads, kHRS = kRows / kHN;
  constexpr int kFLP = 16 / sizeof(M), kFPS = kLanes / kFLP, kFN = 4 * kRows * kFPS;
  const int hl0 = tid % kHPS * kHLP, hch = tid / kHPS % kCt, hpl = tid / (kHPS * kCt) % 2, hr0 = tid / (2 * kHPS * kCt);
  const bool h_ok = c0 + hch < C;
  const size_t h_col = static_cast<size_t>(c0 + hch) * B + kbase + hl0;
  const T* const h_new = g.xnew + hpl * row + h_col;     // + 2 d row: staged row d >= 0
  const T* const h_old = g.ring + hpl * plane + h_col;   // + slot row: ring slot of row d < 0
  T* const h_dst = reinterpret_cast<T*>(smem + lay.filt) + (hpl * kCt + hch) * kLanes + hl0;  // + r kRowElems
  const int ft = tid / kFPS % kRows, fhp = tid / (kFPS * kRows), fl0 = tid % kFPS * kFLP;
  const M* const f_src = g.rim + static_cast<size_t>(((fhp >> 1) ? 2 * P : P) - 1) * 2 * B + (fhp & 1) * B + kbase + fl0;
  M* const f_dst = fring + fhp * kSlots * kLanes + fl0;  // + slot kLanes
  const int s_c = c0 + tid % kCt;

  // A piece of n lanes from src to dst, zeros where src is null (base: any
  // readable address of the operand); kVec: one cp.async (16-byte aligned
  // operands), else element by element.
  auto piece = [&](auto vec_tag, auto* dst, const auto* src, const auto* base, int n, int l0) {
    if constexpr (decltype(vec_tag)::value) {
      cp_async_zfill(dst, src ? src : base, n * static_cast<int>(sizeof(*dst)), src != nullptr && l0 < nv);
    } else {
      for (int e = 0; e < n; ++e) put(dst + e, src && l0 + e < nv ? src + e : nullptr);
    }
  };
  // taps [a0, a0 + kRows) of both halves and planes; zeros outside [0, P)
  auto taps = [&](auto vec_tag, int a0) {
    if (tid < kFN) {
      const int a = a0 + ft, slot = a & (kRing - 1);
      const M* src = a >= 0 && a < P ? f_src - static_cast<size_t>(a) * 2 * B : nullptr;
      piece(vec_tag, f_dst + slot * kLanes, src, g.rim, kFLP, fl0);
      if (slot < kTail) piece(vec_tag, f_dst + (slot + kRing) * kLanes, src, g.rim, kFLP, fl0);
    }
  };
  // step s: the taps it meets first, its history rows (zeros past d_last) and scales
  auto issue_with = [&](auto vec_tag, int s) {
    const int d0 = d_first + s * kRows;
    taps(vec_tag, u_base - d0 - (kRows - 1));
    const int buf = (s & (kStages - 1)) * lay.stage();
#pragma unroll
    for (int i = 0; i < kHN; ++i) {
      const int r = hr0 + kHRS * i, d = d0 + r;
      const int slot = g.pos_first + d < 0 ? g.pos_first + d + P : g.pos_first + d;
      const T* src = !h_ok || d > d_last ? nullptr
                     : d >= 0            ? h_new + 2 * static_cast<size_t>(d) * row
                                         : h_old + static_cast<size_t>(slot) * row;
      piece(vec_tag, reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(h_dst) + buf) + r * kRowElems, src, g.ring,
            kHLP, hl0);
    }
    if (kQuant) {
      const int d = d0 + tid / kCt;
      const bool valid = s_c < C && d <= d_last;
      const int slot = g.pos_first + d < 0 ? g.pos_first + d + P : g.pos_first + d;
      const float* src = !valid ? g.scales : d >= 0 ? g.snew + static_cast<size_t>(d) * C + s_c
                                                    : g.scales + static_cast<size_t>(slot) * C + s_c;
      cp_async_zfill(reinterpret_cast<float*>(smem + lay.filt + buf + lay.hist) + tid, src, 4, valid);
    }
  };
  const bool vec = g.vec_h && g.vec_f;
  auto issue = [&](int s) {
    if (s < nsteps) {
      if (vec)
        issue_with(std::true_type{}, s);
      else
        issue_with(std::false_type{}, s);
    }
    cp_commit();
  };

  // the warp's blocks: block j meets the upper half at rows d < thr_j = u0 +
  // j - pos_j; thr_j = thr0 before a wrap of the ring (j < jw), thr0 + P after
  // (P >= kMB: at most one wrap in a warp; jw = kMB: none)
  const int pos0 = (g.pos_first + u0) % P;
  const int thr0 = u0 - pos0, jw = min(kMB, P - pos0);
  const bool split_warp = P >= kMB && jw < kMB;
  // The CTA's wrap of the ring inside a warp, if any (P >= kBlocks: at most
  // one in the tile): its first block past the wrap, kw, is the block every
  // warp of the CTA reloads from its own half each row between switch rows,
  // so that all run one body (two bodies at once on a scheduler thrash its
  // instruction cache). For another warp that reload is the value it slid.
  const int kw = P < kBlocks ? 0 : (P - (g.pos_first + u_base) % P) % P;
  const int cta_k = kw < u_end - u_base ? kw % kMB : 0;
  // its steps: from the first that meets its oldest row to the last that meets a block of it
  const bool live_warp = u0 < u_end;
  const int s_w0 = (u0 - (P - 1) - d_first) / kRows, s_w1 = (min(u0 + kMB - 1, d_last) - d_first) / kRows;
  const M* const fl = fring + 2 * lp;  // the thread's lanes in the tap ring
  float fr[kMB][2], fi[kMB][2];        // slot k: the tap of block j at row r, k = (j - r) mod 8

  for (int t = 0; t < 4; ++t) {  // the taps step 0 meets above its own
    if (vec)
      taps(std::true_type{}, u_base - d_first + 1 + t * kRows);
    else
      taps(std::false_type{}, u_base - d_first + 1 + t * kRows);
  }
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) issue(s);
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();  // step s has landed; every thread is done with step s - 1's stage
    issue(s + kStages - 1);
    if (!live_warp || s < s_w0 || s > s_w1) continue;
    const int d0 = d_first + s * kRows;
    const unsigned char* st = smem + lay.filt + (s & (kStages - 1)) * lay.stage();
    const T* const hs = reinterpret_cast<const T*>(st) + cc * kLanes + 2 * lp;  // channel cc; cc + 8: + 8 kLanes
    const float* const ss = reinterpret_cast<const float*>(st + lay.hist) + cc;
    // block j at row r meets tap cst + j - r, at slot sb + j - r of the ring
    const int cst = u0 - d0;
    const int sb = ((cst - (kRows - 1)) & (kRing - 1)) + kRows - 1;
    const M* const pb = fl + (d0 < thr0 ? 2 * kFPlane : 0) + sb * kLanes;  // block 0's tap at row 0

    // a switch row (thr0; thr0 + P past a wrap) in the step
    auto in_step = [&](int d) { return d >= d0 && d < d0 + kRows; };
    const bool reload = P < kMB || in_step(thr0) || (split_warp && in_step(thr0 + P));
    // the body: the CTA's block past a wrap; else (P < kBlocks: a tile may
    // hold several wraps) a warp past a wrap reloads its own first block past it
    const int kb = reload ? kReload : cta_k ? cta_k : split_warp && d0 > thr0 && d0 < thr0 + P ? jw : 0;
    // block kb's tap at row 0 - kb, from its half (rows d < thr0, or thr0 + P past the wrap, meet the upper one)
    const M* const pk = fl + (d0 < thr0 + (kb >= jw ? P : 0) ? 2 * kFPlane : 0) + sb * kLanes;
    // The step's rows in one straight-line body (no branch inside; each
    // slot stays in its register): K = 0 slides; K in [1, kMB) also
    // reloads block K (the CTA's first past a wrap of the ring) from its own
    // half; kReload reloads every slot from its block's half (a step that
    // holds a switch row, P < kMB). A warp's first step without one primes
    // the slots for its row 0, then slides.
    auto rows = [&](auto kind) {
      constexpr int K = decltype(kind)::value;
#pragma unroll 1
      for (int g8 = 0; g8 < kRows; g8 += 8) {
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const int r = g8 + rr;
          float xr[2][kNC], xi[2][kNC];  // [lane][channel]
#pragma unroll
          for (int h = 0; h < kNC; ++h) {
            lanes2(hs + r * kRowElems + 8 * h * kLanes, xr[0][h], xr[1][h]);
            lanes2(hs + r * kRowElems + (kCt + 8 * h) * kLanes, xi[0][h], xi[1][h]);
            if (kQuant) {
              const float sc = ss[r * kCt + 8 * h] * (1.0f / Traits<T>::kIntMax);
#pragma unroll
              for (int v = 0; v < 2; ++v) {
                xr[v][h] *= sc;
                xi[v][h] *= sc;
              }
            }
          }
          if constexpr (K == kReload) {
            const int d = d0 + r;
#pragma unroll
            for (int j = 0; j < kMB; ++j) {
              const int pj = pos0 + j;
              const int thr = u0 + j - (pj < P ? pj : P >= kMB ? pj - P : pj % P);
              const M* q = fl + (d < thr ? 2 * kFPlane : 0) + (sb - r + j) * kLanes;
              lanes2(q, fr[(j - rr) & 7][0], fr[(j - rr) & 7][1]);
              lanes2(q + kFPlane, fi[(j - rr) & 7][0], fi[(j - rr) & 7][1]);
            }
          } else {
            const int k0 = (8 - rr) & 7;  // block 0's new tap, into the slot block 7 left
            lanes2(pb - r * kLanes, fr[k0][0], fr[k0][1]);
            lanes2(pb + kFPlane - r * kLanes, fi[k0][0], fi[k0][1]);
            if constexpr (K > 0) {
              const int kk = (K - rr) & 7;
              const M* q = pk + (K - r) * kLanes;
              lanes2(q, fr[kk][0], fr[kk][1]);
              lanes2(q + kFPlane, fi[kk][0], fi[kk][1]);
            }
          }
#pragma unroll
          for (int j = 0; j < kMB; ++j) {
            const int k = (j - rr) & 7;
#pragma unroll
            for (int v = 0; v < 2; ++v)
#pragma unroll
              for (int h = 0; h < kNC; ++h) cmac(ar[j][v][h], ai[j][v][h], xr[v][h], xi[v][h], fr[k][v], fi[k][v]);
          }
        }
      }
    };
    if (s == s_w0 && !reload) {  // the warp's first step: every slot from its block's half, for row 0
#pragma unroll
      for (int j = 0; j < kMB; ++j) {
        const M* q = fl + (d0 < thr0 + (j >= jw ? P : 0) ? 2 * kFPlane : 0) + (sb + j) * kLanes;
        lanes2(q, fr[j][0], fr[j][1]);
        lanes2(q + kFPlane, fi[j][0], fi[j][1]);
      }
    }
    switch (kb) {
      case 0: rows(std::integral_constant<int, 0>{}); break;
      case 1: rows(std::integral_constant<int, 1>{}); break;
      case 2: rows(std::integral_constant<int, 2>{}); break;
      case 3: rows(std::integral_constant<int, 3>{}); break;
      case 4: rows(std::integral_constant<int, 4>{}); break;
      case 5: rows(std::integral_constant<int, 5>{}); break;
      case 6: rows(std::integral_constant<int, 6>{}); break;
      case 7: rows(std::integral_constant<int, 7>{}); break;
      default: rows(std::integral_constant<int, kReload>{}); break;
    }
  }
  cp_wait<0>();
  if (!live_warp) return;
#pragma unroll
  for (int j = 0; j < kMB; ++j) {
    const int u = u0 + j;
    if (u >= u_end) break;
#pragma unroll
    for (int h = 0; h < kNC; ++h) {
      const int c = c0 + cc + 8 * h;
      if (c >= C) continue;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int k = kbase + 2 * lp + v;
        if (2 * lp + v >= nv) continue;
        float re = ar[j][v][h], im = ai[j][v][h];
        if (k == 0) {
          re = g.dcfix[static_cast<size_t>(u) * 2 * C + c];
          im = g.dcfix[static_cast<size_t>(u) * 2 * C + C + c];
        }
        float* o = g.acc + (static_cast<size_t>(u) * C + c) * 2 * B + k;
        o[0] = round_to<M>(re);
        o[B] = round_to<M>(im);
      }
    }
  }
}

template <typename T, typename M>
int launch_dense(const DenseArgs<T, M>& g, int smem, cudaStream_t st) {
  using namespace dense;
  static int smem_allowed = 48 * 1024;  // above 48 KB only once the kernel is allowed more
  const cudaError_t e = allow_smem(stream_mac_dense_kernel<T, M>, smem, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((g.B + kLanes - 1) / kLanes, (g.C + kCt - 1) / kCt, (g.wc + kBlocks - 1) / kBlocks);
  stream_mac_dense_kernel<T, M><<<grid, kThreads, smem, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// vec_h, vec_f and smem come from kernels/fused_step.py ::
// stream_mac_dense_geometry and the operands' alignment; checked here
// against the layout and the pointers.
template <typename T, typename M>
int launch_dense_checked(const DenseArgs<T, M>& g, int smem, cudaStream_t st) {
  using namespace dense;
  const bool quant = Traits<T>::kQuant;
  // pieces of 16 bytes (8 lanes of int8), or 0: element by element
  auto bad_vec = [&](int v, int elem, const void* p0, const void* p1) {
    return v != 0 && (v != (16 < kLanes * elem ? 16 : kLanes * elem) || (g.B * elem) % v ||
                      reinterpret_cast<uintptr_t>(p0) % v || reinterpret_cast<uintptr_t>(p1) % v);
  };
  if (smem != dense_layout(sizeof(T), sizeof(M), quant).total() || quant != (g.scales != nullptr) ||
      quant != (g.snew != nullptr) || bad_vec(g.vec_h, sizeof(T), g.ring, g.xnew) ||
      bad_vec(g.vec_f, sizeof(M), g.rim, g.rim))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dense<T, M>(g, smem, st);
}

}  // namespace

// The time-batched MAC of one window on the dense route: acc [wc, C, 2B] f32,
// rounded to the matrix dtype; rim [2P, 1, 2B] (a shared filter); seed
// [wc, 2, C, B] may be null. vec_h / vec_f (the cp.async piece bytes of the
// history and filter segments, 0 for element copies) and smem (dynamic shared
// bytes) from stream_mac_dense_geometry.
extern "C" int neo_fs_stream_mac_dense(int storage, const void* ring, const void* scales, const void* xnew,
                                       const void* snew, const void* rim, const void* seed, const void* dcfix,
                                       void* acc, int P, int C, int B, int wc, int pos_first, int vec_h, int vec_f,
                                       int smem, void* stream) {
  if (P < 1 || C < 1 || B < 1 || wc < 1 || pos_first < 0 || pos_first >= P ||
      (C + dense::kCt - 1) / dense::kCt > 65535 || (wc + dense::kBlocks - 1) / dense::kBlocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NEO_DENSE(T, M)                                                                                 \
  return launch_dense_checked<T, M>(                                                                    \
      DenseArgs<T, M>{static_cast<const T*>(ring), static_cast<const float*>(scales),                   \
                      static_cast<const T*>(xnew), static_cast<const float*>(snew),                     \
                      static_cast<const M*>(rim), static_cast<const float*>(seed),                      \
                      static_cast<const float*>(dcfix), static_cast<float*>(acc), P, C, B, wc, pos_first, \
                      vec_h, vec_f},                                                                    \
      smem, st)
  switch (storage) {
    case kSplit: NEO_DENSE(float, float);
    case kBf16: NEO_DENSE(__nv_bfloat16, __nv_bfloat16);
    case kInt16: NEO_DENSE(int16_t, float);
    case kInt8: NEO_DENSE(int8_t, __nv_bfloat16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NEO_DENSE
}
