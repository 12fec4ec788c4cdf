// The staged wide-lane greedy merge: the exact sequential greedy
// moment-matched merge at any lane count, for merge2d.cu (N > 8192),
// merge3d.cu and merge4d.cu (N > 2048), which the narrow kernels cannot
// hold: they keep a particle's unmerged lanes as one 32-bit mask word a
// thread (32 x 256 or 32 x 64 lanes), and merge3d / merge4d stage every
// lane's values in shared memory.
//
// What bounds it on Hopper. The work a particle needs is small (its act
// plane read once, each entering lane's 1 + D + kCov values once, a few
// distances a lane): 0.007 ms for the mixed full grid's launch (P = 512,
// N = 4256) and 0.104 ms for the dense full grid's (P = 1024, N = 74 824,
// the act plane's 306 MB) at the H100's 3.35 TB/s. What sets the time is
// latency: the act plane read in a chain of dependent loads, and a chain
// of tens of greedy rounds, each two block barriers long. The first
// design staged in chunks of one lane a thread with a barrier
// each (293 dependent loads a block at the dense full grid), kept each
// entry's state in a byte of device memory and read the entries past the
// shared ones from the particle's input planes through their lane index,
// and walked every staged entry in both passes of every round, merged or
// not.
//
// Design: one block a particle.
//   - Staging reads the act plane kU = 32 chunks of kThreads lanes at a
//     time (32 independent loads a thread in flight, one barrier a step) and
//     compacts the lanes that enter (act > 0.5, and w > 0 in sorted mode;
//     every act lane in argmax mode) into one block-wide list of entries
//     in lane order. Entry e < E keeps its kVals = 1 + D + kCov values in
//     dynamic shared memory ([value][E]) and its state in a byte there;
//     a later one goes to a dense scratch ``spill`` [kVals][X] and a
//     state byte ``gstate`` [X] that the caller provides, written in
//     entry order (coalesced). After staging no round reads the input
//     planes. E comes from the plan (wide_plan): an equal share of an
//     SM's shared memory among the blocks the launch needs resident. The
//     staging also ranks each thread's candidates for the first round.
//   - The rounds are the narrow kernels' (pallas_merge.py's validity
//     chain, kR tentative principals: 8 in merge2d and merge3d, 4 in
//     merge4d, as measured at the paths' shapes): the kR best free
//     entries (sorted: the lowest; argmax: the heaviest with w > 0, ties
//     to the lowest lane) are the tentative principals, principal r is
//     valid when no earlier valid principal covers it, the first K - c
//     valid ones emit, and an entry joins the first emitted principal
//     that covers it: the exact sequential clusters in sequential order.
//     A round: every warp picks the block's kR from the warps' lists
//     alike; pass 1 over the list tests each free entry against the
//     emitted principals (the IEEE distances of the narrow kernels; a 3D
//     or 4D distance's quotients by merge_core.cuh's Recip, IEEE division
//     only where it declines), sums the zeroth and first moments of those
//     that join, ranks the rest into the thread's list of its kR best for
//     the next round (argmax mode: notes an unmerged NaN weight) and
//     counts them; the warps' transposed reductions and barrier A; the
//     means; pass 2 sums the second moments about them; barrier B.
//   - Compaction: once the free entries are at most half the list, or
//     first fit into the shared entries, they are moved down to the
//     list's front in order (in steps of kThreads entries, through
//     registers) and re-ranked there, so that a pass walks at most twice
//     the entries still free, and they leave the spill as soon as they
//     fit in shared memory.
// Argmax mode stalls as the narrow kernels do: a round with no principal
// or with an unmerged NaN weight ends the row, whose remaining entries are
// then dropped (left 0).
//
// The sums are each thread's entries ascending, the butterfly's pairs and
// the warps in order, as in the narrow kernels, but over another dealing
// of the lanes (and a new one after each compaction): the clusters are
// the same, their f32 sums may differ from the narrow kernels' (and from
// the first design's) in the last bits.
//
// G supplies kDim, kCov, kPlanes, kOutPlanes, kHellinger and
// dist<kFast>(d, S, ok) (the Mahalanobis form on the averaged covariance)
// or hell(d, A, B), as merge_core.cuh's distances do.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "merge_core.cuh"

namespace phd_wide {

// staging: chunks of kThreads lanes a step, one bit each of a thread's
// mask, one lane each of a warp's prefix scan
constexpr int kU = 32;
// resident blocks an SM the registers must allow: P = 512 particles in
// one wave of 128-thread blocks (4 an SM of 132)
template <int kThreads>
constexpr int kMinBlocks = kThreads == 128 ? 4 : 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned char kFree = 0xff;  // an entry's state: not merged yet
constexpr unsigned char kDone = 0xfe;  // merged in an earlier round

using phd_merge::pick;
using phd_merge::warp_transpose_sum;

// The staged entries of one particle (see the header): positions below E
// in shared memory, the others in the caller's scratch
template <int kVals>
struct Entries {
  float* sm;                  // [kVals][E] in shared memory
  unsigned char* sst;         // [E] states in shared memory
  int E;
  float* spill;               // [kVals][X] (global scratch), or null
  unsigned char* gst;         // [X] states (global scratch), or null
  int X;

  __device__ __forceinline__ float get(int v, int e) const {
    return e < E ? sm[v * E + e] : spill[v * X + (e - E)];
  }
  __device__ __forceinline__ void put(int v, int e, float x) const {
    if (e < E)
      sm[v * E + e] = x;
    else
      spill[v * X + (e - E)] = x;
  }
  __device__ __forceinline__ unsigned char& state(int e) const {
    return e < E ? sst[e] : gst[e - E];
  }
};

// The block's shared scratch
template <class G, int kThreads, int kR>
struct Shared {
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPV = G::kDim + G::kCov;  // a principal's values
  static constexpr int kPassA = ((1 + G::kDim) * kR + 31) / 32;
  static constexpr int kPassB = (G::kCov * kR + 31) / 32;
  unsigned cand_h[2][kWarps][kR];  // each warp's best free entries: key
  int cand_e[2][kWarps][kR];       // (sorted: 1; argmax: w's bits), entry
  int cand_n[2][kWarps];
  int cand_nan[2][kWarps];         // argmax: an unmerged NaN weight
  float pv[kWarps][kR][kPV];       // warp q's copy of the principals
  int pe[kWarps][kR];              // and their entries (-1: none)
  float red_a[kWarps][32 * kPassA];
  float red_b[kWarps][32 * kPassB];
  float mu[kWarps][G::kDim][kR];   // warp q's copy of the round's means
  unsigned ball[2][kU][kWarps];    // staging / compaction: a warp's ballots
  int base[kWarps][kU];            // staging: chunk u's first entry (warp q)
  int keep[kWarps];                // the free entries a round leaves
};

// Ranks free entry e (key h > 0) into this thread's list of its kR best,
// best first: a larger key, or (entries ascending) an earlier entry
template <int kR>
__device__ __forceinline__ void consider(unsigned h, int e,
                                         unsigned (&kh)[kR], int (&ke)[kR]) {
  if (h <= kh[kR - 1]) return;
#pragma unroll
  for (int r = kR - 1; r > 0; --r) {
    if (h > kh[r - 1]) {
      kh[r] = kh[r - 1];
      ke[r] = ke[r - 1];
    } else if (h > kh[r]) {
      kh[r] = h;
      ke[r] = e;
    }
  }
  if (h > kh[0]) {
    kh[0] = h;
    ke[0] = e;
  }
}

// Publishes the warp's kR best of its threads' lists into buffer ``b``
// (the lists are used up) and whether any thread saw a NaN weight
template <class G, int kThreads, int kR>
__device__ __forceinline__ void publish(unsigned (&kh)[kR], int (&ke)[kR],
                                        bool nan_seen, int b,
                                        Shared<G, kThreads, kR>& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int n = 0;
#pragma unroll 1
  for (; n < kR; ++n) {
    const unsigned top = __reduce_max_sync(kFull, kh[0]);
    if (top == 0) break;
    const unsigned mine = kh[0] == top ? static_cast<unsigned>(ke[0])
                                       : UINT_MAX;
    const unsigned best = __reduce_min_sync(kFull, mine);
    if (mine == best) {                 // the winning thread pops its head
#pragma unroll
      for (int r = 0; r < kR - 1; ++r) {
        kh[r] = kh[r + 1];
        ke[r] = ke[r + 1];
      }
      kh[kR - 1] = 0;
    }
    if (lane == 0) {
      sh.cand_h[b][warp][n] = top;
      sh.cand_e[b][warp][n] = static_cast<int>(best);
    }
  }
  nan_seen = __any_sync(kFull, nan_seen);
  if (lane == 0) {
    sh.cand_n[b][warp] = n;
    sh.cand_nan[b][warp] = nan_seen;
  }
}

// a free entry's key: sorted mode every entry (the lowest leads), argmax
// mode its weight's bits where w > 0 (the heaviest leads)
template <bool kArgmax>
__device__ __forceinline__ unsigned key_of(float w) {
  return kArgmax ? (w > 0.f ? __float_as_uint(w) : 0u) : 1u;
}

// The distance of a candidate (mean m, covariance c) to a principal (its
// D means, then its kCov covariances, at pv): d = mean_p - m, the averaged
// covariance (c + cov_p) / 2 (kFast: merge_core.cuh's Recip quotients,
// which clear ok where they may not be the IEEE ones), or the Hellinger
// form
template <class G, bool kFast>
__device__ __forceinline__ float dist_to(const float* pv,
                                         const float (&m)[G::kDim],
                                         const float (&c)[G::kCov],
                                         bool& ok) {
  float d[G::kDim], sg[G::kCov];
#pragma unroll
  for (int k = 0; k < G::kDim; ++k) d[k] = pv[k] - m[k];
  if constexpr (G::kHellinger) {
#pragma unroll
    for (int q = 0; q < G::kCov; ++q) sg[q] = pv[G::kDim + q];
    return G::hell(d, c, sg);
  } else {
#pragma unroll
    for (int q = 0; q < G::kCov; ++q) sg[q] = 0.5f * (c[q] + pv[G::kDim + q]);
    return G::template dist<kFast>(d, sg, ok);
  }
}

// Stages the lanes of one particle that enter (``enter(i)``; their values
// from ``load(i, v)``: w, the D means, the kCov covariances) into the
// block's list in lane order, kU chunks of kThreads lanes a step (the act
// loads all in flight before the step's one barrier; lane u of each warp
// then scans chunk u's counts), and ranks each thread's entries into its
// list of the kR best (kh, ke; in argmax mode nan_seen notes a NaN
// weight). Returns the entry count.
template <class G, int kThreads, int kR, bool kArgmax, class Enter,
          class Load>
__device__ __forceinline__ int stage(int N,
                                     const Entries<1 + G::kDim + G::kCov>& en,
                                     Shared<G, kThreads, kR>& sh, Enter enter,
                                     Load load, unsigned (&kh)[kR],
                                     int (&ke)[kR], bool& nan_seen) {
  constexpr int kVals = 1 + G::kDim + G::kCov;
  constexpr int kWarps = kThreads / 32;
  static_assert(kU == 32, "a chunk a lane of the scan");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  int n_e = 0, parity = 0;
  for (int i0 = 0; i0 < N; i0 += kU * kThreads, parity ^= 1) {
    unsigned in = 0;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads + tid;
      in |= static_cast<unsigned>(i < N && enter(i)) << u;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const unsigned b = __ballot_sync(kFull, (in >> u) & 1u);
      if (lane == 0) sh.ball[parity][u][warp] = b;
    }
    __syncthreads();
    // lane u: chunk u's entries in the warps before this one and in all,
    // then the step's entries before chunk u (an exclusive scan)
    int before = 0, total = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const int n = __popc(sh.ball[parity][lane][q]);
      before += q < warp ? n : 0;
      total += n;
    }
    int scan = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, scan, d);
      if (lane >= d) scan += t;
    }
    sh.base[warp][lane] = n_e + scan - total + before;
    n_e += __shfl_sync(kFull, scan, 31);
    __syncwarp();
    for (unsigned m = in; m != 0u; m &= m - 1u) {
      const int u = __ffs(m) - 1;
      const int e =
          sh.base[warp][u] + __popc(sh.ball[parity][u][warp] & below);
      float v[kVals];
      load(i0 + u * kThreads + tid, v);
#pragma unroll
      for (int c = 0; c < kVals; ++c) en.put(c, e, v[c]);
      en.state(e) = kFree;
      consider<kR>(key_of<kArgmax>(v[0]), e, kh, ke);
      nan_seen |= kArgmax && isnan(v[0]);
    }
  }
  return n_e;
}

// Moves the n_keep free entries among the first n_f down to positions
// 0 .. n_keep - 1 in order (through registers, kThreads entries a step)
// and ranks each thread's moved entries into its list (kh, ke, nan_seen)
template <class G, int kThreads, int kR, bool kArgmax>
__device__ __forceinline__ void compact(
    const Entries<1 + G::kDim + G::kCov>& en, int n_f,
    Shared<G, kThreads, kR>& sh, unsigned (&kh)[kR], int (&ke)[kR],
    bool& nan_seen) {
  constexpr int kVals = 1 + G::kDim + G::kCov;
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int out = 0, parity = 0;
  for (int s0 = 0; s0 < n_f; s0 += kThreads, parity ^= 1) {
    const int e = s0 + static_cast<int>(threadIdx.x);
    const bool keep = e < n_f && en.state(e) == kFree;
    float v[kVals];
    if (keep) {
#pragma unroll
      for (int c = 0; c < kVals; ++c) v[c] = en.get(c, e);
    }
    const unsigned ball = __ballot_sync(kFull, keep);
    if (lane == 0) sh.ball[parity][0][warp] = ball;
    // every read of this step precedes every write: a write goes to a
    // position below s0 + kThreads, a later step reads above it
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const int n = __popc(sh.ball[parity][0][q]);
      before += q < warp ? n : 0;
      total += n;
    }
    if (keep) {
      const int d = out + before + __popc(ball & ((1u << lane) - 1u));
#pragma unroll
      for (int c = 0; c < kVals; ++c) en.put(c, d, v[c]);
      en.state(d) = kFree;
      consider<kR>(key_of<kArgmax>(v[0]), d, kh, ke);
      nan_seen |= kArgmax && isnan(v[0]);
    }
    out += total;
  }
}

// The greedy rounds over the n_e staged entries (see the header), whose
// first-round lists (kh, ke, nan_seen) staging ranked, writing the
// particle's output planes o [G::kOutPlanes, K]
template <class G, int kThreads, int kR, bool kArgmax>
__device__ void wide_rounds(const Entries<1 + G::kDim + G::kCov>& en,
                            int n_e, unsigned (&kh)[kR], int (&ke)[kR],
                            bool nan_seen, float* o, int K, float min_sep,
                            Shared<G, kThreads, kR>& sh) {
  constexpr int D = G::kDim;
  constexpr int kCov = G::kCov;
  constexpr int kWarps = kThreads / 32;
  constexpr int kPV = D + kCov;
  constexpr int kSumsA = (1 + D) * kR;
  constexpr int kSumsB = kCov * kR;
  constexpr int kPassA = Shared<G, kThreads, kR>::kPassA;
  constexpr int kPassB = Shared<G, kThreads, kR>::kPassB;
  constexpr int kPerLane = (kWarps * kR + 31) / 32;
  static_assert(kR * (kR - 1) / 2 <= 32, "principal pairs: one ballot");
  static_assert((kR & (kR - 1)) == 0, "kR: a power of two");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  publish<G, kThreads, kR>(kh, ke, nan_seen, 0, sh);
  __syncthreads();

  // the list: positions 0 .. n_f - 1, n_free of them free
  int n_f = n_e, n_free = n_e;
  int c = 0, b = 0;
  while (c < K) {
    // ---- the block's kR tentative principals from the warps' lists,
    // chosen by every warp alike (lane x holds entries x and x + 32 of the
    // flat [kWarps][kR] list) ----
    int n_tent = 0, mine_p = -1;
    {
      unsigned ch[kPerLane], ce[kPerLane];
      bool stall = false;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) stall |= kArgmax && sh.cand_nan[b][q];
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int f = lane + 32 * u;
        const bool there = f < kWarps * kR && f % kR < sh.cand_n[b][f / kR];
        ch[u] = there ? (&sh.cand_h[b][0][0])[f] : 0u;
        ce[u] = there ? static_cast<unsigned>((&sh.cand_e[b][0][0])[f])
                      : UINT_MAX;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        unsigned m = 0;
#pragma unroll
        for (int u = 0; u < kPerLane; ++u) m = max(m, ch[u]);
        const unsigned top = __reduce_max_sync(kFull, m);
        unsigned lo = UINT_MAX;
#pragma unroll
        for (int u = 0; u < kPerLane; ++u)
          if (ch[u] == top) lo = min(lo, ce[u]);
        const unsigned best =
            top == 0 ? UINT_MAX : __reduce_min_sync(kFull, lo);
#pragma unroll
        for (int u = 0; u < kPerLane; ++u) {
          if (ce[u] == best) {
            ch[u] = 0;
            ce[u] = UINT_MAX;
          }
        }
        if (lane == r) mine_p = best == UINT_MAX ? -1 : static_cast<int>(best);
        if (best != UINT_MAX) n_tent = r + 1;
      }
      if (stall) n_tent = 0;
    }
    if (n_tent == 0) break;
    // this warp's copy of the principals' values
    if (lane < kR) {
      sh.pe[warp][lane] = mine_p;
#pragma unroll
      for (int v = 0; v < kPV; ++v)
        sh.pv[warp][lane][v] = mine_p >= 0 ? en.get(1 + v, mine_p) : 0.f;
    }
    __syncwarp();

    // ---- validity chain: lane p tests pair p = r (r - 1) / 2 + s, s < r:
    // principal r as the candidate against principal s ----
    unsigned covered;
    {
      int r = 1, s = lane;
#pragma unroll
      for (int x = 1; x < kR; ++x) {
        if (s >= x) {
          s -= x;
          ++r;
        }
      }
      bool cov = false;
      if (lane < kR * (kR - 1) / 2 && r < n_tent) {
        float m[D], cv[kCov];
        const float* pr = sh.pv[warp][r];
#pragma unroll
        for (int k = 0; k < D; ++k) m[k] = pr[k];
#pragma unroll
        for (int q = 0; q < kCov; ++q) cv[q] = pr[D + q];
        bool ok = true;
        float d = dist_to<G, true>(sh.pv[warp][s], m, cv, ok);
        if (!ok) d = dist_to<G, false>(sh.pv[warp][s], m, cv, ok);
        cov = d < min_sep;
      }
      covered = __ballot_sync(kFull, cov);
    }
    unsigned emit = 0;
    {
      unsigned valid = 0;
      int budget = K - c;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        bool ok = r < n_tent;
#pragma unroll
        for (int s = 0; s < r; ++s) {
          if (((valid >> s) & 1u) && ((covered >> (r * (r - 1) / 2 + s)) & 1u))
            ok = false;
        }
        if (ok) {
          valid |= 1u << r;
          if (budget > 0) {
            emit |= 1u << r;
            --budget;
          }
        }
      }
    }

    // ---- pass 1: membership, the first moments, the next round's lists
    // and the free entries left ----
    float va[kPassA][32];
#pragma unroll
    for (int u = 0; u < kPassA; ++u) {
#pragma unroll
      for (int x = 0; x < 32; ++x) va[u][x] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) kh[r] = 0;
    nan_seen = false;
    int n_keep = 0;
    for (int e = tid; e < n_f; e += kThreads) {
      unsigned char& st = en.state(e);
      if (st != kFree) continue;
      float m[D], cv[kCov];
#pragma unroll
      for (int k = 0; k < D; ++k) m[k] = en.get(1 + k, e);
#pragma unroll
      for (int q = 0; q < kCov; ++q) cv[q] = en.get(1 + D + q, e);
      // emit is block-uniform: the branches do not diverge
      unsigned hit = 0, redo = 0;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if ((emit >> r) & 1u) {
          bool ok = true;
          const float d = dist_to<G, true>(sh.pv[warp][r], m, cv, ok);
          hit |= static_cast<unsigned>(d < min_sep || e == sh.pe[warp][r])
                 << r;
          redo |= static_cast<unsigned>(!ok) << r;
        }
      }
      for (; redo; redo &= redo - 1) {
        const int r = __ffs(redo) - 1;
        bool ok = true;
        const float d = dist_to<G, false>(sh.pv[warp][r], m, cv, ok);
        const bool in = d < min_sep || e == sh.pe[warp][r];
        hit = (hit & ~(1u << r)) | (static_cast<unsigned>(in) << r);
      }
      const float w = en.get(0, e);
      if (hit) {
        const int who = __ffs(hit) - 1;
        st = static_cast<unsigned char>(who);
        float t[1 + D];
        t[0] = w;
#pragma unroll
        for (int k = 0; k < D; ++k) t[1 + k] = w * m[k];
#pragma unroll
        for (int x = 0; x < kSumsA; ++x) {
          float& v = va[x / 32][x % 32];
          v = pick(x % kR == who, v + t[x / kR], v);
        }
      } else {
        consider<kR>(key_of<kArgmax>(w), e, kh, ke);
        nan_seen |= kArgmax && isnan(w);
        ++n_keep;
      }
    }
#pragma unroll
    for (int u = 0; u < kPassA; ++u)
      sh.red_a[warp][32 * u + lane] = warp_transpose_sum(va[u], lane);
    n_keep = __reduce_add_sync(kFull, n_keep);
    if (lane == 0) sh.keep[warp] = n_keep;
    publish<G, kThreads, kR>(kh, ke, nan_seen, b ^ 1, sh);
    __syncthreads();                                 // barrier A

    // sum 32 u + lane of the block (warps in order); lane's cluster is
    // lane % kR in every pass, its W sum lane % kR of pass 0
    float tot[kPassA];
#pragma unroll
    for (int u = 0; u < kPassA; ++u) {
      tot[u] = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) tot[u] += sh.red_a[q][32 * u + lane];
    }
    n_free = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) n_free += sh.keep[q];
    const int r_mine = lane & (kR - 1);
    const bool emit_mine = (emit >> r_mine) & 1u;
    const int slot = c + __popc(emit & ((1u << r_mine) - 1u));
    const float w_safe = fmaxf(__shfl_sync(kFull, tot[0], r_mine), 1e-30f);
#pragma unroll
    for (int u = 0; u < kPassA; ++u) {
      const int x = 32 * u + lane;
      if (x < kSumsA) {
        const int comp = x / kR;
        const float res = comp == 0 ? tot[u] : tot[u] / w_safe;
        if (warp == 0 && emit_mine) o[comp * K + slot] = res;
        if (comp > 0) sh.mu[warp][comp - 1][r_mine] = res;
      }
    }
    __syncwarp();

    // ---- pass 2: second moments about the merged means ----
    float vb[kPassB][32];
#pragma unroll
    for (int u = 0; u < kPassB; ++u) {
#pragma unroll
      for (int x = 0; x < 32; ++x) vb[u][x] = 0.f;
    }
    for (int e = tid; e < n_f; e += kThreads) {
      unsigned char& st = en.state(e);
      const int who = st;
      if (who >= kR) continue;
      st = kDone;
      const float w = en.get(0, e);
      float dd[D];
#pragma unroll
      for (int k = 0; k < D; ++k)
        dd[k] = sh.mu[warp][k][who] - en.get(1 + k, e);
      float t[kCov];
      {
        int q = 0;
#pragma unroll
        for (int a = 0; a < D; ++a) {
#pragma unroll
          for (int f = a; f < D; ++f, ++q)
            t[q] = w * (en.get(1 + D + q, e) + dd[a] * dd[f]);
        }
      }
#pragma unroll
      for (int x = 0; x < kSumsB; ++x) {
        float& v = vb[x / 32][x % 32];
        v = pick(x % kR == who, v + t[x / kR], v);
      }
    }
#pragma unroll
    for (int u = 0; u < kPassB; ++u)
      sh.red_b[warp][32 * u + lane] = warp_transpose_sum(vb[u], lane);
    __syncthreads();                                 // barrier B

    if (warp == 0 && emit_mine) {
#pragma unroll
      for (int u = 0; u < kPassB; ++u) {
        const int x = 32 * u + lane;
        float m = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) m += sh.red_b[q][x];
        if (x < kSumsB) o[(1 + D + x / kR) * K + slot] = m / w_safe;
      }
    }
    c += __popc(emit);
    b ^= 1;
    // ---- compaction (block-uniform): the free entries to the front,
    // their lists ranked again at their new positions ----
    if (c < K && n_free > 0
        && (2 * n_free <= n_f || (n_f > en.E && n_free <= en.E))) {
#pragma unroll
      for (int r = 0; r < kR; ++r) kh[r] = 0;
      nan_seen = false;
      compact<G, kThreads, kR, kArgmax>(en, n_f, sh, kh, ke, nan_seen);
      // the lists pass 1 published name the old positions: replaced
      publish<G, kThreads, kR>(kh, ke, nan_seen, b, sh);
      n_f = n_free;
      __syncthreads();
    }
  }

  // the entries left unmerged: none when the row ended with budget left
  // (sorted mode: all merged; argmax mode: a stall drops them)
  const int n_left = c >= K ? n_free : 0;
  for (int k = c + tid; k < K; k += kThreads) {
#pragma unroll
    for (int v = 0; v < 1 + D; ++v) o[v * K + k] = 0.f;
    int q = 0;
#pragma unroll
    for (int a = 0; a < D; ++a) {
#pragma unroll
      for (int f = a; f < D; ++f, ++q) o[(1 + D + q) * K + k] = a == f;
    }
  }
  for (int k = tid; k < K; k += kThreads) {
    o[(1 + D + kCov) * K + k] = static_cast<float>(n_left);
#pragma unroll
    for (int v = 2 + D + kCov; v < G::kOutPlanes; ++v) o[v * K + k] = 0.f;
  }
}

// Packed planes [P, G::kPlanes, N] in: the act plane is read for every
// lane, the rest for the entering lanes only, once (the first E into
// shared memory, the others into ``spill`` [P, kVals, X] and ``gstate``
// [P, X], X = N - E: the plan's overflow)
template <class G, int kThreads, int kR, bool kArgmax>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kThreads>)
wide_kernel(const float* __restrict__ packed, float* __restrict__ out,
            float* __restrict__ spill, unsigned char* __restrict__ gstate,
            int N, int K, float min_sep, int E, int X) {
  constexpr int kVals = 1 + G::kDim + G::kCov;
  extern __shared__ float s[];                  // [kVals][E], [E] states
  __shared__ Shared<G, kThreads, kR> sh;
  const size_t p = blockIdx.x;
  const float* in = packed + p * G::kPlanes * N;
  const Entries<kVals> en{
      s, reinterpret_cast<unsigned char*>(s + kVals * E), E,
      X > 0 ? spill + p * kVals * X : nullptr,
      X > 0 ? gstate + p * X : nullptr, X};
  unsigned kh[kR];
  int ke[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) kh[r] = 0;
  bool nan_seen = false;
  const int n_e = stage<G, kThreads, kR, kArgmax>(
      N, en, sh,
      [&](int i) { return in[N + i] > 0.5f && (kArgmax || in[i] > 0.f); },
      [&](int i, float (&v)[kVals]) {
        v[0] = in[i];
#pragma unroll
        for (int c = 1; c < kVals; ++c) v[c] = in[(c + 1) * N + i];
      },
      kh, ke, nan_seen);
  wide_rounds<G, kThreads, kR, kArgmax>(en, n_e, kh, ke, nan_seen,
                                        out + p * G::kOutPlanes * K, K,
                                        min_sep, sh);
}

// The launch plan of a wide kernel (the layout of merge2d's plan): threads
// a block, entries a block keeps in shared memory (E), dynamic shared
// memory a block (bytes), resident blocks an SM, entries that may lie past
// E (X = N - E: the spill's entries a particle), registers a thread,
// waves. As many resident blocks an SM as P needs (at most what the
// registers allow), each with an equal share of the SM's shared memory,
// up to N entries of kVals floats and a state byte. The dynamic shared
// memory attribute is raised to the opt-in once a device, never past it.
struct Plan {
  int threads, entries, smem, blocks_per_sm, overflow, registers, waves;
};

// dynamic shared memory of E entries of kVals floats and a state byte
template <int kVals>
constexpr int entries_smem(int E) {
  return static_cast<int>(sizeof(float)) * kVals * E + E;
}

template <int kThreads, int kVals, auto kernel>
int wide_plan(int P, int N, Plan& plan) {
  constexpr int kDevices = 16;
  static bool raised[kDevices] = {};
  int dev = 0, sms = 0, smem_sm = 0, optin = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int static_smem = static_cast<int>(attr.sharedSizeBytes);
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = true;
  }
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                    0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int want = std::max(1, std::min(occ, (P + sms - 1) / sms));
  const int share =
      std::min(smem_sm / want - reserved, optin) - static_smem;
  int E = std::min(N, std::max(share, 0) / entries_smem<kVals>(1));
  // the allocation granularity can cost a block its last entries
  for (;; E = std::max(E - 64, 0)) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, kThreads, entries_smem<kVals>(E));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ >= want || E == 0) break;
  }
  if (occ == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_wave = occ * sms;
  plan = Plan{kThreads, E, entries_smem<kVals>(E), occ, N - E,
              attr.numRegs, (std::max(P, 1) + per_wave - 1) / per_wave};
  return 0;
}

// Launches wide_kernel<G, kThreads, kR, kArgmax> over P particles of N
// lanes (any N; spill: [P, kVals, X] floats and gstate [P, X] bytes, X
// the plan's overflow, both null when X is 0), or with ``report`` only
// writes its plan. kR, the tentative principals a round: the validity
// chain tests kR (kR - 1) / 2 pairs, one a lane of a warp, so kR <= 8;
// each source picks it by measurement at its path shape.
template <class G, int kThreads, int kR, bool kArgmax>
int launch(const float* packed, float* out, float* spill,
           unsigned char* gstate, int P, int N, int K, float min_sep,
           void* stream, Plan* report) {
  constexpr auto kernel = wide_kernel<G, kThreads, kR, kArgmax>;
  Plan plan;
  const int err =
      wide_plan<kThreads, 1 + G::kDim + G::kCov, kernel>(P, N, plan);
  if (err || report) {
    if (report) *report = plan;
    return err;
  }
  if (P <= 0 || K <= 0) return 0;
  if (plan.overflow > 0 && (spill == nullptr || gstate == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<P, kThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      packed, out, spill, gstate, N, K, min_sep, plan.entries,
      plan.overflow);
  return static_cast<int>(cudaGetLastError());
}

// A plan as the int[7] of the C interface
inline void plan_out(const Plan& p, int* out) {
  const int vals[7] = {p.threads, p.entries, p.smem, p.blocks_per_sm,
                       p.overflow, p.registers, p.waves};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
}

}  // namespace phd_wide
