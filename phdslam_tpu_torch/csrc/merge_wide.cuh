// The staged wide-lane greedy merge: the exact sequential greedy
// moment-matched merge at any lane count, for merge2d.cu (N > 8192),
// merge3d.cu and merge4d.cu (N > 2048), which the narrow kernels cannot
// hold: they keep a particle's unmerged lanes as one 32-bit mask word a
// thread (32 x 256 or 32 x 64 lanes), and merge3d / merge4d stage every
// lane's values in shared memory.
//
// Design: one block a particle. Staging reads the act plane once, in
// chunks of kThreads lanes, and compacts the lanes that enter (act > 0.5,
// and w > 0 in sorted mode; every act lane in argmax mode) into one
// block-wide list of entries in lane order (a ballot and the warps'
// counts a chunk). Entry e < E keeps its 1 + D + kCov values in dynamic
// shared memory ([value][E]); a later one is read again from the input
// planes through L2 (packed routes) or kept in a scratch buffer the
// caller provides (merge2d's tables route). E comes from the plan
// (wide_plan): an equal share of an SM's shared memory among the blocks
// the launch needs resident. Each entry's lane and state (free, joined
// cluster r of this round, done) sit in a caller-provided global scratch,
// so no width is fixed by registers or shared memory.
//
// The rounds are the narrow kernels' (pallas_merge.py's validity chain,
// R = kR tentative principals): the R best free entries (sorted: the
// lowest; argmax: the heaviest with w > 0, ties to the lowest lane) are
// the tentative principals, principal r is valid when no earlier valid
// principal covers it, the first K - c valid ones emit, and an entry joins
// the first emitted principal that covers it: the exact sequential
// clusters in sequential order. Entries are dealt to the threads in turn
// (e = tid + kThreads x). A round: every warp picks the block's R from the
// warps' lists alike; one pass over a thread's free entries tests them
// against the emitted principals (straight-line, the IEEE distance of the
// narrow kernels), sums the zeroth and first moments of those that join
// and ranks the rest into the thread's list of its R best for the next
// round (and, in argmax mode, notes an unmerged NaN weight); the warps'
// transposed reductions and barrier A; the means; a second pass sums the
// second moments about them; barrier B. Argmax mode stalls as the narrow
// kernels do: a round with no principal or with an unmerged NaN weight
// ends the row, whose remaining entries are then dropped (left 0).
//
// The sums are each thread's entries ascending, the butterfly's pairs and
// the warps in order, as in the narrow kernels, but over another dealing
// of the lanes: the clusters are the same, their f32 sums may differ from
// the narrow kernels' in the last bits.
//
// G supplies kDim, kCov, kPlanes, kOutPlanes, kHellinger and
// dist<false>(d, S, ok) (the Mahalanobis form on the averaged covariance)
// or hell(d, A, B), as merge_core.cuh's distances do.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "merge_core.cuh"

namespace phd_wide {

constexpr int kR = 8;                  // tentative principals a round
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned char kFree = 0xff;  // an entry's state: not merged yet
constexpr unsigned char kDone = 0xfe;  // merged in an earlier round

using phd_merge::pick;
using phd_merge::warp_transpose_sum;

// The staged entries of one particle (see the header)
template <int kVals>
struct Entries {
  float* sm;                  // [kVals][E] in shared memory
  int E;
  int* lane;                  // [N] entry -> lane (global scratch)
  unsigned char* state;       // [N] (global scratch)
  const float* in;            // the particle's packed planes, or null
  int N;
  float* spill;               // [kVals][X] (global scratch), or null
  int X;

  __device__ __forceinline__ float get(int v, int e) const {
    if (e < E) return sm[v * E + e];
    if (in != nullptr) return in[(v == 0 ? 0 : v + 1) * N + lane[e]];
    return spill[v * X + (e - E)];
  }
  __device__ __forceinline__ void put(int v, int e, float x) const {
    if (e < E)
      sm[v * E + e] = x;
    else if (in == nullptr)
      spill[v * X + (e - E)] = x;
  }
};

// The block's shared scratch
template <class G, int kThreads>
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
  int count[2][kWarps];            // staging: entries a warp a chunk
  int red_left[kWarps];
};

// The block's slot of this thread's lane in a chunk (entries in lane
// order) when ``enter``, and the chunk's total; one barrier a chunk (the
// counts alternate between two buffers)
template <class G, int kThreads>
__device__ __forceinline__ int chunk_slot(bool enter, int parity,
                                          Shared<G, kThreads>& sh,
                                          int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(kFull, enter);
  if (lane == 0) sh.count[parity][warp] = __popc(b);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int q = 0; q < Shared<G, kThreads>::kWarps; ++q) {
    const int n = sh.count[parity][q];
    before += q < warp ? n : 0;
    total += n;
  }
  return before + __popc(b & ((1u << lane) - 1u));
}

// Ranks free entry e (key h > 0) into this thread's list of its kR best,
// best first: a larger key, or (entries ascending) an earlier entry
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
template <class G, int kThreads>
__device__ __forceinline__ void publish(unsigned (&kh)[kR], int (&ke)[kR],
                                        bool nan_seen, int b,
                                        Shared<G, kThreads>& sh) {
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

// The distance of a candidate (mean m, covariance c) to a principal (its
// D means, then its kCov covariances, at pv): d = mean_p - m, the averaged
// covariance (c + cov_p) / 2, IEEE quotients (the narrow kernels' values)
template <class G>
__device__ __forceinline__ float dist_to(const float* pv,
                                         const float (&m)[G::kDim],
                                         const float (&c)[G::kCov]) {
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
    bool ok = true;
    return G::template dist<false>(d, sg, ok);
  }
}

// The greedy rounds over n_e staged entries (see the header), writing the
// particle's output planes o [G::kOutPlanes, K]
template <class G, int kThreads, bool kArgmax>
__device__ void wide_rounds(const Entries<1 + G::kDim + G::kCov>& en,
                            int n_e, float* o, int K, float min_sep,
                            Shared<G, kThreads>& sh) {
  constexpr int D = G::kDim;
  constexpr int kCov = G::kCov;
  constexpr int kWarps = kThreads / 32;
  constexpr int kPV = D + kCov;
  constexpr int kSumsA = (1 + D) * kR;
  constexpr int kSumsB = kCov * kR;
  constexpr int kPassA = Shared<G, kThreads>::kPassA;
  constexpr int kPassB = Shared<G, kThreads>::kPassB;
  constexpr int kPerLane = (kWarps * kR + 31) / 32;
  static_assert(kR * (kR - 1) / 2 <= 32, "principal pairs: one ballot");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  unsigned kh[kR];
  int ke[kR];
  // a free entry's key: sorted mode every entry (the lowest lead), argmax
  // mode its weight's bits where w > 0 (the heaviest lead)
  auto key_of = [&](float w) -> unsigned {
    return kArgmax ? (w > 0.f ? __float_as_uint(w) : 0u) : 1u;
  };
  {
#pragma unroll
    for (int r = 0; r < kR; ++r) kh[r] = 0;
    bool nan_seen = false;
    for (int e = tid; e < n_e; e += kThreads) {
      const float w = en.get(0, e);
      consider(key_of(w), e, kh, ke);
      nan_seen |= kArgmax && isnan(w);
    }
    publish(kh, ke, nan_seen, 0, sh);
  }
  __syncthreads();

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
        cov = dist_to<G>(sh.pv[warp][s], m, cv) < min_sep;
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

    // ---- membership, the first moments and the next round's lists ----
    float va[kPassA][32];
#pragma unroll
    for (int u = 0; u < kPassA; ++u) {
#pragma unroll
      for (int x = 0; x < 32; ++x) va[u][x] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) kh[r] = 0;
    bool nan_seen = false;
    for (int e = tid; e < n_e; e += kThreads) {
      if (en.state[e] != kFree) continue;
      float m[D], cv[kCov];
#pragma unroll
      for (int k = 0; k < D; ++k) m[k] = en.get(1 + k, e);
#pragma unroll
      for (int q = 0; q < kCov; ++q) cv[q] = en.get(1 + D + q, e);
      unsigned hit = 0;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if ((emit >> r) & 1u) {
          const bool in = dist_to<G>(sh.pv[warp][r], m, cv) < min_sep
                          || e == sh.pe[warp][r];
          hit |= static_cast<unsigned>(in) << r;
        }
      }
      const float w = en.get(0, e);
      if (hit) {
        const int who = __ffs(hit) - 1;
        en.state[e] = static_cast<unsigned char>(who);
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
        consider(key_of(w), e, kh, ke);
        nan_seen |= kArgmax && isnan(w);
      }
    }
#pragma unroll
    for (int u = 0; u < kPassA; ++u)
      sh.red_a[warp][32 * u + lane] = warp_transpose_sum(va[u], lane);
    publish(kh, ke, nan_seen, b ^ 1, sh);
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

    // ---- second moments about the merged means ----
    float vb[kPassB][32];
#pragma unroll
    for (int u = 0; u < kPassB; ++u) {
#pragma unroll
      for (int x = 0; x < 32; ++x) vb[u][x] = 0.f;
    }
    for (int e = tid; e < n_e; e += kThreads) {
      const int who = en.state[e];
      if (who >= kR) continue;
      en.state[e] = kDone;
      const float w = en.get(0, e);
      float dd[D];
#pragma unroll
      for (int k = 0; k < D; ++k) dd[k] = sh.mu[warp][k][who] - en.get(1 + k, e);
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
  }

  // the entries left unmerged: none when the row ended with budget left
  // (sorted mode: all merged; argmax mode: a stall drops them)
  int left = 0;
  if (c >= K) {
    for (int e = tid; e < n_e; e += kThreads) left += en.state[e] == kFree;
  }
  left = __reduce_add_sync(kFull, left);
  if (lane == 0) sh.red_left[warp] = left;
  __syncthreads();
  int n_left = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) n_left += sh.red_left[q];
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
// lane, the rest for the entering lanes only (the first E into shared
// memory, the others read again through L2 when needed). lanes / states:
// [P, N] scratch.
template <class G, int kThreads, bool kArgmax>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const float* __restrict__ packed, float* __restrict__ out,
            int* __restrict__ lanes, unsigned char* __restrict__ states,
            int N, int K, float min_sep, int E) {
  constexpr int kVals = 1 + G::kDim + G::kCov;
  extern __shared__ float s[];                       // [kVals][E]
  __shared__ Shared<G, kThreads> sh;
  const size_t p = blockIdx.x;
  const float* in = packed + p * G::kPlanes * N;
  const Entries<kVals> en{s, E, lanes + p * N, states + p * N, in, N,
                          nullptr, 0};
  int n_e = 0, parity = 0;
  for (int i0 = 0; i0 < N; i0 += kThreads, parity ^= 1) {
    const int i = i0 + threadIdx.x;
    const bool enter =
        i < N && in[N + i] > 0.5f && (kArgmax || in[i] > 0.f);
    int total;
    const int e = n_e + chunk_slot(enter, parity, sh, total);
    if (enter) {
      en.lane[e] = i;
      en.state[e] = kFree;
      if (e < E) {
        en.put(0, e, in[i]);
#pragma unroll
        for (int v = 1; v < kVals; ++v) en.put(v, e, in[(v + 1) * N + i]);
      }
    }
    n_e += total;
  }
  __syncthreads();
  wide_rounds<G, kThreads, kArgmax>(en, n_e, out + p * G::kOutPlanes * K, K,
                                    min_sep, sh);
}

// The launch plan of a wide kernel (the layout of merge2d's plan): threads
// a block, entries a block keeps in shared memory (E), dynamic shared
// memory a block (bytes), resident blocks an SM, entries that may lie past
// E (N - E), registers a thread, waves. As many resident blocks an SM as P
// needs (at most what the registers allow), each with an equal share of
// the SM's shared memory, up to N entries of kVals floats. The dynamic
// shared memory attribute is raised to the opt-in once a device, never
// past it.
struct Plan {
  int threads, entries, smem, blocks_per_sm, overflow, registers, waves;
};

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
  constexpr int kEntryBytes = static_cast<int>(sizeof(float)) * kVals;
  const int share =
      std::min(smem_sm / want - reserved, optin) - static_smem;
  int E = std::min(N, std::max(share, 0) / kEntryBytes);
  // the allocation granularity can cost a block its last entries
  for (;; E = std::max(E - 64, 0)) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                      E * kEntryBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ >= want || E == 0) break;
  }
  if (occ == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_wave = occ * sms;
  plan = Plan{kThreads, E, E * kEntryBytes, occ, N - E, attr.numRegs,
              (std::max(P, 1) + per_wave - 1) / per_wave};
  return 0;
}

// Launches wide_kernel<G, kThreads, kArgmax> over P particles of N lanes
// (any N; lanes and states: [P, N] scratch), or with ``report`` only
// writes its plan
template <class G, int kThreads, bool kArgmax>
int launch(const float* packed, float* out, int* lanes,
           unsigned char* states, int P, int N, int K, float min_sep,
           void* stream, Plan* report) {
  constexpr auto kernel = wide_kernel<G, kThreads, kArgmax>;
  Plan plan;
  const int err =
      wide_plan<kThreads, 1 + G::kDim + G::kCov, kernel>(P, N, plan);
  if (err || report) {
    if (report) *report = plan;
    return err;
  }
  if (P <= 0 || K <= 0) return 0;
  if (lanes == nullptr || states == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<P, kThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      packed, out, lanes, states, N, K, min_sep, plan.entries);
  return static_cast<int>(cudaGetLastError());
}

// A plan as the int[7] of the C interface
inline void plan_out(const Plan& p, int* out) {
  const int vals[7] = {p.threads, p.entries, p.smem, p.blocks_per_sm,
                       p.overflow, p.registers, p.waves};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
}

}  // namespace phd_wide
