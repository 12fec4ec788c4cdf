// Exact sequential greedy moment-matched merge of 2D Gaussian candidates.
//
// Replaces phdslam_tpu/ops/pallas_merge.py::_merge_kernel -> _merge_core_2d
// in its four variants: the principal is the first unmerged lane
// (sorted_w=True: active lanes weight-descending, top-cap-compacted) or the
// argmax of w over the unmerged lanes, ties to the lowest lane
// (sorted_w=False: any lane order, the full candidate grid); the distance
// is the squared Mahalanobis distance with averaged covariance (metric 0)
// or the Hellinger form (metric 1, with the tiny-determinant identity
// fallback of ops/math.py::hellinger2), operation for operation as the
// Pallas kernel's pair_dist. Input planes [P, 7, N]: w, act, mean x, mean
// y, cov 00, 01, 11. Each cluster: every unmerged lane within min_sep of
// the principal joins it; their moment-matched merge is emitted into the
// next output slot. Output planes [P, 8, K]: w, mean x, mean y, cov 00,
// 01, 11, then the count of lanes left unmerged (broadcast), then 0. Empty
// slots hold w 0, mean 0 and identity covariance.
//
// Which lanes enter: sorted mode takes act & w > 0, so NaN and w <= 0
// lanes never enter. Argmax mode takes every act lane, as the Pallas
// kernel does: a lane with w <= 0 can be absorbed but never leads, and the
// row stalls (its remaining lanes are dropped, not counted as left) once
// no unmerged lane has w > 0 or any unmerged lane's w is NaN (jnp.argmax
// picks the NaN, whose max > 0 test fails). The two modes differ only in
// the leftover count when out_cap binds and in rows holding NaN. Every
// cluster emits its principal, so the loop ends after at most K clusters.
//
// What bounds it on Hopper: the greedy chain is sequential in the clusters
// (tens to ~150 a particle), and each cluster touches only the particle's
// live lanes, so the kernel is bound by latency: its block-wide
// reductions and each lane's distance tests, not bytes or FLOPs. Design:
// one block per particle, 64 threads (2 warps) up to N = 2048 and 256
// threads (8 warps) up to N = 8192 (the full grid K + M K + M = 6320 at
// K = 128, M = 48). Thread t owns the lanes t + T j (a 32-bit mask over
// j). Only the lanes that enter (5-30% on the paths) are staged, as one
// block-wide list of entries, thread t's k-th entering lane at entry
// base_t + k (a prefix sum): entry e < E in dynamic shared memory at
// [plane][e], a later one read again from the input planes through L2
// (merge2d_kernel) or kept in a scratch buffer the caller provides
// (merge2d_tables_kernel). E comes from P and the SM count at launch
// (make_plan), so that every block of the launch is resident at once.
//
// Each round takes the R = kR tentative principals of the TPU kernel's
// validity chain (pallas_merge.py:137-188): the R lowest unmerged lanes
// (sorted) or the R heaviest with w > 0, ties to the lowest lane (argmax).
// Principal r is valid when no earlier valid principal covers it, and a
// lane joins the first valid principal that covers it: the exact
// sequential clusters, emitted in sequential order, up to the K budget.
// A round costs two block barriers (three in argmax mode) for up to R
// clusters (~7 on the captured steps), where the sequential chain cost two
// for each:
//   1. every warp's R best unmerged lanes (sorted: one ballot a row of
//      lanes; argmax: REDUX steps), and of those lists the block's R,
//      chosen by every warp alike (REDUX); the R(R-1)/2 principal pair
//      tests, one a lane and one ballot; the validity chain;
//   2. membership (round_hits()): each unmerged lane against the R
//      principals in straight-line code, so that the tests overlap (the
//      division, roots and exp only where a cheap exact bound leaves the
//      answer open); sorted mode tests each thread's own lanes, argmax mode
//      deals the entries to the threads in turn (its lanes crowd onto a few
//      threads) and passes the results through a state byte an entry
//      behind barrier M; then the zeroth and first moments of the R
//      clusters and one transposed warp reduction of the 3R sums (31
//      shuffles, lane v ends with sum v); barrier A;
//   3. the second moments about the merged means (each warp's own copy of
//      them, behind a warp barrier), the same reduction, and the next
//      round's per-warp candidates; barrier B.
// Each cluster sums its members in the order of the sequential kernel:
// each thread over its own lanes ascending, the 16-8-4-2-1 butterfly's
// pairs (commutative f32 adds give the transposed reduction the same
// bits), the warps in order; so the outputs repeat the
// one-principal-a-trip kernel bit for bit. Register arrays are indexed by
// constants only (selects go through pick()), so none of them moves to
// local memory.
//
// merge2d_tables_kernel replaces pallas_merge.py::_merge_tables_kernel
// (fused_gather_merge, entry gm_merge_pallas_batch_tables) in sorted mode
// with either metric: the same greedy core, staged straight from the
// deferred-gather tables, so the packed [P, 7, N] planes, the two column
// gathers and the combine of the two-kernel route never exist. Built with
// --fmad=false and the two-kernel route's order of terms, it reproduces
// that route bit for bit on the lanes that enter, except for a bearing
// innovation at +-pi, where its floor-form wrap (the Pallas kernel's) and
// the combine's C-fmod wrap can differ.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>

#include "merge_wide.cuh"
#include "wrap.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPlanes = 6;     // w, mean x, mean y, cov 00, 01, 11
constexpr int kTablesK = 16;   // t_k rows (the fused route)
constexpr int kTablesM = 8;    // t_m rows
constexpr int kRBits = 3;
constexpr int kR = 1 << kRBits;  // tentative principals a round
constexpr int kVals = 3 * kR;  // sums a round phase: 3 per cluster
constexpr unsigned kFull = 0xffffffffu;

static_assert(kR * (kR - 1) / 2 <= 32, "principal pairs: one ballot");
static_assert(kVals <= 32, "one lane per reduced sum");

// The Mahalanobis distance's quotient num / det as its two operands
__device__ __forceinline__ void mahal_parts(float dx, float dy, float a00,
                                            float a01, float a11, float b00,
                                            float b01, float b11, float& num,
                                            float& det) {
  const float s00 = 0.5f * (a00 + b00);
  const float s01 = 0.5f * (a01 + b01);
  const float s11 = 0.5f * (a11 + b11);
  det = fmaxf(s00 * s11 - s01 * s01, 1e-30f);
  num = dx * dx * s11 - 2.f * dx * dy * s01 + dy * dy * s00;
}

template <int kMetric>
__device__ __forceinline__ float pair_dist(float dx, float dy, float a00,
                                           float a01, float a11, float b00,
                                           float b01, float b11) {
  if (kMetric == 0) {
    float num, det;
    mahal_parts(dx, dy, a00, a01, a11, b00, b01, b11, num, det);
    return num / det;
  }
  const float s00 = a00 + b00;
  const float s01 = a01 + b01;
  const float s11 = a11 + b11;
  const float det_s = s00 * s11 - s01 * s01;
  const bool ok = det_s > 1.1754944e-38f;
  const float det_safe = ok ? det_s : 1.f;
  const float quad_inv =
      (dx * dx * s11 - 2.f * dx * dy * s01 + dy * dy * s00) / det_safe;
  const float quad_eye = dx * dx + dy * dy;
  const float eps = -0.25f * (ok ? quad_inv : quad_eye);
  const float det_half = det_s / 4.f;
  const float det_prod = (a00 * a11 - a01 * a01) * (b00 * b11 - b01 * b01);
  const float ratio = sqrtf(fmaxf(det_prod, 0.f)) / fmaxf(det_half, 1e-30f);
  return 1.f - sqrtf(fmaxf(ratio, 0.f)) * expf(eps);
}

// Whether num / det < min_sep is settled without the division: with
// t = min_sep det in the normal range (min_sep > 0), num < 0.99999 t puts
// the exact quotient below min_sep (1 - 9e-6), so its rounding is below
// min_sep too, and num > 1.00001 t puts it above, so its rounding is not
// below. ``below`` is then the answer; otherwise (and for NaN) the IEEE
// division must decide, as pair_dist does.
__device__ __forceinline__ bool settled(float num, float det, float min_sep,
                                        bool& below) {
  const float t = min_sep * det;
  const bool ok = min_sep > 0.f && t >= 1e-30f && t <= 1e30f;
  below = ok && num < 0.99999f * t;
  return below || (ok && num > 1.00001f * t);
}

// Hellinger: whether pair_dist<1> is surely not below min_sep, decided
// from the operands pair_dist forms first, with no division, root or exp.
// When det_prod <= 3.99 det_half^2 (det_half >= 1e-18, so no product
// underflows), pair_dist's ratio is below 2 and its root below 1.41422;
// when also num >= q_far det_s (1 + 1e-5), with q_far = -4 (log((1 -
// min_sep) / 1.41422) - 1e-4), its exponent is at most log((1 - min_sep) /
// 1.41422) - 1e-4, so root * exp stays below (1 - min_sep)(1 - 9e-5) and
// 1 - root * exp rounds to min_sep or above. (These bound pair_dist's own
// rounded quantities, so they hold for any covariances.) q_far <= 0
// turns the test off.
__device__ __forceinline__ bool hell_far(float dx, float dy, float a00,
                                         float a01, float a11, float b00,
                                         float b01, float b11, float q_far) {
  const float s00 = a00 + b00;
  const float s01 = a01 + b01;
  const float s11 = a11 + b11;
  const float det_s = s00 * s11 - s01 * s01;
  const float det_half = det_s / 4.f;
  const float det_prod = (a00 * a11 - a01 * a01) * (b00 * b11 - b01 * b01);
  const float num = dx * dx * s11 - 2.f * dx * dy * s01 + dy * dy * s00;
  return q_far > 0.f && det_half >= 1e-18f &&
         det_prod <= 3.99f * det_half * det_half &&
         num >= q_far * det_s * 1.00001f;
}

// a ? x : y as a register select: the compiler cannot turn it into an
// indexed access, which would move a register array to local memory
__device__ __forceinline__ float pick(bool a, float x, float y) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %3, 0;\n"
      " selp.f32 %0, %1, %2, q;\n}"
      : "=f"(r)
      : "f"(x), "f"(y), "r"(static_cast<unsigned>(a)));
  return r;
}

// One step of warp_transpose_sum at offset kH: lanes l and l ^ kH keep
// opposite halves of their 2 kH values and add the partner's copy. (A
// step a template, so that every loop bound is a constant: an inner loop
// bounded by an outer induction variable is unrolled before that bound is
// known, and v[k + h] would then index v in local memory.)
template <int kH>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool hi = (lane & kH) != 0;
#pragma unroll
  for (int k = 0; k < kH; ++k) {
    const float send = pick(hi, v[k], v[k + kH]);
    const float keep = pick(hi, v[k + kH], v[k]);
    v[k] = keep + __shfl_xor_sync(kFull, send, kH);
  }
}

// Sums 32 values a lane over the warp: lane v ends with the warp's sum of
// value v. Recursive halving over the offsets 16, 8, 4, 2, 1: each pair
// sum is the one the butterfly v + shfl_xor(v, off) forms, so the result
// has the butterfly's bits, in 31 shuffles instead of 5 a value.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32],
                                                    int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// The block's shared scratch for the rounds
template <int kWarps>
struct Shared {
  int cand_i[kWarps][kR];       // each warp's tentative principals: lane,
  int cand_e[kWarps][kR];       // entry, weight, and mean x, y, cov 00,
  float cand_w[kWarps][kR];     // 01, 11
  float cand_v[kWarps][kR][5];
  int cand_n[kWarps];           // how many the warp found
  int cand_nan[kWarps];         // argmax: an unmerged NaN weight
  float red_a[kWarps][32];      // lane v of warp q: q's partial of sum v
  float red_b[kWarps][32];
  float mu[kWarps][2][kR];      // warp q's copy of the round's means
  int red_left[kWarps];
  int scan[kWarps];             // the staging's prefix sum
};

constexpr unsigned char kFree = 0xff;  // an entry's state: not merged yet

// The staged lanes (see the header): thread t's k-th entering lane is
// entry base_t + k of one block-wide list, lane[e] its lane index. Entry
// e < E lives in dynamic shared memory at [plane][e]; a later entry is
// read again from the packed input planes ``in`` (merge2d_kernel) or kept
// in ``spill`` [kPlanes][X] (the tables kernel). state[e] is the cluster
// the entry joined (kFree until then), written by the thread that tests
// it.
template <int kThreads>
struct Lanes {
  float* sm;                    // [kPlanes][E]
  int E;
  unsigned short* lane;         // [N]
  unsigned char* state;         // [N]
  const float* in;              // this particle's [7, N] planes, or null
  int N;
  float* spill;                 // this particle's [kPlanes][X], or null
  int X;

  __device__ __forceinline__ float get(int c, int e) const {
    if (e < E) return sm[c * E + e];
    if (in != nullptr) return in[(c == 0 ? 0 : c + 1) * N + lane[e]];
    return spill[c * X + (e - E)];
  }
  __device__ __forceinline__ void put(int c, int e, float v) const {
    if (e < E)
      sm[c * E + e] = v;
    else if (in == nullptr)
      spill[c * X + (e - E)] = v;
  }
};

// The block's exclusive prefix sum of n over the threads, and its total
template <int kWarps>
__device__ __forceinline__ int block_scan(int n, Shared<kWarps>& sh,
                                          int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = n;
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int y = __shfl_up_sync(kFull, x, 1 << step);
    if (lane >= (1 << step)) x += y;
  }
  if (lane == 31) sh.scan[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    before += q < warp ? sh.scan[q] : 0;
    total += sh.scan[q];
  }
  return before + x - n;
}

// entry of lane j of a thread (first entry ``base``, entering lanes
// ``enter``)
__device__ __forceinline__ int entry_of(int base, unsigned enter, int j) {
  return base + __popc(enter & ((1u << j) - 1u));
}

// argmax mode: the heaviest entry with w > 0 among this thread's dealt
// entries ``m`` (bit x: entry tid + kThreads x), ties to the lowest lane:
// its weight's bits (0: none) and its x
template <int kThreads>
__device__ __forceinline__ unsigned dealt_heaviest(unsigned m,
                                                   const Lanes<kThreads>& ln,
                                                   int& xb) {
  unsigned key = 0;
  int lb = INT_MAX;
  xb = -1;
  for (unsigned b = m; b; b &= b - 1) {
    const int x = __ffs(b) - 1;
    const int e = threadIdx.x + kThreads * x;
    const float w = ln.get(0, e);
    const unsigned k = __float_as_uint(w);
    if (w > 0.f && (k > key || (k == key && ln.lane[e] < lb))) {
      key = k;
      lb = ln.lane[e];
      xb = x;
    }
  }
  return key;
}

// One entry of the warp's candidate list: lane i, staged as entry e
template <int kThreads>
__device__ __forceinline__ void put_candidate(Shared<kThreads / 32>& sh,
                                              int warp, int n, int i, int e,
                                              const Lanes<kThreads>& ln) {
  sh.cand_i[warp][n] = i;
  sh.cand_e[warp][n] = e;
  sh.cand_w[warp][n] = ln.get(0, e);
#pragma unroll
  for (int c = 0; c < 5; ++c) sh.cand_v[warp][n][c] = ln.get(c + 1, e);
}

// Writes this warp's kR best unmerged lanes into the shared candidate
// list, best first, each with its values: the lowest of its threads' own
// lanes (sorted; ``own``), or the heaviest with w > 0, ties to the lowest
// lane, of the entries its threads test (argmax; ``todo``), and then
// whether any of those has a NaN weight. Either way the warps' lists
// together hold the block's kR best.
template <int kThreads, bool kArgmax>
__device__ __forceinline__ void warp_candidates(unsigned own, int base,
                                                unsigned enter, unsigned todo,
                                                const Lanes<kThreads>& ln,
                                                Shared<kThreads / 32>& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int n = 0;
  if (!kArgmax) {
    // the warp's lanes ascending are its rows j ascending, each row's
    // threads ascending: a ballot a row ranks them, and the first rows
    // with an unmerged lane (one or two, as a rule) hold the kR lowest
    for (unsigned rows = __reduce_or_sync(kFull, own); rows && n < kR;
         rows &= rows - 1) {
      const int j = __ffs(rows) - 1;
      const bool mine = (own >> j) & 1u;
      const unsigned row = __ballot_sync(kFull, mine);
      const int rank = n + __popc(row & ((1u << lane) - 1u));
      if (mine && rank < kR)
        put_candidate(sh, warp, rank, tid + kThreads * j,
                      entry_of(base, enter, j), ln);
      n = min(n + __popc(row), kR);
    }
    if (lane == 0) sh.cand_n[warp] = n;
    return;
  }
  // argmax: over the entries this thread tests (``todo``, a few each),
  // not its own lanes (on the full grid a thread can own twenty)
  unsigned left = todo;             // entries not offered yet
  bool nan_seen = false;
  for (unsigned b = todo; b; b &= b - 1)
    nan_seen |= isnan(ln.get(0, tid + kThreads * (__ffs(b) - 1)));
  nan_seen = __any_sync(kFull, nan_seen);
  if (lane == 0) sh.cand_nan[warp] = nan_seen;
  int xb;
  unsigned key = dealt_heaviest(left, ln, xb);
#pragma unroll 1
  for (; n < kR; ++n) {
    const unsigned top = __reduce_max_sync(kFull, key);
    if (top == 0) break;
    const int e = tid + kThreads * xb;
    const unsigned mine = key == top ? ln.lane[e] : UINT_MAX;
    const unsigned best = __reduce_min_sync(kFull, mine);
    if (mine == best) {             // the winning thread
      put_candidate(sh, warp, n, static_cast<int>(best), e, ln);
      left &= ~(1u << xb);
      key = dealt_heaviest(left, ln, xb);
    }
  }
  if (lane == 0) sh.cand_n[warp] = n;
}

// The emitted principals (``emit``) that cover entry e, one bit each:
// pair_dist < min_sep, or e is the principal. Mahalanobis: straight-line
// code (no branch between the tests, so that they overlap), the division
// only for a quotient next to min_sep (settled()); Hellinger: the
// straight-line hell_far() filter, the exact pair_dist for the rest.
template <int kMetric, int kThreads>
__device__ __forceinline__ unsigned round_hits(const Lanes<kThreads>& ln,
                                               int e, const float* cv,
                                               const int (&pq)[kR],
                                               const int (&pe)[kR],
                                               unsigned emit, float min_sep,
                                               float q_far) {
  const float mx = ln.get(1, e), my = ln.get(2, e);
  const float a00 = ln.get(3, e), a01 = ln.get(4, e), a11 = ln.get(5, e);
  unsigned hit = 0, open = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float* p = cv + 5 * max(pq[r], 0);
    if (kMetric == 0) {
      float num, det;
      mahal_parts(p[0] - mx, p[1] - my, a00, a01, a11, p[2], p[3], p[4], num,
                  det);
      bool below;
      open |= static_cast<unsigned>(!settled(num, det, min_sep, below)) << r;
      hit |= static_cast<unsigned>(below) << r;
    } else {
      open |= static_cast<unsigned>(!hell_far(p[0] - mx, p[1] - my, a00, a01,
                                              a11, p[2], p[3], p[4], q_far))
              << r;
    }
  }
  for (open &= emit; open; open &= open - 1) {
    const int r = __ffs(open) - 1;
    int q = 0;
#pragma unroll
    for (int x = 0; x < kR; ++x) q += (x == r) * pq[x];
    const float* p = cv + 5 * q;
    hit |= static_cast<unsigned>(pair_dist<kMetric>(p[0] - mx, p[1] - my,
                                                    a00, a01, a11, p[2], p[3],
                                                    p[4]) < min_sep)
           << r;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) hit |= static_cast<unsigned>(e == pe[r]) << r;
  return hit & emit;
}

// The greedy rounds over the staged lanes (``enter`` per thread, from
// entry ``base``; ``total`` entries in the block), writing the particle's
// output planes o [8, K]. Shared by both kernels below, so the packed and
// the table routes run one core.
template <int kThreads, bool kArgmax, int kMetric>
__device__ __forceinline__ void greedy_merge(unsigned enter, int base,
                                             int total,
                                             const Lanes<kThreads>& ln,
                                             float* o, int K, float min_sep,
                                             Shared<kThreads / 32>& sh) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned own = enter;             // bit j: lane tid + kThreads j unmerged
  // bit m: entry tid + kThreads m, which this thread tests, is unmerged
  const int dealt = total > tid ? (total - tid + kThreads - 1) / kThreads : 0;
  unsigned todo = dealt >= 32 ? ~0u : (1u << dealt) - 1u;
  // hell_far's bound on the quadratic (0: off), for 0 < min_sep < 1
  const float q_far =
      kMetric == 1 && min_sep > 0.f && min_sep < 1.f
          ? -4.f * (logf((1.f - min_sep) / 1.41422f) - 1e-4f)
          : 0.f;

  // argmax mode reads entries other threads staged (sorted mode only its
  // own, until the barrier after the candidates)
  if (kArgmax) __syncthreads();
  warp_candidates<kThreads, kArgmax>(own, base, enter, todo, ln, sh);
  __syncthreads();
  int c = 0;
  while (c < K) {
    // ---- the block's kR tentative principals: the kR best of the warps'
    // lists, chosen by every warp alike (lane x holds entries x and x + 32
    // of the flat [kWarps][kR] lists; REDUX picks one a step) ----
    constexpr int kPerLane = (kWarps * kR + 31) / 32;
    int pq[kR];                     // flat index into the candidate lists
    int pe[kR];                     // entry (-1: none)
    int n_tent = 0;
    {
      unsigned ci[kPerLane];        // entry's lane (UINT_MAX: none, taken)
      unsigned cw[kPerLane];        // argmax: its weight's bits
      bool stall = false;
#pragma unroll
      for (int q = 0; q < kWarps; ++q)
        if (kArgmax) stall |= sh.cand_nan[q] != 0;
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int f = lane + 32 * u;
        const bool there = f < kWarps * kR && f % kR < sh.cand_n[f / kR];
        ci[u] = there ? static_cast<unsigned>((&sh.cand_i[0][0])[f])
                      : UINT_MAX;
        cw[u] = there ? __float_as_uint((&sh.cand_w[0][0])[f]) : 0u;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        unsigned top = 0;
        if (kArgmax) {
          unsigned m = 0;
#pragma unroll
          for (int u = 0; u < kPerLane; ++u) m = max(m, cw[u]);
          top = __reduce_max_sync(kFull, m);
        }
        unsigned m = UINT_MAX;
#pragma unroll
        for (int u = 0; u < kPerLane; ++u)
          if (!kArgmax || cw[u] == top) m = min(m, ci[u]);
        const unsigned best = __reduce_min_sync(kFull, m);
        unsigned mine = 0;          // 1 + the flat index of the winner
#pragma unroll
        for (int u = 0; u < kPerLane; ++u) {
          if (ci[u] == best && best != UINT_MAX) {
            mine = lane + 32 * u + 1;
            ci[u] = UINT_MAX;
            cw[u] = 0u;
          }
        }
        pq[r] = static_cast<int>(__reduce_max_sync(kFull, mine)) - 1;
        pe[r] = best == UINT_MAX ? -1 : (&sh.cand_e[0][0])[pq[r]];
        if (best != UINT_MAX && (!kArgmax || top > 0u)) n_tent = r + 1;
      }
      if (stall) n_tent = 0;
    }
    if (n_tent == 0) break;

    const float* cv = &sh.cand_v[0][0][0];  // [kWarps * kR][5]

    // ---- validity chain: principal r is covered by s < r when r's lane
    // is within min_sep of s (the membership test); lane p of every warp
    // evaluates pair p ----
    unsigned covered;
    {
      int s = 0, r = 1, p = lane;
#pragma unroll
      for (int x = 1; x < kR; ++x) {
        if (p >= x) {
          p -= x;
          ++r;
        }
      }
      // lane = r (r - 1) / 2 + s over r = 1 .. kR - 1, s < r
      s = p;
      bool cov = false;
      if (lane < kR * (kR - 1) / 2 && r < n_tent) {
        int qs = 0, qr = 0;
#pragma unroll
        for (int x = 0; x < kR; ++x) {
          qs += (x == s) * pq[x];
          qr += (x == r) * pq[x];
        }
        const float* a = cv + 5 * qr;
        const float* b = cv + 5 * qs;
        cov = pair_dist<kMetric>(b[0] - a[0], b[1] - a[1], a[2], a[3],
                                 a[4], b[2], b[3], b[4]) < min_sep;
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

    // ---- membership: each unmerged lane joins the first emitted
    // principal that covers it (round_hits()). Sorted mode: each thread
    // tests its own lanes. Argmax mode: the entries are dealt to the
    // threads in turn (on the full grid a thread can own twenty lanes, as
    // every detection of landmark k falls on threads k and k + 128, against
    // ~2 on average), and each result goes through the state array ----
    // (a lane's cluster as kRBits bit masks: bit j of who_bit[x] is bit x
    // of lane j's cluster)
    unsigned merged = 0;
    unsigned who_bit[kRBits];
#pragma unroll
    for (int x = 0; x < kRBits; ++x) who_bit[x] = 0;
    if (kArgmax) {
      for (unsigned b = todo; b; b &= b - 1) {
        const int m = __ffs(b) - 1;
        const int e = tid + kThreads * m;
        const unsigned hit = round_hits<kMetric>(ln, e, cv, pq, pe, emit,
                                                 min_sep, q_far);
        if (hit) {
          ln.state[e] = static_cast<unsigned char>(__ffs(hit) - 1);
          todo &= ~(1u << m);
        }
      }
      __syncthreads();                               // barrier M
      for (unsigned b = own; b; b &= b - 1) {
        const int j = __ffs(b) - 1;
        const int st = ln.state[entry_of(base, enter, j)];
        if (st != kFree) {
          merged |= 1u << j;
#pragma unroll
          for (int x = 0; x < kRBits; ++x)
            who_bit[x] |= static_cast<unsigned>((st >> x) & 1) << j;
        }
      }
    } else {
      for (unsigned b = own; b; b &= b - 1) {
        const int j = __ffs(b) - 1;
        const unsigned hit = round_hits<kMetric>(
            ln, entry_of(base, enter, j), cv, pq, pe, emit, min_sep, q_far);
        if (hit) {
          const int who = __ffs(hit) - 1;
          merged |= 1u << j;
#pragma unroll
          for (int x = 0; x < kRBits; ++x)
            who_bit[x] |= static_cast<unsigned>((who >> x) & 1) << j;
        }
      }
    }
    own &= ~merged;
    float v[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) v[x] = 0.f;
    for (unsigned b = merged; b; b &= b - 1) {   // lanes ascending
      const int j = __ffs(b) - 1;
      const int e = entry_of(base, enter, j);
      int who = 0;
#pragma unroll
      for (int x = 0; x < kRBits; ++x) who |= ((who_bit[x] >> j) & 1) << x;
      const float wi = ln.get(0, e);
      const float wx = wi * ln.get(1, e), wy = wi * ln.get(2, e);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        v[r] = pick(r == who, v[r] + wi, v[r]);
        v[kR + r] = pick(r == who, v[kR + r] + wx, v[kR + r]);
        v[2 * kR + r] = pick(r == who, v[2 * kR + r] + wy, v[2 * kR + r]);
      }
    }
    sh.red_a[warp][lane] = warp_transpose_sum(v, lane);
    __syncthreads();                                 // barrier A

    // lane x: sum x of the block (warps in order), then W, mean x, mean y
    // of cluster x % kR
    float tot = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) tot += sh.red_a[q][lane];
    const float w_mine = __shfl_sync(kFull, tot, lane & (kR - 1));
    const float w_safe_mine = fmaxf(w_mine, 1e-30f);
    const float res = lane < kR ? tot : tot / w_safe_mine;
    // the output slot of cluster r: c + the emitted clusters before it
    if (warp == 0 && lane < kVals) {
      const int r = lane & (kR - 1);
      if ((emit >> r) & 1u)
        o[(lane / kR) * K + c + __popc(emit & ((1u << r) - 1u))] = res;
    }
    // every warp holds the same means: each publishes its own copy, so a
    // warp barrier suffices (the copy is rewritten only after barrier A of
    // the next round)
    if (lane >= kR && lane < kVals) (&sh.mu[warp][0][0])[lane - kR] = res;
    __syncwarp();

    // ---- second moments about the merged means ----
#pragma unroll
    for (int x = 0; x < 32; ++x) v[x] = 0.f;
    for (unsigned b = merged; b; b &= b - 1) {   // lanes ascending
      const int j = __ffs(b) - 1;
      const int e = entry_of(base, enter, j);
      int who = 0;
#pragma unroll
      for (int x = 0; x < kRBits; ++x) who |= ((who_bit[x] >> j) & 1) << x;
      const float ddx = sh.mu[warp][0][who] - ln.get(1, e);
      const float ddy = sh.mu[warp][1][who] - ln.get(2, e);
      const float wi = ln.get(0, e);
      const float t0 = wi * (ln.get(3, e) + ddx * ddx);
      const float t1 = wi * (ln.get(4, e) + ddx * ddy);
      const float t2 = wi * (ln.get(5, e) + ddy * ddy);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        v[r] = pick(r == who, v[r] + t0, v[r]);
        v[kR + r] = pick(r == who, v[kR + r] + t1, v[kR + r]);
        v[2 * kR + r] = pick(r == who, v[2 * kR + r] + t2, v[2 * kR + r]);
      }
    }
    const float part_b = warp_transpose_sum(v, lane);
    // (barrier M ended every read of the candidate lists)
    warp_candidates<kThreads, kArgmax>(own, base, enter, todo, ln, sh);
    sh.red_b[warp][lane] = part_b;
    __syncthreads();                                 // barrier B

    if (warp == 0 && lane < kVals) {
      const int r = lane & (kR - 1);
      float m = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) m += sh.red_b[q][lane];
      if ((emit >> r) & 1u)
        o[(3 + lane / kR) * K + c + __popc(emit & ((1u << r) - 1u))] =
            m / w_safe_mine;
    }
    c += __popc(emit);
  }
  // a row that stalled with budget left drops its remaining lanes (argmax
  // mode; in sorted mode nothing is left then)
  if (c < K) own = 0;

  const int left = __reduce_add_sync(kFull, __popc(own));
  if (lane == 0) sh.red_left[warp] = left;
  __syncthreads();
  int n_left = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) n_left += sh.red_left[q];
  for (int k = c + tid; k < K; k += kThreads) {
    o[k] = 0.f;
    o[K + k] = 0.f;
    o[2 * K + k] = 0.f;
    o[3 * K + k] = 1.f;
    o[4 * K + k] = 0.f;
    o[5 * K + k] = 1.f;
  }
  for (int k = tid; k < K; k += kThreads) {
    o[6 * K + k] = static_cast<float>(n_left);
    o[7 * K + k] = 0.f;
  }
}

// Blocks an SM of each build: the paths' widest launches must be resident
// at once (dense P=1024 over 132 SMs: 8 blocks of 64 threads; the full
// grid P=512: 4 of 256)
constexpr int min_blocks(int threads) { return threads == 64 ? 8 : 4; }

// Packed planes [P, 7, N] in: the act plane is read for every lane, the
// other six only for the lanes that enter (E of them into shared memory;
// the rest are read again from ``packed`` when needed).
template <int kThreads, bool kArgmax, int kMetric>
__global__ void __launch_bounds__(kThreads, min_blocks(kThreads))
merge2d_kernel(const float* __restrict__ packed, float* __restrict__ out,
               int N, int K, float min_sep, int E) {
  extern __shared__ float s[];  // [kPlanes, E] floats, [N] lanes, [N] states
  __shared__ Shared<kThreads / 32> sh;
  const int tid = threadIdx.x;
  const float* in = packed + static_cast<size_t>(blockIdx.x) * 7 * N;

  // bit j of enter: lane tid + kThreads * j enters
  unsigned enter = 0;
#pragma unroll 4
  for (int j = 0; tid + kThreads * j < N; ++j) {
    const int i = tid + kThreads * j;
    if (in[N + i] > 0.5f && (kArgmax || in[i] > 0.f)) enter |= 1u << j;
  }
  int total;
  const int base = block_scan(__popc(enter), sh, total);
  auto* lanes = reinterpret_cast<unsigned short*>(s + kPlanes * E);
  const Lanes<kThreads> ln{s, E, lanes,
                           reinterpret_cast<unsigned char*>(lanes + N), in, N,
                           nullptr, 0};
  int e = base;
  for (unsigned b = enter; b; b &= b - 1, ++e) {
    const int i = tid + kThreads * (__ffs(b) - 1);
    ln.lane[e] = static_cast<unsigned short>(i);
    ln.state[e] = kFree;
    if (e >= E) continue;
    ln.put(0, e, in[i]);
#pragma unroll
    for (int c = 1; c < kPlanes; ++c) ln.put(c, e, in[(c + 1) * N + i]);
  }
  greedy_merge<kThreads, kArgmax, kMetric>(
      enter, base, total, ln, out + static_cast<size_t>(blockIdx.x) * 8 * K,
      K, min_sep, sh);
}

// Lane i of the fused route combined from the tables (see below): w, mean
// x, y, cov 00, 01, 11
__device__ __forceinline__ void table_lane(const int* ip, const float* fp,
                                           const float* tkp,
                                           const float* tmp, int N, int Kt,
                                           int Mt, int i,
                                           float (&v)[kPlanes]) {
  const int k = ip[i];
  const int m = ip[N + i];
  const bool k_ok = k >= 0 && k < Kt;
  const bool m_ok = m >= 0 && m < Mt;
  auto tkv = [&](int c) { return k_ok ? tkp[c * Kt + k] : 0.f; };
  auto tmv = [&](int c) { return m_ok ? tmp[c * Mt + m] : 0.f; };
  v[0] = fp[i];
  if (ip[2 * N + i] > 0) {                    // persistent
    v[1] = tkv(0);
    v[2] = tkv(1);
    v[3] = tkv(2);
    v[4] = tkv(3);
    v[5] = tkv(5);
  } else if (ip[3 * N + i] > 0) {             // detection
    const float innov_r = tmv(0) - tkv(14);
    const float innov_b = phd::wrap_angle_floor(tmv(1) - tkv(15));
    v[1] = tkv(0) + tkv(10) * innov_r + tkv(11) * innov_b;
    v[2] = tkv(1) + tkv(12) * innov_r + tkv(13) * innov_b;
    v[3] = tkv(6);
    v[4] = tkv(7);
    v[5] = tkv(9);
  } else {                                    // birth
    v[1] = tmv(2);
    v[2] = tmv(3);
    v[3] = tmv(4);
    v[4] = tmv(5);
    v[5] = tmv(7);
  }
}

// The fused gather + combine + merge (sorted mode): lanes from the
// deferred-gather tables instead of packed planes. ints [P, 4, N] (k_eff,
// m_eff, is_p, is_d), flts [P, 2, N] (cand_w, sel_act), t_k [P, 16, Kt]
// rows mean 0-1 | cov row-major 2-5 | cov_upd 6-9 | gain 10-13 | r 14 |
// bearing 15, t_m [P, 8, Mt] rows zr | zb | birth mean 2-3 | birth cov
// 4-7. A lane enters when sel_act and w > 0; its table columns are read
// from device memory (a particle's tables, 8-64 KB, stay in L2) and
// combined as ops/ekf.py::combine_selected_planes does, with the Pallas
// kernel's floor-form bearing wrap; an index outside its table reads 0,
// as gather_cols does. Entries past E go to ``scratch`` [P, kPlanes, X].
template <int kThreads, int kMetric>
__global__ void __launch_bounds__(kThreads, min_blocks(kThreads))
merge2d_tables_kernel(const int* __restrict__ ints,
                      const float* __restrict__ flts,
                      const float* __restrict__ tk,
                      const float* __restrict__ tm,
                      float* __restrict__ scratch, float* __restrict__ out,
                      int N, int Kt, int Mt, int K, float min_sep, int E,
                      int X) {
  extern __shared__ float s[];  // [kPlanes, E] floats, [N] lanes, [N] states
  __shared__ Shared<kThreads / 32> sh;
  const int tid = threadIdx.x;
  const size_t p = blockIdx.x;
  const int* ip = ints + p * 4 * N;
  const float* fp = flts + p * 2 * N;
  const float* tkp = tk + p * kTablesK * Kt;
  const float* tmp = tm + p * kTablesM * Mt;

  unsigned enter = 0;
#pragma unroll 4
  for (int j = 0; tid + kThreads * j < N; ++j) {
    const int i = tid + kThreads * j;
    if (fp[N + i] > 0.5f && fp[i] > 0.f) enter |= 1u << j;
  }
  int total;
  const int base = block_scan(__popc(enter), sh, total);
  auto* lanes = reinterpret_cast<unsigned short*>(s + kPlanes * E);
  const Lanes<kThreads> ln{
      s, E, lanes, reinterpret_cast<unsigned char*>(lanes + N), nullptr, N,
      X > 0 ? scratch + p * kPlanes * X : nullptr, X};
  int e = base;
  for (unsigned b = enter; b; b &= b - 1, ++e) {
    const int i = tid + kThreads * (__ffs(b) - 1);
    ln.lane[e] = static_cast<unsigned short>(i);
    float v[kPlanes];
    table_lane(ip, fp, tkp, tmp, N, Kt, Mt, i, v);
    ln.state[e] = kFree;
#pragma unroll
    for (int c = 0; c < kPlanes; ++c) ln.put(c, e, v[c]);
  }
  greedy_merge<kThreads, false, kMetric>(enter, base, total, ln,
                                         out + p * 8 * K, K, min_sep, sh);
}

// ---------------------------------------------------------------------------
// launch plan: entries in shared memory so that the launch is one wave
// ---------------------------------------------------------------------------

struct Plan {
  int threads;        // block size
  int entries;        // E: entering lanes a block keeps in shared memory
  int smem;           // dynamic shared memory a block, bytes
  int blocks_per_sm;  // resident blocks an SM at this smem and block size
  int overflow;       // X = N - E: entries that may lie past E
  int registers;      // a thread
  int waves;          // ceil(P / (blocks_per_sm * SMs))
};

struct Device {
  int id = -1, sms = 0, smem_sm = 0, smem_optin = 0, reserved = 0;
};

int device_info(Device& d) {
  int id = 0;
  cudaError_t err = cudaGetDevice(&id);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d.id == id) return 0;
  Device n;
  n.id = id;
  if ((err = cudaDeviceGetAttribute(&n.sms, cudaDevAttrMultiProcessorCount,
                                    id)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &n.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, id)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &n.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, id)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &n.reserved, cudaDevAttrReservedSharedMemoryPerBlock, id)) !=
          cudaSuccess)
    return static_cast<int>(err);
  d = n;
  return 0;
}

// The plan of one kernel instantiation for P blocks over N lanes: as many
// resident blocks an SM as P needs (at most what the registers allow),
// each with an equal share of the SM's shared memory: 3 N bytes of lane
// indices and states and as many entries (24 bytes each) as fit, up to N.
// Cached for the last (device, P, N) of each instantiation.
template <int kThreads, auto kernel>
int make_plan(int P, int N, Plan& plan) {
  static Device dev;
  static int last_dev = -1, last_P = -1, last_N = -1, static_smem = 0,
             regs = 0;
  static Plan cached;
  int err = device_info(dev);
  if (err) return err;
  if (dev.id == last_dev && P == last_P && N == last_N) {
    plan = cached;
    return 0;
  }
  if (last_dev != dev.id) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    static_smem = static_cast<int>(attr.sharedSizeBytes);
    regs = attr.numRegs;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dev.smem_optin - static_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int occ = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int want = std::max(1, std::min(occ, (P + dev.sms - 1) / dev.sms));
  constexpr int kEntryBytes = static_cast<int>(sizeof(float)) * kPlanes;
  const int states = (3 * N + 15) / 16 * 16;   // lane and state a lane
  const int share = std::min(dev.smem_sm / want - dev.reserved,
                             dev.smem_optin) - static_smem;
  int E = std::min(N, std::max(share - states, 0) / kEntryBytes);
  // the allocation granularity can cost a block its last entries
  for (;; E = std::max(E - 64, 0)) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, kThreads, E * kEntryBytes + states);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occ >= want || E == 0) break;
  }
  if (occ == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_wave = occ * dev.sms;
  cached = Plan{kThreads, E, E * kEntryBytes + states, occ, N - E, regs,
                (P + per_wave - 1) / per_wave};
  last_dev = dev.id;
  last_P = P;
  last_N = N;
  plan = cached;
  return 0;
}

template <int kThreads, bool kArgmax, int kMetric>
int launch(const float* packed, float* out, int P, int N, int K,
           float min_sep, cudaStream_t stream, Plan* report) {
  constexpr auto kernel = merge2d_kernel<kThreads, kArgmax, kMetric>;
  Plan plan;
  const int err = make_plan<kThreads, kernel>(P, N, plan);
  if (err) return err;
  if (report) {
    *report = plan;
    return 0;
  }
  kernel<<<P, kThreads, plan.smem, stream>>>(packed, out, N, K, min_sep,
                                             plan.entries);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads>
int dispatch(const float* packed, float* out, int P, int N, int K,
             float min_sep, int argmax, int metric, cudaStream_t stream,
             Plan* report) {
  if (argmax) {
    return metric ? launch<kThreads, true, 1>(packed, out, P, N, K, min_sep,
                                              stream, report)
                  : launch<kThreads, true, 0>(packed, out, P, N, K, min_sep,
                                              stream, report);
  }
  return metric ? launch<kThreads, false, 1>(packed, out, P, N, K, min_sep,
                                             stream, report)
                : launch<kThreads, false, 0>(packed, out, P, N, K, min_sep,
                                             stream, report);
}

template <int kThreads, int kMetric>
int launch_tables(const int* ints, const float* flts, const float* tk,
                  const float* tm, float* scratch, float* out, int P, int N,
                  int Kt, int Mt, int K, float min_sep, cudaStream_t stream,
                  Plan* report) {
  constexpr auto kernel = merge2d_tables_kernel<kThreads, kMetric>;
  Plan plan;
  const int err = make_plan<kThreads, kernel>(P, N, plan);
  if (err) return err;
  if (report) {
    *report = plan;
    return 0;
  }
  if (plan.overflow > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<P, kThreads, plan.smem, stream>>>(ints, flts, tk, tm, scratch, out,
                                             N, Kt, Mt, K, min_sep,
                                             plan.entries, plan.overflow);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads>
int dispatch_tables(const int* ints, const float* flts, const float* tk,
                    const float* tm, float* scratch, float* out, int P,
                    int N, int Kt, int Mt, int K, float min_sep, int metric,
                    cudaStream_t stream, Plan* report) {
  return metric ? launch_tables<kThreads, 1>(ints, flts, tk, tm, scratch,
                                             out, P, N, Kt, Mt, K, min_sep,
                                             stream, report)
                : launch_tables<kThreads, 0>(ints, flts, tk, tm, scratch,
                                             out, P, N, Kt, Mt, K, min_sep,
                                             stream, report);
}

int check_args(int N, int metric) {
  if (N < 0 || N > 32 * kMaxThreads || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int run_merge2d(const float* packed, float* out, int P, int N, int K,
                float min_sep, int argmax, int metric, cudaStream_t st,
                Plan* report) {
  if (N <= 32 * 64)
    return dispatch<64>(packed, out, P, N, K, min_sep, argmax, metric, st,
                        report);
  return dispatch<kMaxThreads>(packed, out, P, N, K, min_sep, argmax, metric,
                               st, report);
}

int run_tables(const int* ints, const float* flts, const float* tk,
               const float* tm, float* scratch, float* out, int P, int N,
               int Kt, int Mt, int K, float min_sep, int metric,
               cudaStream_t st, Plan* report) {
  if (N <= 32 * 64)
    return dispatch_tables<64>(ints, flts, tk, tm, scratch, out, P, N, Kt,
                               Mt, K, min_sep, metric, st, report);
  return dispatch_tables<kMaxThreads>(ints, flts, tk, tm, scratch, out, P, N,
                                      Kt, Mt, K, min_sep, metric, st, report);
}

// ---------------------------------------------------------------------------
// the staged wide-lane variants (merge_wide.cuh): any N, for N > 8192
// ---------------------------------------------------------------------------

// The staged variants' block: 256 threads, or 128 where the launch needs
// more than two resident blocks an SM (many_blocks): their rounds are
// latency-bound, and at the dense full grid's P = 1024 four 128-thread
// blocks an SM take 0.49 ms against two 256-thread ones' 0.70, while at
// a few particles (one block an SM, merge_bench.WIDE_EDGES) 128 threads
// take 1.06-1.22x the first staged design's time and 256 threads
// 0.67-0.73x (merge_bench.py, H100 80GB HBM3 at 700 W; PERF.md section 6)
constexpr int kWideThreads = 256;
constexpr int kWideThreadsMany = 128;

// Whether P particles need more than two resident blocks an SM of the
// current device (``many``), or the CUDA error that asking gave
int many_blocks(int P, bool& many) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  many = P > 2 * sms;
  return static_cast<int>(e);
}

// pair_dist<0> and pair_dist<1> in merge_wide.cuh's terms: d = principal
// - candidate mean, S the averaged covariance (Mahalanobis), or the
// candidate's covariance a and the principal's b (Hellinger)
struct Gauss2 {
  static constexpr int kDim = 2;
  static constexpr int kCov = 3;          // cov 00, 01, 11
  static constexpr int kPlanes = 7;
  static constexpr int kOutPlanes = 8;
  static constexpr bool kHellinger = false;

  template <bool kFast>
  __device__ __forceinline__ static float dist(const float (&d)[2],
                                               const float (&s)[3], bool&) {
    const float det = fmaxf(s[0] * s[2] - s[1] * s[1], 1e-30f);
    const float num =
        d[0] * d[0] * s[2] - 2.f * d[0] * d[1] * s[1] + d[1] * d[1] * s[0];
    return num / det;
  }
};

struct Hell2 : Gauss2 {
  static constexpr bool kHellinger = true;

  __device__ __forceinline__ static float hell(const float (&d)[2],
                                               const float (&a)[3],
                                               const float (&b)[3]) {
    return pair_dist<1>(d[0], d[1], a[0], a[1], a[2], b[0], b[1], b[2]);
  }
};

// The fused route's wide variant: merge2d_tables_kernel's lanes, staged
// in lane order (entries past E into ``spill`` [P, kPlanes, X] and
// ``gstate`` [P, X]), on the wide rounds
template <class G>
__global__ void __launch_bounds__(kWideThreads)
tables_wide_kernel(const int* __restrict__ ints,
                   const float* __restrict__ flts,
                   const float* __restrict__ tk, const float* __restrict__ tm,
                   float* __restrict__ spill,
                   unsigned char* __restrict__ gstate,
                   float* __restrict__ out, int N, int Kt, int Mt, int K,
                   float min_sep, int E, int X) {
  extern __shared__ float s[];                  // [kPlanes][E], [E] states
  __shared__ phd_wide::Shared<G, kWideThreads, kR> sh;
  const size_t p = blockIdx.x;
  const int* ip = ints + p * 4 * N;
  const float* fp = flts + p * 2 * N;
  const float* tkp = tk + p * kTablesK * Kt;
  const float* tmp = tm + p * kTablesM * Mt;
  const phd_wide::Entries<kPlanes> en{
      s, reinterpret_cast<unsigned char*>(s + kPlanes * E), E,
      X > 0 ? spill + p * kPlanes * X : nullptr,
      X > 0 ? gstate + p * X : nullptr, X};
  unsigned kh[kR];
  int ke[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) kh[r] = 0;
  bool nan_seen = false;
  const int n_e = phd_wide::stage<G, kWideThreads, kR, false>(
      N, en, sh, [&](int i) { return fp[N + i] > 0.5f && fp[i] > 0.f; },
      [&](int i, float (&v)[kPlanes]) {
        table_lane(ip, fp, tkp, tmp, N, Kt, Mt, i, v);
      },
      kh, ke, nan_seen);
  phd_wide::wide_rounds<G, kWideThreads, kR, false>(
      en, n_e, kh, ke, nan_seen, out + p * 8 * K, K, min_sep, sh);
}

template <int kThreads>
int run_wide_n(const float* packed, float* out, float* spill,
               unsigned char* gstate, int P, int N, int K, float min_sep,
               int argmax, int metric, void* st, phd_wide::Plan* report) {
  using phd_wide::launch;
  if (argmax)
    return metric ? launch<Hell2, kThreads, kR, true>(
                        packed, out, spill, gstate, P, N, K, min_sep, st,
                        report)
                  : launch<Gauss2, kThreads, kR, true>(
                        packed, out, spill, gstate, P, N, K, min_sep, st,
                        report);
  return metric ? launch<Hell2, kThreads, kR, false>(
                      packed, out, spill, gstate, P, N, K, min_sep, st,
                      report)
                : launch<Gauss2, kThreads, kR, false>(
                      packed, out, spill, gstate, P, N, K, min_sep, st,
                      report);
}

int run_wide(const float* packed, float* out, float* spill,
             unsigned char* gstate, int P, int N, int K, float min_sep,
             int argmax, int metric, void* st, phd_wide::Plan* report) {
  bool many = false;
  if (const int err = many_blocks(P, many)) return err;
  return many ? run_wide_n<kWideThreadsMany>(packed, out, spill, gstate, P,
                                             N, K, min_sep, argmax, metric,
                                             st, report)
              : run_wide_n<kWideThreads>(packed, out, spill, gstate, P, N, K,
                                         min_sep, argmax, metric, st, report);
}

template <class G>
int launch_tables_wide(const int* ints, const float* flts, const float* tk,
                       const float* tm, float* spill, unsigned char* gstate,
                       float* out, int P, int N, int Kt, int Mt, int K,
                       float min_sep, void* st, phd_wide::Plan* report) {
  constexpr auto kernel = tables_wide_kernel<G>;
  phd_wide::Plan plan;
  const int err =
      phd_wide::wide_plan<kWideThreads, kPlanes, kernel>(P, N, plan);
  if (err || report) {
    if (report) *report = plan;
    return err;
  }
  if (plan.overflow > 0 && (spill == nullptr || gstate == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<P, kWideThreads, plan.smem, static_cast<cudaStream_t>(st)>>>(
      ints, flts, tk, tm, spill, gstate, out, N, Kt, Mt, K, min_sep,
      plan.entries, plan.overflow);
  return static_cast<int>(cudaGetLastError());
}

int run_tables_wide(const int* ints, const float* flts, const float* tk,
                    const float* tm, float* spill, unsigned char* gstate,
                    float* out, int P, int N, int Kt, int Mt, int K,
                    float min_sep, int metric, void* st,
                    phd_wide::Plan* report) {
  return metric ? launch_tables_wide<Hell2>(ints, flts, tk, tm, spill, gstate,
                                            out, P, N, Kt, Mt, K, min_sep, st,
                                            report)
                : launch_tables_wide<Gauss2>(ints, flts, tk, tm, spill,
                                             gstate, out, P, N, Kt, Mt, K,
                                             min_sep, st, report);
}

}  // namespace

extern "C" int phd_merge2d(const float* packed, float* out, int P, int N,
                           int K, float min_sep, int argmax, int metric,
                           void* stream) {
  if (P <= 0 || K <= 0) return 0;
  if (const int err = check_args(N, metric)) return err;
  return run_merge2d(packed, out, P, N, K, min_sep, argmax, metric,
                     static_cast<cudaStream_t>(stream), nullptr);
}

// ``scratch``: kPlanes * X floats a particle (X: the plan's overflow), or
// null when X is 0
extern "C" int phd_merge2d_tables(const int* ints, const float* flts,
                                  const float* tk, const float* tm,
                                  float* scratch, float* out, int P, int N,
                                  int Kt, int Mt, int K, float min_sep,
                                  int metric, void* stream) {
  if (P <= 0 || K <= 0) return 0;
  if (const int err = check_args(N, metric)) return err;
  return run_tables(ints, flts, tk, tm, scratch, out, P, N, Kt, Mt, K,
                    min_sep, metric, static_cast<cudaStream_t>(stream),
                    nullptr);
}

// The launch plan of a merge2d variant (``tables``: merge2d_tables, sorted
// mode) for P particles of N lanes on the current device, into out[7]:
// threads, entries in shared memory, dynamic shared memory bytes, resident
// blocks an SM, overflow entries, registers a thread, waves.
extern "C" int phd_merge2d_plan(int P, int N, int argmax, int metric,
                                int tables, int* out) {
  if (P <= 0) P = 1;
  if (const int err = check_args(N, metric)) return err;
  Plan plan{};
  const int err =
      tables ? run_tables(nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, P, N, 0, 0, 1, 0.f, metric, nullptr, &plan)
             : run_merge2d(nullptr, nullptr, P, N, 1, 0.f, argmax, metric,
                           nullptr, &plan);
  if (err) return err;
  const int vals[7] = {plan.threads, plan.entries, plan.smem,
                       plan.blocks_per_sm, plan.overflow, plan.registers,
                       plan.waves};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// The staged wide-lane variant at any N (the wrapper takes it above
// 8192): spill float[P, 6, X] and gstate uint8[P, X] are scratch for the
// entries past the plan's shared ones (X: its overflow; null when 0)
extern "C" int phd_merge2d_wide(const float* packed, float* out,
                                float* spill, unsigned char* gstate, int P,
                                int N, int K, float min_sep, int argmax,
                                int metric, void* stream) {
  if (P <= 0 || K <= 0) return 0;
  if (N < 0 || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_wide(packed, out, spill, gstate, P, N, K, min_sep, argmax,
                  metric, stream, nullptr);
}

// The fused route's wide variant; spill float[P, kPlanes, X] and gstate
// uint8[P, X] as phd_merge2d_wide's
extern "C" int phd_merge2d_tables_wide(const int* ints, const float* flts,
                                       const float* tk, const float* tm,
                                       float* spill, unsigned char* gstate,
                                       float* out, int P, int N, int Kt,
                                       int Mt, int K, float min_sep,
                                       int metric, void* stream) {
  if (P <= 0 || K <= 0) return 0;
  if (N < 0 || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_tables_wide(ints, flts, tk, tm, spill, gstate, out, P, N, Kt,
                         Mt, K, min_sep, metric, stream, nullptr);
}

// The wide variants' launch plan, into out[7] (phd_merge2d_plan's layout)
extern "C" int phd_merge2d_wide_plan(int P, int N, int argmax, int metric,
                                     int tables, int* out) {
  if (P <= 0) P = 1;
  if (N < 0 || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  phd_wide::Plan plan{};
  const int err =
      tables ? run_tables_wide(nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, P, N, 0, 0, 1, 0.f, metric,
                               nullptr, &plan)
             : run_wide(nullptr, nullptr, nullptr, nullptr, P, N, 1, 0.f,
                        argmax, metric, nullptr, &plan);
  if (err) return err;
  phd_wide::plan_out(plan, out);
  return 0;
}
