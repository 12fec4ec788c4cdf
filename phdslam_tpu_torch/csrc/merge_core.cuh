// The greedy round core of merge3d.cu and merge4d.cu: the exact
// sequential greedy moment-matched merge of D-dimensional Gaussian
// candidates (D = 3, 4), R tentative principals a round. Each source
// supplies its distance (a struct G: kDim, kCov, kPlanes, kOutPlanes,
// kHellinger and dist<kFast>(), or hell() for the Hellinger form) and
// instantiates merge_kernel<G, kR, kArgmax>: sorted mode (kArgmax false,
// below) or argmax mode (the principals are the heaviest unmerged lanes,
// see "Argmax mode" at the end of this header).
//
// Input planes [P, kPlanes, N]: w, act, the D mean planes, the kCov
// upper-triangle covariance planes (row-major); active lanes are
// weight-descending, so the greedy principal is always the lowest
// unmerged lane. A lane enters when act > 0.5 and w > 0 (NaN and w <= 0
// lanes never do). Output planes [P, kOutPlanes, K]: w, mean, covariance,
// the count of lanes left unmerged (broadcast), zero pads; clusters in
// greedy order, empty slots as w 0, mean 0, identity covariance.
//
// What bounds it on Hopper: the chain is sequential in the clusters (~94
// a particle on the mixed path's captured step, the K = 24 budget on the
// disparity path's), so the kernel is bound by the latency of a cluster
// step, not by bytes or FLOPs. The one-principal-a-trip kernels paid two
// block barriers, 5 + 10 (4D) or 4 + 6 (3D) five-step warp reductions and
// ten serial IEEE divisions in one thread for each cluster. Design: one
// block of 64 threads (2 warps) a particle; thread t owns lanes t + 64 j
// as a bit mask of unmerged lanes (j < 32: N <= 2048); the entering
// lanes' values sit in shared memory ([1 + D + kCov][N] floats, only
// entering lanes loaded). Each round takes the kR lowest unmerged lanes
// as tentative principals (pallas_merge.py's 3D/4D bodies, :641-689 and
// from :842): principal r is valid when no earlier valid principal
// covers it, a lane joins the first emitted valid principal that covers
// it, and the first K - c valid principals emit, in order: the exact
// sequential clusters in sequential order. A round costs two block
// barriers for up to kR clusters (7.4 on the mixed step at kR = 8):
//   1. every warp's kR lowest unmerged lanes (one ballot a row of lanes),
//      of those the block's kR by REDUX in every warp alike; the
//      kR (kR - 1) / 2 principal pair tests, one a lane, and the validity
//      chain;
//   2. membership: each thread tests its own unmerged lanes against the
//      kR principals in straight-line code (round_hits()); the zeroth and
//      first moments of the kR clusters and one transposed warp reduction
//      a pass of 32 sums ((1 + D) kR sums: 40 at D = 4, kR = 8); barrier A;
//      lane x divides sum x by its cluster's W;
//   3. the second moments about the merged means (each warp's own copy of
//      them), the same reduction of kCov kR sums, and the next round's
//      per-warp candidates; barrier B; warp 0 writes the round's outputs.
// The membership tests are a third of a round on the mixed step (~110
// instructions a test, 16 of them conversions or reciprocals on the
// SFU); testing two lanes at once, a rolled principal loop, IEEE
// quotients or quotients checked in f32 (2 SFU ops, ~150 instructions a
// test) and kR = 4 all measured slower on the captured steps.
//
// The divisions of a distance share their denominators (a determinant,
// clamped to 1e-30 where its magnitude is not above 1e-30): Recip takes
// 1 / b in f64 from rcp.approx and two Newton steps (relative error below
// 2^-51), and each quotient is a * (1 / b) in f64 rounded once to f32.
// That is the IEEE f32 quotient: a / b of two floats lies at least 2^-49
// of its magnitude from every f32 rounding boundary of the normal range
// (a midpoint a b would need 25 odd significant bits from two 24-bit
// operands), so an approximation within 2^-50 rounds to the same float,
// overflow included. It holds for 2^-126 <= |b| <= 2^126 (where
// rcp.approx.ftz is accurate) and for quotients 0 or at least 2^-125 in
// magnitude; a test outside that (a determinant above 2^126, a subnormal
// quotient, whose midpoints a b can hit) is evaluated again with IEEE
// divisions. No branch sits between the tests, where each IEEE
// division's slow-path call put one. merge_core_check.cu holds the
// quotient against IEEE division on the card.
//
// Each cluster sums its members in the order of the sequential kernel:
// each thread over its own lanes ascending, the 16-8-4-2-1 butterfly's
// pairs (commutative f32 adds give the transposed reduction the same
// bits), the warps in order, W clamped at 1e-30; so the outputs repeat
// the one-principal-a-trip kernels bit for bit. Register arrays are
// indexed by constants only (selects go through pick()).
//
// merge2d.cu keeps its own copy of this structure: its core also carries
// the Hellinger distance's exact screens, the entering lanes staged as one
// block-wide list spilling to L2 or a scratch buffer, and the fused
// tables route, none of which merge3d or merge4d run; sharing the header
// would have to hold its 12 timed cases bit-equal and within 3% of their
// device times, for no change in what it computes.
//
// Argmax mode (pallas_merge.py's _merge_kernel_4d at sorted_w=False, the
// mode gm_merge_pallas_one_4d runs): every lane with act > 0.5 enters,
// whatever its weight (the kernel's unmasked act0). Each warp's list holds
// its kR heaviest unmerged lanes with w > 0, ties to the lowest lane
// (each thread's heaviest own lane, then REDUX max of the weight's bits
// and REDUX min of the lane among the tied, the winner offering its next),
// and the block takes the kR heaviest of the lists the same way. So a
// w <= 0 lane can be absorbed but never leads; a round with no principal
// (no unmerged lane with w > 0) or with any unmerged NaN weight stalls the
// row, which then drops its remaining lanes (the count left is 0), as the
// twin (ops/gm_merge.py::gm_merge_batch, argmax=True) and merge2d's argmax
// mode do. With out_cap binding, the lanes left include the w <= 0 ones.
//
// The Hellinger distance (G::kHellinger; no Pallas kernel has it at D = 3
// or 4, the JAX package runs XLA's gm_merge there):
// 1 - sqrt(sqrt(det A det B) / det((A + B) / 2)) exp(-d' (A + B)^-1 d / 4)
// with ops/math.py::hellinger2's clamps, in IEEE quotients (its tests take
// no Recip path).

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <type_traits>

namespace phd_merge {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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
// opposite halves of their 2 kH values and add the partner's copy (a step
// a template, so that every loop bound is a constant)
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
// value v, each pair sum the one the butterfly v + shfl_xor(v, off) forms
// over the offsets 16, 8, 4, 2, 1, so the result has the butterfly's bits
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32],
                                                    int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// 1 / b in f64 for the quotients a / b of one denominator (see the
// header). ``ok`` is cleared where b lies outside [2^-126, 2^126] (or is
// NaN) or a quotient is neither 0 nor at least 2^-125 in magnitude (the
// subnormal range, whose midpoints a quotient can hit exactly); the
// quotients are then not the IEEE ones.
struct Recip {
  double y;
  __device__ __forceinline__ Recip(float b, bool& ok) {
    float y0;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y0) : "f"(b));
    const double bd = b;
    double r = y0;
    r = fma(r, fma(-bd, r, 1.0), r);
    y = fma(r, fma(-bd, r, 1.0), r);
    const float mag = fabsf(b);
    ok &= mag >= 0x1p-126f && mag <= 0x1p126f;
  }
  __device__ __forceinline__ float operator()(float a, bool& ok) const {
    const float q = __double2float_rn(static_cast<double>(a) * y);
    ok &= q == 0.f || fabsf(q) >= 0x1p-125f;
    return q;
  }
};

// The IEEE quotients of one denominator
struct Divide {
  float b;
  __device__ __forceinline__ Divide(float b_, bool&) : b(b_) {}
  __device__ __forceinline__ float operator()(float a, bool&) const {
    return a / b;
  }
};

__device__ __forceinline__ float clamp_det(float det) {
  return fabsf(det) > 1e-30f ? det : 1e-30f;
}

// The Hellinger distance's last steps (ops/math.py::hellinger2 at any D):
// det_s = det(A + B), det_prod = det A det B, quad_inv = d' (A + B)^-1 d
// (evaluated with det(A + B) replaced by 1 where it is not above the
// smallest normal float, and then not used), quad_eye = d' d
template <int D>
__device__ __forceinline__ float hell_tail(float det_s, float det_prod,
                                           float quad_inv, float quad_eye) {
  const bool ok = det_s > 1.1754944e-38f;
  const float eps = -0.25f * (ok ? quad_inv : quad_eye);
  const float det_half = det_s / static_cast<float>(1 << D);
  const float ratio = sqrtf(fmaxf(det_prod, 0.f)) / fmaxf(det_half, 1e-30f);
  return 1.f - sqrtf(fmaxf(ratio, 0.f)) * expf(eps);
}

// det(A + B) where it is above the smallest normal float, else 1
__device__ __forceinline__ float hell_det_safe(float det_s) {
  return det_s > 1.1754944e-38f ? det_s : 1.f;
}

// The block's shared scratch for the rounds
template <class G, int kR>
struct Shared {
  static constexpr int kPassA = ((1 + G::kDim) * kR + 31) / 32;
  static constexpr int kPassB = (G::kCov * kR + 31) / 32;
  int cand[kWarps][kR];           // each warp's lowest unmerged lanes
  int cand_n[kWarps];             // how many the warp found
  float red_a[kWarps][32 * kPassA];  // lane x of warp q: q's partial of
  float red_b[kWarps][32 * kPassB];  // sum x
  float mu[kWarps][G::kDim][kR];  // warp q's copy of the round's means
  int red_left[kWarps];
};

// Argmax mode's scratch: each listed lane's weight bits, and whether the
// warp holds an unmerged NaN weight
template <class G, int kR>
struct SharedArgmax : Shared<G, kR> {
  unsigned cand_w[kWarps][kR];
  int cand_nan[kWarps];
};

// Argmax mode: the heaviest of the lanes ``left`` (bit j: lane
// tid + kThreads j) with w > 0, ties to the lowest lane: its weight's bits
// (0: none) and its j
__device__ __forceinline__ unsigned own_heaviest(unsigned left,
                                                 const float* s, int& jb) {
  unsigned key = 0;
  jb = -1;
  for (unsigned b = left; b; b &= b - 1) {
    const int j = __ffs(b) - 1;
    const float w = s[threadIdx.x + kThreads * j];
    const unsigned k = __float_as_uint(w);
    if (w > 0.f && k > key) {     // lanes ascending: ties keep the lowest
      key = k;
      jb = j;
    }
  }
  return key;
}

// Argmax mode's warp_candidates: this warp's kR heaviest unmerged lanes
// with w > 0, heaviest first, ties to the lowest lane, and whether any of
// its unmerged lanes has a NaN weight
template <class G, int kR>
__device__ __forceinline__ void warp_candidates_argmax(
    unsigned own, const float* s, SharedArgmax<G, kR>& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  bool nan_seen = false;
  for (unsigned b = own; b; b &= b - 1)
    nan_seen |= isnan(s[tid + kThreads * (__ffs(b) - 1)]);
  nan_seen = __any_sync(kFull, nan_seen);
  unsigned left = own;
  int jb;
  unsigned key = own_heaviest(left, s, jb);
  int n = 0;
#pragma unroll 1
  for (; n < kR; ++n) {
    const unsigned top = __reduce_max_sync(kFull, key);
    if (top == 0) break;
    const unsigned mine =
        key == top ? static_cast<unsigned>(tid + kThreads * jb) : UINT_MAX;
    const unsigned best = __reduce_min_sync(kFull, mine);
    if (mine == best) {           // the winning thread
      sh.cand[warp][n] = static_cast<int>(best);
      sh.cand_w[warp][n] = top;
      left &= ~(1u << jb);
      key = own_heaviest(left, s, jb);
    }
  }
  if (lane == 0) {
    sh.cand_n[warp] = n;
    sh.cand_nan[warp] = nan_seen;
  }
}

// Writes this warp's kR lowest unmerged lanes, ascending, into the shared
// candidate list: the warp's lanes ascending are its rows j ascending,
// each row's threads ascending, so a ballot a row ranks them and the
// first rows with an unmerged lane hold the kR lowest
template <class G, int kR>
__device__ __forceinline__ void warp_candidates(unsigned own,
                                                Shared<G, kR>& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int n = 0;
  for (unsigned rows = __reduce_or_sync(kFull, own); rows && n < kR;
       rows &= rows - 1) {
    const int j = __ffs(rows) - 1;
    const bool mine = (own >> j) & 1u;
    const unsigned row = __ballot_sync(kFull, mine);
    const int rank = n + __popc(row & ((1u << lane) - 1u));
    if (mine && rank < kR) sh.cand[warp][rank] = tid + kThreads * j;
    n = min(n + __popc(row), kR);
  }
  if (lane == 0) sh.cand_n[warp] = n;
}

// G::dist of a candidate (mean m, covariance c) to the principal at lane
// p: d = mean_p - m, S = (c + cov_p) / 2
template <class G, bool kFast>
__device__ __forceinline__ float dist_to(const float* s, int N, int p,
                                         const float (&m)[G::kDim],
                                         const float (&c)[G::kCov],
                                         bool& ok) {
  float d[G::kDim], sg[G::kCov];
#pragma unroll
  for (int k = 0; k < G::kDim; ++k) d[k] = s[(1 + k) * N + p] - m[k];
  if constexpr (G::kHellinger) {
    // the candidate's covariance, the principal's
#pragma unroll
    for (int q = 0; q < G::kCov; ++q) sg[q] = s[(1 + G::kDim + q) * N + p];
    return G::hell(d, c, sg);
  } else {
#pragma unroll
    for (int q = 0; q < G::kCov; ++q)
      sg[q] = 0.5f * (c[q] + s[(1 + G::kDim + q) * N + p]);
    return G::template dist<kFast>(d, sg, ok);
  }
}

// The candidate's mean and covariance at lane i
template <class G>
__device__ __forceinline__ void load_lane(const float* s, int N, int i,
                                          float (&m)[G::kDim],
                                          float (&c)[G::kCov]) {
#pragma unroll
  for (int k = 0; k < G::kDim; ++k) m[k] = s[(1 + k) * N + i];
#pragma unroll
  for (int q = 0; q < G::kCov; ++q) c[q] = s[(1 + G::kDim + q) * N + i];
}

// The emitted principals (``emit``, at lanes pq) that cover lane i, one
// bit each: dist < min_sep, or i is the principal. Straight-line tests
// with Recip's quotients, then IEEE ones for any test it could not take.
template <class G, int kR>
__device__ __forceinline__ unsigned round_hits(const float* s, int N, int i,
                                               const int (&pq)[kR],
                                               unsigned emit,
                                               float min_sep) {
  float m[G::kDim], c[G::kCov];
  load_lane<G>(s, N, i, m, c);
  unsigned hit = 0, redo = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    bool ok = true;
    const float d = dist_to<G, true>(s, N, max(pq[r], 0), m, c, ok);
    hit |= static_cast<unsigned>(d < min_sep) << r;
    redo |= static_cast<unsigned>(!ok) << r;
  }
  for (redo &= emit; redo; redo &= redo - 1) {
    const int r = __ffs(redo) - 1;
    int p = 0;
#pragma unroll
    for (int x = 0; x < kR; ++x) p += (x == r) * pq[x];
    bool ok = true;
    const float d = dist_to<G, false>(s, N, p, m, c, ok);
    hit = (hit & ~(1u << r)) | (static_cast<unsigned>(d < min_sep) << r);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) hit |= static_cast<unsigned>(i == pq[r]) << r;
  return hit & emit;
}

// The greedy rounds of one particle: packed planes in [G::kPlanes, N],
// output planes o [G::kOutPlanes, K]
template <class G, int kR, bool kArgmax>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ packed, float* __restrict__ out,
             int N, int K, float min_sep) {
  constexpr int D = G::kDim;
  constexpr int kCov = G::kCov;
  constexpr int kRBits = kR == 8 ? 3 : kR == 4 ? 2 : 1;
  constexpr int kSumsA = (1 + D) * kR;   // W, then the D mean sums
  constexpr int kSumsB = kCov * kR;      // the covariance sums
  constexpr int kPassA = Shared<G, kR>::kPassA;
  constexpr int kPassB = Shared<G, kR>::kPassB;
  static_assert(kR == (1 << kRBits) && kR <= 8, "kR: 2, 4 or 8");
  static_assert(kWarps * kR <= 32, "the warps' lists: one lane each");
  static_assert(kR * (kR - 1) / 2 <= 32, "principal pairs: one ballot");
  extern __shared__ float s[];    // [1 + D + kCov][N]: w, mean, cov
  __shared__ std::conditional_t<kArgmax, SharedArgmax<G, kR>, Shared<G, kR>>
      sh;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* in = packed + static_cast<size_t>(blockIdx.x) * G::kPlanes * N;
  float* o = out + static_cast<size_t>(blockIdx.x) * G::kOutPlanes * K;

  // bit j of own: lane tid + kThreads j entered and is unmerged; only
  // the entering lanes' values are loaded (argmax mode: every act lane)
  unsigned own = 0;
  for (int j = 0; tid + kThreads * j < N; ++j) {
    const int i = tid + kThreads * j;
    const float w = in[i];
    if (in[N + i] > 0.5f && (kArgmax || w > 0.f)) {
      own |= 1u << j;
      s[i] = w;
#pragma unroll
      for (int v = 1; v < 1 + D + kCov; ++v) s[v * N + i] = in[(v + 1) * N + i];
    }
  }
  if constexpr (kArgmax)
    warp_candidates_argmax<G, kR>(own, s, sh);
  else
    warp_candidates<G, kR>(own, sh);
  __syncthreads();

  int c = 0;
  while (c < K) {
    // ---- the block's kR tentative principals: the kR lowest of the
    // warps' lists, chosen by every warp alike (lane x holds entry x of
    // the flat [kWarps][kR] lists; REDUX picks one a step) ----
    int pq[kR];                   // principal lanes (-1: none)
    int n_tent = 0;
    if constexpr (kArgmax) {
      // the heaviest first, ties to the lowest lane; a listed NaN weight
      // anywhere stalls the row
      unsigned ci = UINT_MAX, cw = 0;
      if (lane < kWarps * kR && lane % kR < sh.cand_n[lane / kR]) {
        ci = static_cast<unsigned>(sh.cand[lane / kR][lane % kR]);
        cw = sh.cand_w[lane / kR][lane % kR];
      }
      bool stall = false;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) stall |= sh.cand_nan[q] != 0;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const unsigned top = __reduce_max_sync(kFull, cw);
        const unsigned best =
            __reduce_min_sync(kFull, cw == top ? ci : UINT_MAX);
        if (ci == best) {
          ci = UINT_MAX;
          cw = 0;
        }
        pq[r] = best == UINT_MAX ? -1 : static_cast<int>(best);
        if (best != UINT_MAX && top > 0u) n_tent = r + 1;
      }
      if (stall) n_tent = 0;
    } else {
      unsigned ci = UINT_MAX;
      if (lane < kWarps * kR && lane % kR < sh.cand_n[lane / kR])
        ci = static_cast<unsigned>(sh.cand[lane / kR][lane % kR]);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const unsigned best = __reduce_min_sync(kFull, ci);
        if (ci == best) ci = UINT_MAX;
        pq[r] = best == UINT_MAX ? -1 : static_cast<int>(best);
        if (best != UINT_MAX) n_tent = r + 1;
      }
    }
    if (n_tent == 0) break;

    // ---- validity chain: principal r is covered by s < r when r's lane
    // is within min_sep of s (the membership test); lane p of every warp
    // evaluates pair p = r (r - 1) / 2 + s ----
    unsigned covered;
    {
      int r = 1, p = lane;
#pragma unroll
      for (int x = 1; x < kR; ++x) {
        if (p >= x) {
          p -= x;
          ++r;
        }
      }
      bool cov = false;
      if (lane < kR * (kR - 1) / 2 && r < n_tent) {
        int ps = 0, pr = 0;
#pragma unroll
        for (int x = 0; x < kR; ++x) {
          ps += (x == p) * pq[x];
          pr += (x == r) * pq[x];
        }
        float m[D], cv[kCov];
        load_lane<G>(s, N, pr, m, cv);
        bool ok = true;
        float d = dist_to<G, true>(s, N, ps, m, cv, ok);
        if (!ok) d = dist_to<G, false>(s, N, ps, m, cv, ok);
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
        for (int q = 0; q < r; ++q) {
          if (((valid >> q) & 1u) && ((covered >> (r * (r - 1) / 2 + q)) & 1u))
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
    // principal that covers it (a lane's cluster as kRBits bit masks: bit
    // j of who_bit[x] is bit x of lane j's cluster) ----
    unsigned merged = 0;
    unsigned who_bit[kRBits];
#pragma unroll
    for (int x = 0; x < kRBits; ++x) who_bit[x] = 0;
    for (unsigned b = own; b; b &= b - 1) {
      const int j = __ffs(b) - 1;
      const unsigned hit =
          round_hits<G, kR>(s, N, tid + kThreads * j, pq, emit, min_sep);
      if (hit) {
        const int who = __ffs(hit) - 1;
        merged |= 1u << j;
#pragma unroll
        for (int x = 0; x < kRBits; ++x)
          who_bit[x] |= static_cast<unsigned>((who >> x) & 1) << j;
      }
    }
    own &= ~merged;

    // ---- zeroth and first moments: sum x = comp kR + r (comp 0: W) ----
    float va[kPassA][32];
#pragma unroll
    for (int u = 0; u < kPassA; ++u) {
#pragma unroll
      for (int x = 0; x < 32; ++x) va[u][x] = 0.f;
    }
    for (unsigned b = merged; b; b &= b - 1) {   // lanes ascending
      const int j = __ffs(b) - 1;
      const int i = tid + kThreads * j;
      int who = 0;
#pragma unroll
      for (int x = 0; x < kRBits; ++x) who |= ((who_bit[x] >> j) & 1) << x;
      const float wi = s[i];
      float t[1 + D];
      t[0] = wi;
#pragma unroll
      for (int k = 0; k < D; ++k) t[1 + k] = wi * s[(1 + k) * N + i];
#pragma unroll
      for (int x = 0; x < kSumsA; ++x) {
        float& v = va[x / 32][x % 32];
        v = pick(x % kR == who, v + t[x / kR], v);
      }
    }
#pragma unroll
    for (int u = 0; u < kPassA; ++u)
      sh.red_a[warp][32 * u + lane] = warp_transpose_sum(va[u], lane);
    __syncthreads();                                 // barrier A

    // sum 32 u + lane of the block (warps in order); lane's cluster is
    // lane % kR in every pass, its W sum x = lane % kR of pass 0
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
    // W, then the means of the emitted clusters (one that does not emit
    // has no members): Recip's quotients, or IEEE ones where it cannot
    // take them
    float res[kPassA];
    {
      bool ok = true;
      const Recip rw(w_safe, ok);
#pragma unroll
      for (int u = 0; u < kPassA; ++u)
        res[u] = 32 * u + lane < kR || !emit_mine ? tot[u] : rw(tot[u], ok);
      if (!ok) {
#pragma unroll
        for (int u = 0; u < kPassA; ++u)
          res[u] = 32 * u + lane < kR || !emit_mine ? tot[u] : tot[u] / w_safe;
      }
    }
#pragma unroll
    for (int u = 0; u < kPassA; ++u) {
      const int x = 32 * u + lane;
      if (x < kSumsA) {
        const int comp = x / kR;
        if (warp == 0 && emit_mine) o[comp * K + slot] = res[u];
        if (comp > 0) sh.mu[warp][comp - 1][r_mine] = res[u];
      }
    }
    __syncwarp();

    // ---- second moments about the merged means: sum x = q kR + r ----
    float vb[kPassB][32];
#pragma unroll
    for (int u = 0; u < kPassB; ++u) {
#pragma unroll
      for (int x = 0; x < 32; ++x) vb[u][x] = 0.f;
    }
    for (unsigned b = merged; b; b &= b - 1) {   // lanes ascending
      const int j = __ffs(b) - 1;
      const int i = tid + kThreads * j;
      int who = 0;
#pragma unroll
      for (int x = 0; x < kRBits; ++x) who |= ((who_bit[x] >> j) & 1) << x;
      float dd[D];
#pragma unroll
      for (int k = 0; k < D; ++k) dd[k] = sh.mu[warp][k][who] - s[(1 + k) * N + i];
      const float wi = s[i];
      float t[kCov];
      {
        int q = 0;
#pragma unroll
        for (int a = 0; a < D; ++a) {
#pragma unroll
          for (int e = a; e < D; ++e, ++q)
            t[q] = wi * (s[(1 + D + q) * N + i] + dd[a] * dd[e]);
        }
      }
#pragma unroll
      for (int x = 0; x < kSumsB; ++x) {
        float& v = vb[x / 32][x % 32];
        v = pick(x % kR == who, v + t[x / kR], v);
      }
    }
    float part_b[kPassB];
#pragma unroll
    for (int u = 0; u < kPassB; ++u) part_b[u] = warp_transpose_sum(vb[u], lane);
    // (barrier A ended every read of the candidate lists)
    if constexpr (kArgmax)
      warp_candidates_argmax<G, kR>(own, s, sh);
    else
      warp_candidates<G, kR>(own, sh);
#pragma unroll
    for (int u = 0; u < kPassB; ++u) sh.red_b[warp][32 * u + lane] = part_b[u];
    __syncthreads();                                 // barrier B

    // the covariances of the emitted clusters (warps in order, then
    // divided by W as the means are)
    if (warp == 0 && emit_mine) {
      float m[kPassB], qv[kPassB];
      bool ok = true;
      const Recip rw(w_safe, ok);
#pragma unroll
      for (int u = 0; u < kPassB; ++u) {
        m[u] = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) m[u] += sh.red_b[q][32 * u + lane];
        qv[u] = rw(m[u], ok);
      }
      if (!ok) {
#pragma unroll
        for (int u = 0; u < kPassB; ++u) qv[u] = m[u] / w_safe;
      }
#pragma unroll
      for (int u = 0; u < kPassB; ++u) {
        const int x = 32 * u + lane;
        if (x < kSumsB) o[(1 + D + x / kR) * K + slot] = qv[u];
      }
    }
    c += __popc(emit);
  }
  // argmax mode: a row that stalled with budget left drops its remaining
  // lanes (in sorted mode nothing is left then)
  if constexpr (kArgmax) {
    if (c < K) own = 0;
  }

  const int left = __reduce_add_sync(kFull, __popc(own));
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
      for (int e = a; e < D; ++e, ++q) o[(1 + D + q) * K + k] = a == e;
    }
  }
  for (int k = tid; k < K; k += kThreads) {
    o[(1 + D + kCov) * K + k] = static_cast<float>(n_left);
#pragma unroll
    for (int v = 2 + D + kCov; v < G::kOutPlanes; ++v) o[v * K + k] = 0.f;
  }
}

// Dynamic shared memory a block: the entering lanes' 1 + D + kCov values
template <class G>
size_t smem_bytes(int N) {
  return sizeof(float) * (1 + G::kDim + G::kCov) * static_cast<size_t>(N);
}

// Launches merge_kernel<G, kR, kArgmax> over P particles of N lanes
// (N <= 2048)
template <class G, int kR, bool kArgmax = false>
int launch(const float* packed, float* out, int P, int N, int K,
           float min_sep, void* stream) {
  if (P <= 0 || K <= 0) return 0;
  if (N < 0 || N > 32 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr auto kernel = merge_kernel<G, kR, kArgmax>;
  const size_t smem = smem_bytes<G>(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, out, N, K, min_sep);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan of merge_kernel<G, kR, kArgmax> for P particles of N
// lanes on the current device, into out[7] (the layout of merge2d's plan):
// threads a block, lanes a block keeps in shared memory (N), dynamic
// shared memory a block (bytes), resident blocks an SM, overflow (0),
// registers a thread, waves
template <class G, int kR, bool kArgmax = false>
int plan(int P, int N, int* out) {
  if (N < 0 || N > 32 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr auto kernel = merge_kernel<G, kR, kArgmax>;
  const size_t smem = smem_bytes<G>(N);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  cudaFuncAttributes attr;
  int dev = 0, sms = 0, occ = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_wave = occ * sms;
  const int vals[7] = {kThreads, N, static_cast<int>(smem), occ, 0,
                       attr.numRegs, (std::max(P, 1) + per_wave - 1) / per_wave};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace phd_merge
