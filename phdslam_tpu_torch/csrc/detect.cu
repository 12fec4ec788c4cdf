// Fused detection grid + normalizer + top-T selection for the GM-PHD update.
//
// Replaces phdslam_tpu/ops/pallas_detect.py::_detect_kernel (entry
// detection_topT_batch) in all of its modes: plain, with adaptive trips
// (adaptive=True) and with same-source pre-consolidation (cons_ref,
// min_sep > 0), alone or together.
// Semantics, per particle p and measurement m:
//   pdw[k]  = pref[k] * exp(-0.5 d' S^-1 d), d = (zr - r[k], wrap(zb - b[k]))
//   norm    = sum_k pdw[k] + cb
//   live[k] = pdw[k] >= min_fw * norm && pdw[k] > 0 (and z valid)
//   vals/idx: the T heaviest live lanes, ties to the lowest k; the slots
//   past the live lanes hold (0, 0); count = number of live lanes.
// A NaN pdw is never live, and a NaN norm leaves its whole row dead. The
// TPU kernel's adaptive trips stop once a block's lanes are used up and
// give the static trips' outputs; this kernel's selection costs the same
// whatever the trip count, so adaptive=True launches the same kernel
// (counted under its own name by the wrapper).
// Consolidation (planes [P, 13, K]: the 6 above, then wp, the copy-copy
// quadratic q00 q01 q11 and the copy-persistent quadratic p00 p01 p11 in
// innovation coordinates): per feature column k, the head is the heaviest
// of the live copies (w_det = pdw / norm, lowest m among ties) and the
// persistent lane (wp, which wins ties); a live copy within min_sep of the
// head (quad_p about (0, 0) when the persistent lane heads, quad_q about
// the head copy's innovation otherwise) is a member, unless the persistent
// lane is live but not near the head copy (pers_near, measured from the
// head copy's innovation). Members leave the count and the top-T; their
// w_det moments about the head are written to cons [P, 10, K]:
// Sw | Sdu_r | Sdu_b | Sduu_rr | Sduu_rb | Sduu_bb | c_r | c_b |
// n_members | pers_in.
//
// What bounds it on Hopper: instructions and their latency, not bytes.
// Device memory sees the particle's 6 (13) x K planes and (2T + 2) outputs
// per row (and 10 x K cons). On an H100 SXM (3.35 TB/s, 67 TFLOP/s f32)
// that is 0.0015 ms of HBM time at the Ackerman shape (P = 512, K = 128,
// M = 48), and at the dense one (P = 1024, K = 1024, M = 72, T = 32) the
// ~21 f32 operations per (p, m, k) lane, one exp among them, take 0.024
// ms; the exact expf and the wrap's IEEE division make it ~55 issued
// instructions a lane, which --fmad=false and bit equality keep.
//
// What the first design lost. Its selection was T arg-max trips over
// every lane's K / 32 registers, each a 32-long dependent compare chain, a
// 5-step shuffle reduction of (value, index) pairs and a 32-compare
// removal: by count about 32 x 190 instructions a lane of every dense
// row, 3x the pdw pass, even where a row has only a few live lanes (the
// usual case: a measurement gates a few features; at most 17 of 1024 in
// a dense step). It kept a second 32-register copy
// of the row and had no launch bound, and it staged each particle's planes
// once per block of 8 rows (9 times at M = 72). The consolidating kernel
// evaluated the [M, K] grid four times (once for the normalizers, twice in
// the column pass, once for the selection).
//
// This design. One block of 8 warps per particle (both kernels): the
// particle's 6 pdw planes are staged into shared memory once by a TMA bulk
// copy (bulk_copy.cuh::stage_slab), and each warp loops over rows m =
// warp, warp + 8, ... with the row's pdw in registers (K / 32 a lane), as
// the TPU kernel kept its grid in VMEM. The pdw arithmetic and the order
// of every sum are the first design's, so every output is the same bits.
// The selection reads each value a fixed number of times:
//   - keys: a lane's float bits where it is live, else 0 (a live pdw is
//     > 0, so its bits order as unsigned integers, and no dead or padding
//     lane can ever rank ahead of a live one);
//   - count <= 32: every live (value, index) pair is compacted to one
//     slot a lane (__ballot_sync / __popc, through 256 bytes of shared
//     memory a warp); count > 32 with T <= 32: the T-th largest key is
//     found bit by bit (31 warp-wide counts: the largest threshold with at
//     least T keys at or above it), and the keys above it plus the
//     lowest-index keys equal to it fill exactly T slots;
//   - a 15-stage warp bitonic sort on (value descending, index ascending)
//     puts the t-th heaviest in lane t, which writes (value, index) or,
//     past the selected lanes, (0, 0): the trips' tie rule and tail.
// Only T > 32 with more than 32 live lanes (no shipped configuration) runs
// trips, over the keys in place.
// Consolidating: pass 1, a warp per row, evaluates the grid once for the
// normalizers and writes the live lanes as an [M, K / 32] bit mask in
// shared memory (one ballot word per 32 columns); pass 2, a thread per
// column, finds the head and the member sums visiting only the live rows
// of its column (their pdw again, by the same device function: the same
// bits), reads the 7 consolidation planes straight from device memory, and
// clears the members' bits; pass 3, a warp per row, counts the words' bits
// and, at count <= 32, evaluates pdw only for the compacted live lanes
// before the sort (a full row only above 32).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "bulk_copy.cuh"
#include "wrap.cuh"

namespace {

constexpr int kWarps = 8;                       // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;                   // per SM: <= 64 registers
constexpr int kPdwPlanes = 6;                   // staged per particle
constexpr int kConsPlanes = 13;
constexpr int kConsOut = 10;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 227 * 1024;

// the innovation (ir, ib) of feature k against (zr, zb); planes r,
// bearing, si00, si01, si11, pref at sp + i * K
__device__ __forceinline__ void lane_innov(const float* sp, int K, int k,
                                           float zr, float zb, float& ir,
                                           float& ib) {
  ir = zr - sp[k];
  ib = phd::wrap_angle_floor(zb - sp[K + k]);
}

// pdw of feature k against (zr, zb), with its innovation (ir, ib)
__device__ __forceinline__ float lane_pdw(const float* sp, int K, int k,
                                          float zr, float zb, float& ir,
                                          float& ib) {
  lane_innov(sp, K, k, zr, zb, ir, ib);
  const float dist = sp[2 * K + k] * ir * ir + 2.f * sp[3 * K + k] * ir * ib
                     + sp[4 * K + k] * ib * ib;
  return sp[5 * K + k] * expf(-0.5f * dist);
}

// One warp's row: pdw of features lane + 32 j into registers (0 past K and
// on an invalid z); returns the warp-wide sum of pdw
template <int KPL>
__device__ __forceinline__ float row_pdw(const float* sp, int K, int lane,
                                         float zr, float zb, bool zvalid,
                                         float (&pdw)[KPL]) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + 32 * j;
    float v = 0.f;
    if (k < K && zvalid) {
      float ir, ib;
      v = lane_pdw(sp, K, k, zr, zb, ir, ib);
    }
    pdw[j] = v;
    sum += v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  return sum;
}

// A warp's scratch for compacting a row's selected lanes: one slot a lane
struct Slots {
  float v[32];
  int i[32];
};

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// bytes of dynamic shared memory before the warps' Slots: the barrier and
// the particle's staged pdw planes
__host__ __device__ constexpr size_t slots_offset(int K) {
  return align16(phd::staged_smem_bytes(kPdwPlanes * K));
}

// (av, ai) ranks ahead of (bv, bi): heavier, or as heavy and a lower index
__device__ __forceinline__ bool ahead(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Bitonic sort of one (value, index) pair a lane across the warp: lane t
// ends up with the t-th in (value descending, index ascending) order.
// Empty slots carry (-1, INT_MAX) and sort last.
__device__ __forceinline__ void warp_sort(float& v, int& i, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, j);
      const int oi = __shfl_xor_sync(kFull, i, j);
      // the lane that keeps the better of the pair
      const bool keep_ahead = ((lane & j) == 0) == ((lane & k) == 0);
      if (ahead(ov, oi, v, i) == keep_ahead) {
        v = ov;
        i = oi;
      }
    }
  }
}

// Lane t < T writes the t-th selected pair, (0, 0) at t >= n_sel
__device__ __forceinline__ void write_row(float v, int i, int n_sel, int T,
                                          int lane, float* vals, int* idx) {
  if (lane < T) {
    const bool sel = lane < n_sel;
    vals[lane] = sel ? v : 0.f;
    idx[lane] = sel ? i : 0;
  }
  for (int u = 32 + lane; u < T; u += 32) {
    vals[u] = 0.f;
    idx[u] = 0;
  }
}

// T trips over the keys in place (T > 32 with more than 32 eligible lanes
// only): each takes the heaviest key, lowest index among ties, and zeroes
// it; a trip that finds no key left writes the (0, 0) tail
template <int KPL>
__device__ __forceinline__ void select_trips(unsigned (&key)[KPL], int T,
                                          int lane, float* vals, int* idx) {
  for (int t = 0; t < T; ++t) {
    unsigned bv = 0u;
    int bk = INT_MAX;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {      // k rises with j: strict > keeps
      if (key[j] > bv) {                 // the lowest k among equal keys
        bv = key[j];
        bk = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned ov = __shfl_xor_sync(kFull, bv, off);
      const int ok = __shfl_xor_sync(kFull, bk, off);
      if (ov > bv || (ov == bv && ok < bk)) {
        bv = ov;
        bk = ok;
      }
    }
    if (bv == 0u) {                      // warp-uniform: every lane agrees
      for (int u = t + lane; u < T; u += 32) {
        vals[u] = 0.f;
        idx[u] = 0;
      }
      return;
    }
    if (lane == 0) {
      vals[t] = __uint_as_float(bv);
      idx[t] = bk;
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      if (lane + 32 * j == bk) key[j] = 0u;
  }
}

// The keys above thr and the r lowest-index keys equal to it (at most 32),
// compacted in index order (j, then lane; key j of a lane is index idx0 +
// lane + 32 j) and sorted across the warp: lane t ends with the t-th in
// (value descending, index ascending) order, (-1, INT_MAX) past them.
// Returns how many were selected.
template <int KPL>
__device__ __forceinline__ int select_sorted(const unsigned (&key)[KPL],
                                             unsigned thr, int r, int lane,
                                             Slots& s, int idx0, float& v,
                                             int& i) {
  // the equal keys' ranks count up from the lowest index
  const unsigned below = (1u << lane) - 1u;
  int base = 0, seen = 0;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    bool sel = key[j] > thr;
    if (r > 0) {                         // warp-uniform
      const bool eq = key[j] == thr;
      const unsigned eqm = __ballot_sync(kFull, eq);
      sel = sel || (eq && seen + __popc(eqm & below) < r);
      seen += __popc(eqm);
    }
    const unsigned sm = __ballot_sync(kFull, sel);
    if (sel) {
      const int pos = base + __popc(sm & below);
      s.v[pos] = __uint_as_float(key[j]);
      s.i[pos] = idx0 + lane + 32 * j;
    }
    base += __popc(sm);
  }
  __syncwarp();
  v = -1.f;
  i = INT_MAX;
  if (lane < base) {
    v = s.v[lane];
    i = s.i[lane];
  }
  __syncwarp();                          // the slots are free again
  warp_sort(v, i, lane);
  return base;
}

// thr and r of select_sorted for the top T (T <= 32) of cnt keys: at
// cnt <= 32 every key (thr 0, r 0); otherwise thr = the T-th largest key,
// the largest value with at least T keys at or above it, found bit by bit
// (live keys are > 0 with bit 31 clear), and r = T - the keys above it
template <int KPL>
__device__ __forceinline__ unsigned top_threshold(const unsigned (&key)[KPL],
                                                  int cnt, int T, int& r) {
  unsigned thr = 0u;
  r = 0;
  if (cnt > 32) {
    for (int b = 30; b >= 0; --b) {
      const unsigned c = thr | (1u << b);
      int n = 0;
#pragma unroll
      for (int j = 0; j < KPL; ++j) n += key[j] >= c ? 1 : 0;
      if (__reduce_add_sync(kFull, n) >= T) thr = c;
    }
    int n_gt = 0;
#pragma unroll
    for (int j = 0; j < KPL; ++j) n_gt += key[j] > thr ? 1 : 0;
    r = T - __reduce_add_sync(kFull, n_gt);
  }
  return thr;
}

// The top-T of one warp's row from its keys (a lane's pdw bits where it is
// eligible, 0 elsewhere) and their warp-uniform count
template <int KPL>
__device__ __forceinline__ void select_keys(unsigned (&key)[KPL], int cnt,
                                            int T, int lane, Slots& s,
                                            float* vals, int* idx) {
  if (cnt == 0) {
    write_row(0.f, 0, 0, T, lane, vals, idx);
    return;
  }
  if (cnt > 32 && T > 32) {
    select_trips<KPL>(key, T, lane, vals, idx);
    return;
  }
  // select the keys above thr and the r lowest-index keys equal to it
  int r;
  const unsigned thr = top_threshold<KPL>(key, cnt, T, r);
  float v;
  int i;
  const int n_sel = select_sorted<KPL>(key, thr, r, lane, s, 0, v, i);
  write_row(v, i, n_sel, T, lane, vals, idx);
}

template <int KPL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
detect_kernel(const float* __restrict__ planes, const float* __restrict__ z4,
              float* __restrict__ vals, int* __restrict__ idx,
              float* __restrict__ norm, int* __restrict__ count, int K,
              int M, int T, float min_fw, float cb) {
  // barrier + staged [6, K] planes of particle p | Slots [kWarps]
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x;
  uint64_t* bar;
  const float* sp = phd::stage_slab(
      planes + static_cast<size_t>(p) * kPdwPlanes * K, kPdwPlanes * K, smem,
      &bar);
  Slots* slots = reinterpret_cast<Slots*>(smem + slots_offset(K));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();                      // the slab's head and tail
  phd::mbar_wait(bar, 0);               // its bulk-copied middle

  for (int m = warp; m < M; m += kWarps) {
    float pdw[KPL];
    const float nrm = row_pdw<KPL>(sp, K, lane, z4[4 * m], z4[4 * m + 1],
                                   z4[4 * m + 2] > 0.5f, pdw) + cb;
    const float thr = min_fw * nrm;
    // pdw is 0 past K, so no padding lane is live
    unsigned key[KPL];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const bool live = pdw[j] >= thr && pdw[j] > 0.f;
      key[j] = live ? __float_as_uint(pdw[j]) : 0u;
      cnt += live ? 1 : 0;
    }
    cnt = __reduce_add_sync(kFull, cnt);
    const size_t row = static_cast<size_t>(p) * M + m;
    if (lane == 0) {
      norm[row] = nrm;
      count[row] = cnt;
    }
    select_keys<KPL>(key, cnt, T, lane, slots[warp], vals + row * T,
                     idx + row * T);
  }
}

// One feature column's consolidation (a thread's), in the order of its
// steps: column_head for each live row m ascending, column_open, then
// for each live row m ascending once ``flag`` is set column_near and, for
// a member, column_add, and column_close. Both column passes below run
// these same functions in the same order, so they give the same bits.
struct Column {
  float best, uh_r, uh_b;               // the head copy so far
  float c_r, c_b, a00, a01, a11;        // the head and its quadratic
  bool flag, pers_in;
  float s_w, s_r, s_b, s_rr, s_rb, s_bb;
  int n_mem;
};

__device__ __forceinline__ void column_start(Column& c) {
  c.best = -INFINITY;
  c.uh_r = 0.f;
  c.uh_b = 0.f;
}

// the head copy: the heaviest live w_det = pdw / norm, the lowest m among
// ties (rows visited m ascending)
__device__ __forceinline__ void column_head(Column& c, float wd, float ir,
                                            float ib) {
  if (wd > c.best) {
    c.best = wd;
    c.uh_r = ir;
    c.uh_b = ib;
  }
}

// gx: the 7 consolidation planes (wp, q.., p..) of the particle
__device__ __forceinline__ void column_open(Column& c, const float* gx,
                                            int K, int k, bool real,
                                            float min_sep) {
  const float colmax = fmaxf(c.best, 0.f);
  const float wp = real ? gx[k] : 0.f;
  const float q00 = real ? gx[K + k] : 0.f;
  const float q01 = real ? gx[2 * K + k] : 0.f;
  const float q11 = real ? gx[3 * K + k] : 0.f;
  const float p00 = real ? gx[4 * K + k] : 0.f;
  const float p01 = real ? gx[5 * K + k] : 0.f;
  const float p11 = real ? gx[6 * K + k] : 0.f;
  const bool has_copy = colmax > 0.f;
  // the persistent lane heads the column when at least as heavy
  const bool head_p = wp >= colmax && wp > 0.f;
  c.c_r = head_p ? 0.f : c.uh_r;
  c.c_b = head_p ? 0.f : c.uh_b;
  const float pers_near = p00 * c.uh_r * c.uh_r + 2.f * p01 * c.uh_r * c.uh_b
                          + p11 * c.uh_b * c.uh_b;
  c.pers_in = wp > 0.f && (head_p || pers_near < min_sep) && has_copy;
  c.flag = has_copy && (wp <= 0.f || c.pers_in);
  c.a00 = head_p ? p00 : q00;
  c.a01 = head_p ? p01 : q01;
  c.a11 = head_p ? p11 : q11;
  c.s_w = c.s_r = c.s_b = c.s_rr = c.s_rb = c.s_bb = 0.f;
  c.n_mem = 0;
}

// a live row of a flagged column: whether it is a member, with its
// innovation about the head (du_r, du_b)
__device__ __forceinline__ bool column_near(const Column& c, float ir,
                                            float ib, float min_sep,
                                            float& du_r, float& du_b) {
  du_r = ir - c.c_r;
  du_b = ib - c.c_b;
  const float quad = c.a00 * du_r * du_r + 2.f * c.a01 * du_r * du_b
                     + c.a11 * du_b * du_b;
  return quad < min_sep;
}

// a member's w_det moments about the head, summed
__device__ __forceinline__ void column_add(Column& c, float wm, float du_r,
                                           float du_b) {
  c.s_w += wm;
  c.s_r += wm * du_r;
  c.s_b += wm * du_b;
  c.s_rr += wm * du_r * du_r;
  c.s_rb += wm * du_r * du_b;
  c.s_bb += wm * du_b * du_b;
  ++c.n_mem;
}

// cp: the particle's cons [10, K]
__device__ __forceinline__ void column_close(const Column& c, float* cp,
                                             int K, int k, bool real) {
  if (!real) return;
  cp[k] = c.s_w;
  cp[K + k] = c.s_r;
  cp[2 * K + k] = c.s_b;
  cp[3 * K + k] = c.s_rr;
  cp[4 * K + k] = c.s_rb;
  cp[5 * K + k] = c.s_bb;
  cp[6 * K + k] = c.c_r;
  cp[7 * K + k] = c.c_b;
  cp[8 * K + k] = static_cast<float>(c.n_mem);
  cp[9 * K + k] = c.pers_in ? 1.f : 0.f;
}

// The narrow consolidating kernel's column pass: a thread per column k, a
// warp per 32 consecutive columns (one bit word a row, which only this
// warp reads and writes), each lane evaluating its live rows' pdw in turn.
// sp: the 6 pdw planes, gx: the 7 consolidation planes, z: z4 [M, 4], nrm:
// the rows' normalizers, words: the live lanes [M, W] (members cleared
// here), cp: this particle's cons [10, K]
__device__ __forceinline__ void column_pass(const float* sp, const float* gx,
                                            const float* z, const float* nrm,
                                            unsigned* words, int K, int M,
                                            float min_sep, float* cp) {
  const int W = (K + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int kb = 32 * warp; kb < K; kb += 32 * kWarps) {
    const int k = kb + lane;
    const bool real = k < K;
    unsigned* col_words = words + (kb >> 5);
    Column c;
    column_start(c);
    for (int m = 0; m < M; ++m) {
      if ((col_words[m * W] >> lane) & 1u) {
        float ir, ib;
        const float v = lane_pdw(sp, K, k, z[4 * m], z[4 * m + 1], ir, ib);
        column_head(c, v / nrm[m], ir, ib);
      }
    }
    column_open(c, gx, K, k, real, min_sep);
    if (__any_sync(kFull, c.flag)) {     // else no member in these columns
      for (int m = 0; m < M; ++m) {
        const unsigned word = col_words[m * W];
        bool member = false;
        if (c.flag && ((word >> lane) & 1u)) {
          float ir, ib;
          const float v = lane_pdw(sp, K, k, z[4 * m], z[4 * m + 1], ir,
                                   ib);
          float du_r, du_b;
          member = column_near(c, ir, ib, min_sep, du_r, du_b);
          if (member) column_add(c, v / nrm[m], du_r, du_b);
        }
        const unsigned bits = __ballot_sync(kFull, member);
        if (lane == 0 && bits != 0u) col_words[m * W] = word & ~bits;
      }
    }
    column_close(c, cp, K, k, real);
  }
}

template <int KPL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
detect_cons_kernel(const float* __restrict__ planes,
                   const float* __restrict__ z4, float* __restrict__ vals,
                   int* __restrict__ idx, float* __restrict__ norm,
                   int* __restrict__ count, float* __restrict__ cons, int K,
                   int M, int T, float min_fw, float cb, float min_sep) {
  // barrier + staged [6, K] pdw planes | Slots [kWarps] | z4 [M, 4] |
  // norms [M] | bit words [M, W]: the live lanes after pass 1, the live
  // lanes that are not members after pass 2
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) / 32;
  const int p = blockIdx.x;
  const float* src = planes + static_cast<size_t>(p) * kConsPlanes * K;
  uint64_t* bar;
  const float* sp = phd::stage_slab(src, kPdwPlanes * K, smem, &bar);
  Slots* slots = reinterpret_cast<Slots*>(smem + slots_offset(K));
  float* sz = reinterpret_cast<float*>(slots + kWarps);
  float* snorm = sz + 4 * M;
  unsigned* sbits = reinterpret_cast<unsigned*>(snorm + M);
  for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) sz[i] = z4[i];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();
  phd::mbar_wait(bar, 0);

  // pass 1: a warp per row: the normalizer, and the live lanes as words
  // (word j: features 32 j .. 32 j + 31, bit = lane)
  for (int m = warp; m < M; m += kWarps) {
    float pdw[KPL];
    const float nrm = row_pdw<KPL>(sp, K, lane, sz[4 * m], sz[4 * m + 1],
                                   sz[4 * m + 2] > 0.5f, pdw) + cb;
    const float thr = min_fw * nrm;
    unsigned word = 0u;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const unsigned b = __ballot_sync(kFull, pdw[j] >= thr && pdw[j] > 0.f);
      if (lane == j) word = b;
    }
    if (lane < W) sbits[m * W + lane] = word;
    if (lane == 0) snorm[m] = nrm;
  }
  __syncthreads();

  // pass 2: the column pass
  column_pass(sp, src + kPdwPlanes * K, sz, snorm, sbits, K, M, min_sep,
              cons + static_cast<size_t>(p) * kConsOut * K);
  __syncthreads();

  // pass 3: the count and the top-T over the live non-member lanes, a warp
  // per row; lane j holds the row's word j
  for (int m = warp; m < M; m += kWarps) {
    const unsigned word = lane < W ? sbits[m * W + lane] : 0u;
    const int own = __popc(word);
    const int cnt = __reduce_add_sync(kFull, own);
    const size_t row = static_cast<size_t>(p) * M + m;
    if (lane == 0) {
      norm[row] = snorm[m];
      count[row] = cnt;
    }
    float* vrow = vals + row * T;
    int* irow = idx + row * T;
    if (cnt == 0) {
      write_row(0.f, 0, 0, T, lane, vrow, irow);
    } else if (cnt <= 32) {
      // compact the eligible features from the words (an exclusive scan of
      // the bit counts), then evaluate pdw for those lanes only
      int off = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, off, d);
        if (lane >= d) off += o;
      }
      off -= own;
      for (unsigned w = word; w != 0u; w &= w - 1u)
        slots[warp].i[off++] = 32 * lane + __ffs(w) - 1;
      __syncwarp();
      float v = -1.f;
      int i = INT_MAX;
      if (lane < cnt) {
        i = slots[warp].i[lane];
        float ir, ib;
        v = lane_pdw(sp, K, i, sz[4 * m], sz[4 * m + 1], ir, ib);
      }
      __syncwarp();
      warp_sort(v, i, lane);
      write_row(v, i, cnt, T, lane, vrow, irow);
    } else {
      float pdw[KPL];
      row_pdw<KPL>(sp, K, lane, sz[4 * m], sz[4 * m + 1],
                   sz[4 * m + 2] > 0.5f, pdw);
      unsigned key[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const unsigned wj = __shfl_sync(kFull, word, j);
        key[j] = ((wj >> lane) & 1u) ? __float_as_uint(pdw[j]) : 0u;
      }
      select_keys<KPL>(key, cnt, T, lane, slots[warp], vrow, irow);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide variants: any K (the wrapper takes them above 1024, where the
// narrow kernels' 32 features a lane no longer fit). A warp per row, as
// above, but the row is never held whole in registers; the normalizer
// sums each lane's features k = lane + 32 j with j ascending and then the
// butterfly (the narrow kernels' order, so the same bits). wide_select
// walks a row in tiles of 1024 features (32 a lane), each tile's top
// min(T, 32) (select_sorted) merged into a running top 32: the better of
// running slot t and the tile's slot 31 - t is the top 32 of the two as a
// bitonic sequence, which warp_sort orders. The order (value descending,
// index ascending) is total, so the tiles give the narrow kernels'
// selection. T > 32 with more than 32 eligible lanes (no shipped
// configuration) runs trips over the whole row instead, each after the
// previous pick.
//
// What the first plain wide kernel lost at K = 2048 (the dense
// path at max_features 2048: 1.957 ms on the device, 41x its 0.047 ms
// bound): it evaluated each lane's pdw twice (normalizer and keys), read
// the particle's planes from device memory for every row, and ran the
// tile selection (31 warp-wide counts, a compaction and a sort) on every
// tile with a live lane, where a dense row has a few. detect_wide_kernel
// stages the planes once by TMA where they fit (K <= 4096), evaluates pdw
// once while keeping the row's few candidate lanes, and selects among
// them (see the kernel). The first consolidating wide kernel (2.746 ms on
// an H100 80GB HBM3 at 700 W at the dense K = 2048 scene, 2.3% of its
// 0.063 ms bound) lost more: pdw
// evaluated twice over every lane of pass 1 and again at every live lane
// of the tile walk, the planes and the live-lane words in device memory,
// every tile of every row walked in pass 3. detect_cons_wide_kernel now
// takes detect_wide_kernel's pass 1 and keeps the words in shared memory
// (see the kernel).
// ---------------------------------------------------------------------------

constexpr int kTile = 32;          // features a lane a tile

// The T heaviest keys of one warp's row of K features, written as the
// narrow kernels write them; key(k) is feature k's key (its pdw bits where
// it is eligible, else 0; 0 past K). Returns the eligible count.
template <class Key>
__device__ int wide_select(const Key& key, int K, int T, int lane, Slots& s,
                           float* vals, int* idx) {
  const int n_tiles = (K + 32 * kTile - 1) / (32 * kTile);
  float rv = -1.f;
  int ri = INT_MAX;
  int cnt = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int idx0 = 32 * kTile * t;
    unsigned kt[kTile];
    int c = 0;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      kt[j] = key(idx0 + lane + 32 * j);
      c += kt[j] != 0u;
    }
    c = __reduce_add_sync(kFull, c);
    if (c == 0) continue;                 // warp-uniform
    cnt += c;
    int r;
    const unsigned thr = top_threshold<kTile>(kt, c, min(T, 32), r);
    float tv;
    int ti;
    select_sorted<kTile>(kt, thr, r, lane, s, idx0, tv, ti);
    const float ov = __shfl_sync(kFull, tv, 31 - lane);
    const int oi = __shfl_sync(kFull, ti, 31 - lane);
    if (ahead(ov, oi, rv, ri)) {
      rv = ov;
      ri = oi;
    }
    warp_sort(rv, ri, lane);
  }
  if (cnt <= 32 || T <= 32) {
    write_row(rv, ri, min(cnt, T), T, lane, vals, idx);
    return cnt;
  }
  // trips: pick t is the heaviest key behind pick t - 1
  float pv = INFINITY;
  int pi = -1;
  for (int t = 0; t < T; ++t) {
    float bv = -1.f;
    int bi = INT_MAX;
    for (int k = lane; k < K; k += 32) {
      const unsigned kk = key(k);
      const float v = __uint_as_float(kk);
      if (kk != 0u && (v < pv || (v == pv && k > pi)) && ahead(v, k, bv, bi)) {
        bv = v;
        bi = k;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ahead(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi == INT_MAX) {                  // warp-uniform: none left
      for (int u = t + lane; u < T; u += 32) {
        vals[u] = 0.f;
        idx[u] = 0;
      }
      break;
    }
    if (lane == 0) {
      vals[t] = bv;
      idx[t] = bi;
    }
    pv = bv;
    pi = bi;
  }
  return cnt;
}

// detect_wide_kernel's per-warp buffer: a row's candidate lanes (value,
// feature), in feature order
constexpr int kCandPerLane = 4;
constexpr int kCand = 32 * kCandPerLane;
struct Cand {
  float v[kCand];
  int i[kCand];
};

// The planes staged in shared memory up to this many floats (the narrow
// kernels' K = 1024 slab and, with it, K <= 4096); a wider particle's are
// read from device memory
constexpr int kWideStaged = kPdwPlanes * 4096;

// dynamic shared memory of detect_wide_kernel: the staged planes (where
// they fit) and each warp's Slots and Cand
size_t wide_smem(int K) {
  const size_t planes = kPdwPlanes * K <= kWideStaged ? slots_offset(K)
                                                      : 16;
  return planes + kWarps * (sizeof(Slots) + sizeof(Cand));
}

// A warp per row. Pass 1 evaluates each feature's pdw once (lane_pdw, as
// the narrow kernels), sums it in their order (each lane's features
// k = lane + 32 j with j ascending, then the butterfly) and keeps the
// candidates, the lanes with pdw > 0 and pdw >= min_fw * cb, in feature
// order in the warp's Cand buffer: every live lane is one, since the
// normalizer is at least cb (pdw >= 0; f32 sums and products are
// monotone), so the live threshold min_fw * norm is at least min_fw * cb
// (min_fw >= 0; a negative min_fw makes every pdw > 0 a candidate). With
// the normalizer the live lanes are found among the candidates: at most
// 32 are compacted by ballot and sorted (the narrow kernels' whole-row
// path); more, at T <= 32, go through the bit-by-bit threshold over the
// candidates' keys (4 a lane, in feature order, so the ties keep the
// lowest feature). Only a row with more than kCand candidates (min_fw 0,
// or a scene where most features gate) or with more than 32 live lanes
// at T > 32 walks the whole row again (wide_select, pdw recomputed): the
// same pdw, sum order and total order give the first design's bits in
// every case.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
detect_wide_kernel(const float* __restrict__ planes,
                   const float* __restrict__ z4, float* __restrict__ vals,
                   int* __restrict__ idx, float* __restrict__ norm,
                   int* __restrict__ count, int K, int M, int T, float min_fw,
                   float cb) {
  // [barrier + staged [6, K] planes of particle p, where they fit] |
  // Slots [kWarps] | Cand [kWarps]
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x;
  const float* gp = planes + static_cast<size_t>(p) * kPdwPlanes * K;
  const bool staged = kPdwPlanes * K <= kWideStaged;
  uint64_t* bar = nullptr;
  const float* sp =
      staged ? phd::stage_slab(gp, kPdwPlanes * K, smem, &bar) : gp;
  Slots* slots =
      reinterpret_cast<Slots*>(smem + (staged ? slots_offset(K) : 16));
  Cand* cands = reinterpret_cast<Cand*>(slots + kWarps);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  Slots& sl = slots[warp];
  Cand& cd = cands[warp];
  const float lb = min_fw >= 0.f ? min_fw * cb : 0.f;
  if (staged) {
    __syncthreads();                    // the slab's head and tail
    phd::mbar_wait(bar, 0);             // its bulk-copied middle
  }
  for (int m = warp; m < M; m += kWarps) {
    const float zr = z4[4 * m], zb = z4[4 * m + 1];
    const bool zvalid = z4[4 * m + 2] > 0.5f;
    // pass 1: pdw once, the normalizer's sum, the candidates
    float sum = 0.f;
    int n_cand = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      float v = 0.f;
      if (k < K && zvalid) {
        float ir, ib;
        v = lane_pdw(sp, K, k, zr, zb, ir, ib);
      }
      sum += v;
      const bool cand = v >= lb && v > 0.f;
      const unsigned bc = __ballot_sync(kFull, cand);
      const int q = n_cand + __popc(bc & below);
      if (cand && q < kCand) {
        cd.v[q] = v;
        cd.i[q] = k;
      }
      n_cand += __popc(bc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    const float nrm = sum + cb;
    const float thr = min_fw * nrm;
    __syncwarp();
    const size_t row = static_cast<size_t>(p) * M + m;
    float* vrow = vals + row * T;
    int* irow = idx + row * T;
    // pass 2: the live lanes among the candidates, keys in feature order
    unsigned key[kCandPerLane];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kCandPerLane; ++u) {
      const int q = lane + 32 * u;
      const float v = q < n_cand && q < kCand ? cd.v[q] : 0.f;
      const bool live = v >= thr && v > 0.f;
      key[u] = live ? __float_as_uint(v) : 0u;
      cnt += live;
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (n_cand > kCand || (cnt > 32 && T > 32)) {
      const auto rekey = [&](int k) -> unsigned {
        if (k >= K || !zvalid) return 0u;
        float ir, ib;
        const float v = lane_pdw(sp, K, k, zr, zb, ir, ib);
        return v >= thr && v > 0.f ? __float_as_uint(v) : 0u;
      };
      cnt = wide_select(rekey, K, T, lane, sl, vrow, irow);
    } else if (cnt == 0) {
      write_row(0.f, 0, 0, T, lane, vrow, irow);
    } else {
      // select_sorted over candidate positions (their order is the
      // features'), then each position's feature
      int r;
      const unsigned thr_k = top_threshold<kCandPerLane>(key, cnt, T, r);
      float v;
      int i;
      const int n_sel =
          select_sorted<kCandPerLane>(key, thr_k, r, lane, sl, 0, v, i);
      if (lane < n_sel) i = cd.i[i];
      write_row(v, i, n_sel, T, lane, vrow, irow);
    }
    if (lane == 0) {
      norm[row] = nrm;
      count[row] = cnt;
    }
    __syncwarp();                        // the warp's Cand is free again
  }
}

// The consolidating wide kernel's layout: where the particle's planes fit
// (K <= 4096, as detect_wide_kernel's) and shared memory holds them with
// the live-lane words, the barrier and the staged [6, K] planes | each
// warp's ConsCand | the words [M, W]; otherwise each warp's ConsCand
// after 16 bytes, with the planes read from device memory and the words
// in the caller's scratch [P, M, W]. 3 blocks an SM at the dense
// K = 2048, M = 72 (75,808 bytes: the 7 consolidation planes, read once a
// column in the column pass, are not staged; z4 and the normalizers stay
// in device memory, a few hundred bytes the L1 keeps)
constexpr int kConsWideMinBlocks = 3;

// its per-warp buffer: pass 1's candidates (value, feature), then the
// column pass's entries (w_det, row and column), then pass 3's surviving
// features and, in place of the values, the warp's Slots
struct ConsCand {
  union {
    float v[kCand];
    Slots s;
  };
  int i[kCand];
};

// detect_cons_wide_kernel's column pass: column_pass's steps (Column) in
// its order, with the live rows' w_det of the warp's 32 columns evaluated
// by the whole warp together. A dense 32-column word has ~34 rows with a
// live lane and ~80 live lanes (the dense K = 2048 scene), ~3 a column:
// column_pass's warp evaluates pdw once a row with a live lane, a lane or
// two at a time, and steps through every row; here each block of 32 rows
// is read a row a lane, its bit matrix transposed across the warp (5
// shuffles) so that each lane holds its column's live rows as bits, the
// live lanes listed column by column (a scan of the counts) in the warp's
// buffer, their w_det = pdw / norm evaluated a lane an entry, and each
// lane visits its own entries, rows ascending. The head's innovation and
// the members' are recomputed from the planes (lane_innov, the same
// bits); a member clears its bit with an atomic and. A block of rows
// with more than kCand live lanes is visited a lane at a time, each
// lane evaluating its own (column_pass's way).

// the 32 x 32 bit matrix held a row a lane (bit j: column j), transposed
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  constexpr unsigned kLow[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                                0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int d = 16 >> i;
    const unsigned y = __shfl_xor_sync(kFull, x, d);
    x = (lane & d) ? (x & ~kLow[i]) | ((y >> d) & kLow[i])
                   : (x & kLow[i]) | ((y & kLow[i]) << d);
  }
  return x;
}

// visit(m, w_det) for each live row m of the lane's column (ascending)
// where ``take``
template <class Visit>
__device__ __forceinline__ void column_rows(const float* sp, const float* z,
                                            const float* nrm,
                                            const unsigned* col_words,
                                            int W, int K, int M, int kb,
                                            bool take, ConsCand& cd,
                                            int lane, Visit&& visit) {
  const int k = kb + lane;
  for (int m0 = 0; m0 < M; m0 += 32) {
    const unsigned wl = m0 + lane < M ? col_words[(m0 + lane) * W] : 0u;
    const unsigned t32 = transpose32(wl, lane);  // every lane shuffles
    const unsigned mine = take ? t32 : 0u;
    const int cnt = __popc(mine);
    int end = cnt;                      // inclusive scan of the counts
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end += o;
    }
    const int total = __shfl_sync(kFull, end, 31);
    if (total == 0) continue;           // warp-uniform
    if (total > kCand) {
      for (unsigned t = mine; t != 0u; t &= t - 1u) {
        const int m = m0 + __ffs(t) - 1;
        float ir, ib;
        visit(m, lane_pdw(sp, K, k, z[4 * m], z[4 * m + 1], ir, ib) / nrm[m]);
      }
      continue;
    }
    int pos = end - cnt;
    for (unsigned t = mine; t != 0u; t &= t - 1u)
      cd.i[pos++] = ((m0 + __ffs(t) - 1) << 5) | lane;
    __syncwarp();
    for (int q = lane; q < total; q += 32) {
      const int e = cd.i[q];
      const int m = e >> 5;
      float ir, ib;
      cd.v[q] = lane_pdw(sp, K, kb + (e & 31), z[4 * m], z[4 * m + 1], ir,
                         ib) / nrm[m];
    }
    __syncwarp();
    for (int q = end - cnt; q < end; ++q) visit(cd.i[q] >> 5, cd.v[q]);
    __syncwarp();                       // the buffer is free again
  }
}

// sp, gx, z, nrm, words, cp as column_pass's; cd: the warp's buffer
__device__ __forceinline__ void column_pass_wide(const float* sp,
                                                 const float* gx,
                                                 const float* z,
                                                 const float* nrm,
                                                 unsigned* words, int K,
                                                 int M, float min_sep,
                                                 float* cp, ConsCand& cd) {
  const int W = (K + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int kb = 32 * warp; kb < K; kb += 32 * kWarps) {
    const int k = kb + lane;
    const bool real = k < K;
    unsigned* col_words = words + (kb >> 5);
    Column c;
    column_start(c);
    int head = -1;                      // column_head's rule, its row kept
    column_rows(sp, z, nrm, col_words, W, K, M, kb, true, cd, lane,
                [&](int m, float wd) {
                  if (wd > c.best) {
                    c.best = wd;
                    head = m;
                  }
                });
    if (head >= 0)
      lane_innov(sp, K, k, z[4 * head], z[4 * head + 1], c.uh_r, c.uh_b);
    column_open(c, gx, K, k, real, min_sep);
    if (__any_sync(kFull, c.flag)) {    // else no member in these columns
      column_rows(sp, z, nrm, col_words, W, K, M, kb, c.flag, cd, lane,
                  [&](int m, float wd) {
                    float ir, ib, du_r, du_b;
                    lane_innov(sp, K, k, z[4 * m], z[4 * m + 1], ir, ib);
                    if (column_near(c, ir, ib, min_sep, du_r, du_b)) {
                      column_add(c, wd, du_r, du_b);
                      atomicAnd(col_words + m * W, ~(1u << lane));
                    }
                  });
    }
    column_close(c, cp, K, k, real);
  }
}

size_t cons_wide_smem(int K, int M, bool staged) {
  const size_t cand = kWarps * sizeof(ConsCand);
  if (!staged) return 16 + cand;
  return slots_offset(K) + cand
         + sizeof(unsigned) * static_cast<size_t>(M) * ((K + 31) / 32);
}

bool cons_wide_staged(int K, int M) {
  return kPdwPlanes * K <= kWideStaged
         && cons_wide_smem(K, M, true) <= kMaxSmem;
}

// The consolidating variant at any K, in detect_cons_kernel's three passes
// and its sums' order, so the same bits as the first design:
//   pass 1, a warp per row: detect_wide_kernel's pass (pdw once, the
//     normalizer in the narrow kernels' order, the row's candidates
//     pdw >= min_fw * cb in the warp's Cand); with the normalizer the live
//     lanes among the candidates set their bits in the row's words
//     (a row with more than kCand candidates evaluates pdw again over the
//     whole row, one ballot a word);
//   pass 2: column_pass_wide, the narrow kernels' column steps (Column)
//     in their order (the head and the member sums visiting only the live
//     rows of each column, the member bits cleared), the live lanes'
//     pdw evaluated by the whole warp together in its buffer;
//   pass 3, a warp per row: the count from the words' bits; at most kCand
//     surviving lanes (and at most 32, or T <= 32) are compacted in
//     feature order into the warp's Cand, their pdw evaluated again (the
//     same device function, the same bits), and selected as
//     detect_wide_kernel selects its candidates; more walk the row in
//     tiles (wide_select, the first design's pass 3).
__global__ void __launch_bounds__(kThreads, kConsWideMinBlocks)
detect_cons_wide_kernel(const float* __restrict__ planes,
                        const float* __restrict__ z4,
                        float* __restrict__ vals, int* __restrict__ idx,
                        float* __restrict__ norm, int* __restrict__ count,
                        float* __restrict__ cons, unsigned* __restrict__ words,
                        int K, int M, int T, float min_fw, float cb,
                        float min_sep, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) / 32;
  const int p = blockIdx.x;
  const float* gp = planes + static_cast<size_t>(p) * kConsPlanes * K;
  uint64_t* bar = nullptr;
  const float* sp =
      staged ? phd::stage_slab(gp, kPdwPlanes * K, smem, &bar) : gp;
  ConsCand* cands =
      reinterpret_cast<ConsCand*>(smem + (staged ? slots_offset(K) : 16));
  unsigned* bits = staged ? reinterpret_cast<unsigned*>(cands + kWarps)
                          : words + static_cast<size_t>(p) * M * W;
  float* pn = norm + static_cast<size_t>(p) * M;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  ConsCand& cd = cands[warp];
  Slots& sl = cd.s;
  const float lb = min_fw >= 0.f ? min_fw * cb : 0.f;
  if (staged) {
    __syncthreads();                    // the slab's head and tail
    phd::mbar_wait(bar, 0);             // its bulk-copied middle
  }

  // pass 1: pdw once, the normalizer, the live lanes as words
  for (int m = warp; m < M; m += kWarps) {
    const float zr = z4[4 * m], zb = z4[4 * m + 1];
    const bool zvalid = z4[4 * m + 2] > 0.5f;
    float sum = 0.f;
    int n_cand = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      float v = 0.f;
      if (k < K && zvalid) {
        float ir, ib;
        v = lane_pdw(sp, K, k, zr, zb, ir, ib);
      }
      sum += v;
      const bool cand = v >= lb && v > 0.f;
      const unsigned bc = __ballot_sync(kFull, cand);
      const int q = n_cand + __popc(bc & below);
      if (cand && q < kCand) {
        cd.v[q] = v;
        cd.i[q] = k;
      }
      n_cand += __popc(bc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    const float nrm = sum + cb;
    const float thr = min_fw * nrm;
    unsigned* rw = bits + m * W;
    if (n_cand <= kCand) {
      for (int w = lane; w < W; w += 32) rw[w] = 0u;
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kCandPerLane; ++u) {
        const int q = lane + 32 * u;
        if (q < n_cand) {
          const float v = cd.v[q];
          const int k = cd.i[q];
          if (v >= thr && v > 0.f) atomicOr(rw + (k >> 5), 1u << (k & 31));
        }
      }
    } else {
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int k = k0 + lane;
        bool live = false;
        if (k < K && zvalid) {
          float ir, ib;
          const float v = lane_pdw(sp, K, k, zr, zb, ir, ib);
          live = v >= thr && v > 0.f;
        }
        const unsigned b = __ballot_sync(kFull, live);
        if (lane == 0) rw[k0 >> 5] = b;
      }
    }
    if (lane == 0) pn[m] = nrm;
    __syncwarp();                        // the warp's Cand is free again
  }
  __syncthreads();

  // pass 2: the column pass, the warp evaluating its live lanes together
  column_pass_wide(sp, gp + kPdwPlanes * K, z4, pn, bits, K, M, min_sep,
                   cons + static_cast<size_t>(p) * kConsOut * K, cd);
  __syncthreads();

  // pass 3: the count and the top-T over the live non-member lanes
  for (int m = warp; m < M; m += kWarps) {
    const float zr = z4[4 * m], zb = z4[4 * m + 1];
    const unsigned* rw = bits + m * W;
    int cnt = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const unsigned word = w0 + lane < W ? rw[w0 + lane] : 0u;
      cnt += __reduce_add_sync(kFull, __popc(word));
    }
    const size_t row = static_cast<size_t>(p) * M + m;
    float* vrow = vals + row * T;
    int* irow = idx + row * T;
    if (cnt == 0) {
      write_row(0.f, 0, 0, T, lane, vrow, irow);
    } else if (cnt <= kCand && (cnt <= 32 || T <= 32)) {
      // the surviving features in feature order: an exclusive scan of the
      // words' bit counts, word block by word block
      int base = 0;
      for (int w0 = 0; w0 < W; w0 += 32) {
        const unsigned word = w0 + lane < W ? rw[w0 + lane] : 0u;
        const int own = __popc(word);
        int off = own;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int o = __shfl_up_sync(kFull, off, d);
          if (lane >= d) off += o;
        }
        int pos = base + off - own;
        for (unsigned w = word; w != 0u; w &= w - 1u)
          cd.i[pos++] = 32 * (w0 + lane) + __ffs(w) - 1;
        base += __shfl_sync(kFull, off, 31);
      }
      __syncwarp();
      unsigned key[kCandPerLane];
#pragma unroll
      for (int u = 0; u < kCandPerLane; ++u) {
        const int q = lane + 32 * u;
        key[u] = 0u;
        if (q < cnt) {
          float ir, ib;
          key[u] = __float_as_uint(lane_pdw(sp, K, cd.i[q], zr, zb, ir, ib));
        }
      }
      int r;
      const unsigned thr_k = top_threshold<kCandPerLane>(key, cnt, T, r);
      float v;
      int i;
      const int n_sel =
          select_sorted<kCandPerLane>(key, thr_k, r, lane, sl, 0, v, i);
      if (lane < n_sel) i = cd.i[i];
      write_row(v, i, n_sel, T, lane, vrow, irow);
    } else {
      const auto key = [&](int k) -> unsigned {
        if (k >= K || !((rw[k >> 5] >> (k & 31)) & 1u)) return 0u;
        float ir, ib;
        return __float_as_uint(lane_pdw(sp, K, k, zr, zb, ir, ib));
      };
      wide_select(key, K, T, lane, sl, vrow, irow);
    }
    if (lane == 0) count[row] = cnt;
    __syncwarp();                        // the warp's Cand is free again
  }
}

// Allow detect_wide_kernel / detect_cons_wide_kernel the dynamic shared
// memory of a launch
cudaError_t allow_wide(size_t smem) {
  static int allowed[phd::kMaxDevices] = {};
  return phd::allow_smem(detect_wide_kernel, static_cast<int>(smem),
                         allowed);
}

cudaError_t allow_cons_wide(size_t smem) {
  static int allowed[phd::kMaxDevices] = {};
  return phd::allow_smem(detect_cons_wide_kernel, static_cast<int>(smem),
                         allowed);
}

struct Args {
  const float* planes;
  const float* z4;
  float* vals;
  int* idx;
  float* norm;
  int* count;
  float* cons;
  int P, K, M, T;
  float min_fw, cb, min_sep;
};

size_t plain_smem(int K) {
  return slots_offset(K) + kWarps * sizeof(Slots);
}

size_t cons_smem(int K, int M) {
  return plain_smem(K) + sizeof(float) * 5 * static_cast<size_t>(M)
         + sizeof(unsigned) * static_cast<size_t>(M) * ((K + 31) / 32);
}

template <int KPL>
int launch(const Args& a, cudaStream_t stream) {
  if (a.cons == nullptr) {
    // at most 26.6 KB (K = 1024): under the 48 KB default
    detect_kernel<KPL><<<a.P, kThreads, plain_smem(a.K), stream>>>(
        a.planes, a.z4, a.vals, a.idx, a.norm, a.count, a.K, a.M, a.T,
        a.min_fw, a.cb);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = cons_smem(a.K, a.M);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed[phd::kMaxDevices] = {};
  auto* kernel = detect_cons_kernel<KPL>;
  const cudaError_t err =
      phd::allow_smem(kernel, static_cast<int>(smem), allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.P, kThreads, smem, stream>>>(
      a.planes, a.z4, a.vals, a.idx, a.norm, a.count, a.cons, a.K, a.M, a.T,
      a.min_fw, a.cb, a.min_sep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cons == nullptr: the plain kernel on planes [P, 6, K]; otherwise the
// consolidating kernel on planes [P, 13, K], writing cons [P, 10, K]
extern "C" int phd_detect(const float* planes, const float* z4, float* vals,
                          int* idx, float* norm, int* count, float* cons,
                          int P, int K, int M, int T, float min_fw, float cb,
                          float min_sep, void* stream) {
  if (P <= 0 || M <= 0) return 0;
  if (T <= 0 || T > K) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{planes, z4, vals, idx, norm, count, cons, P, K, M, T,
               min_fw, cb, min_sep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 128) return launch<4>(a, s);
  if (K <= 256) return launch<8>(a, s);
  if (K <= 512) return launch<16>(a, s);
  if (K <= 1024) return launch<32>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// detect_wide_kernel's launch at K features on the current device, into
// out[5]: threads a block, dynamic shared memory (bytes), 1 where the
// planes are staged in shared memory (0: read from device memory),
// registers a thread, resident blocks an SM
extern "C" int phd_detect_wide_plan(int K, int* out) {
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wide_smem(K);
  cudaError_t err = allow_wide(smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, detect_wide_kernel);
  int occ = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, detect_wide_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {kThreads, static_cast<int>(smem),
                       kPdwPlanes * K <= kWideStaged ? 1 : 0, attr.numRegs,
                       occ};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return 0;
}

// detect_cons_wide_kernel's launch at K features and M rows on the
// current device, into out[5] as phd_detect_wide_plan's (staged 0: the
// planes read from device memory and the live-lane words in the caller's
// scratch)
extern "C" int phd_detect_cons_wide_plan(int K, int M, int* out) {
  if (K <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = cons_wide_staged(K, M);
  const size_t smem = cons_wide_smem(K, M, staged);
  cudaError_t err = allow_cons_wide(smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, detect_cons_wide_kernel);
  int occ = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, detect_cons_wide_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {kThreads, static_cast<int>(smem), staged ? 1 : 0,
                       attr.numRegs, occ};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return 0;
}

// The wide variants at any K (the wrapper takes them above 1024): cons ==
// nullptr runs the plain one on planes [P, 6, K], otherwise the
// consolidating one on planes [P, 13, K], writing cons [P, 10, K], with
// ``words`` uint32 [P, M, (K + 31) / 32] as scratch where its plan is not
// staged (else unused, may be NULL)
extern "C" int phd_detect_wide(const float* planes, const float* z4,
                               float* vals, int* idx, float* norm, int* count,
                               float* cons, unsigned* words, int P, int K,
                               int M, int T, float min_fw, float cb,
                               float min_sep, void* stream) {
  if (P <= 0 || M <= 0) return 0;
  if (T <= 0 || T > K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cons == nullptr) {
    const size_t smem = wide_smem(K);
    const cudaError_t err = allow_wide(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    detect_wide_kernel<<<P, kThreads, smem, s>>>(planes, z4, vals, idx, norm,
                                                 count, K, M, T, min_fw, cb);
  } else {
    const bool staged = cons_wide_staged(K, M);
    if (!staged && words == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = cons_wide_smem(K, M, staged);
    const cudaError_t err = allow_cons_wide(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    detect_cons_wide_kernel<<<P, kThreads, smem, s>>>(
        planes, z4, vals, idx, norm, count, cons, words, K, M, T, min_fw, cb,
        min_sep, staged ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}
