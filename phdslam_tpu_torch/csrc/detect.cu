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

// pdw of feature k against (zr, zb), with its innovation (ir, ib); planes
// r, bearing, si00, si01, si11, pref at sp + i * K
__device__ __forceinline__ float lane_pdw(const float* sp, int K, int k,
                                          float zr, float zb, float& ir,
                                          float& ib) {
  ir = zr - sp[k];
  ib = phd::wrap_angle_floor(zb - sp[K + k]);
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

// The consolidating kernels' column pass: a thread per column k, a warp
// per 32 consecutive columns (one bit word a row, which only this warp
// reads and writes). sp: the 6 pdw planes, gx: the 7 consolidation planes
// (wp, q.., p..), z: z4 [M, 4], nrm: the rows' normalizers, words: the
// live lanes [M, W] (members cleared here), cp: this particle's cons
// [10, K]
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
    // the head copy: the heaviest live w_det, the lowest m among ties
    float best = -INFINITY;
    float uh_r = 0.f, uh_b = 0.f;
    for (int m = 0; m < M; ++m) {
      if ((col_words[m * W] >> lane) & 1u) {
        float ir, ib;
        const float v = lane_pdw(sp, K, k, z[4 * m], z[4 * m + 1], ir, ib);
        const float wd = v / nrm[m];
        if (wd > best) {
          best = wd;
          uh_r = ir;
          uh_b = ib;
        }
      }
    }
    const float colmax = fmaxf(best, 0.f);
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
    const float c_r = head_p ? 0.f : uh_r;
    const float c_b = head_p ? 0.f : uh_b;
    const float pers_near = p00 * uh_r * uh_r + 2.f * p01 * uh_r * uh_b
                            + p11 * uh_b * uh_b;
    const bool pers_in = wp > 0.f && (head_p || pers_near < min_sep)
                         && has_copy;
    const bool flag = has_copy && (wp <= 0.f || pers_in);
    const float a00 = head_p ? p00 : q00;
    const float a01 = head_p ? p01 : q01;
    const float a11 = head_p ? p11 : q11;
    float s_w = 0.f, s_r = 0.f, s_b = 0.f, s_rr = 0.f, s_rb = 0.f,
          s_bb = 0.f;
    int n_mem = 0;
    if (__any_sync(kFull, flag)) {       // else no member in these columns
      for (int m = 0; m < M; ++m) {
        const unsigned word = col_words[m * W];
        bool member = false;
        if (flag && ((word >> lane) & 1u)) {
          float ir, ib;
          const float v = lane_pdw(sp, K, k, z[4 * m], z[4 * m + 1], ir,
                                   ib);
          const float du_r = ir - c_r;
          const float du_b = ib - c_b;
          const float quad = a00 * du_r * du_r + 2.f * a01 * du_r * du_b
                             + a11 * du_b * du_b;
          if (quad < min_sep) {
            member = true;
            const float wm = v / nrm[m];
            s_w += wm;
            s_r += wm * du_r;
            s_b += wm * du_b;
            s_rr += wm * du_r * du_r;
            s_rb += wm * du_r * du_b;
            s_bb += wm * du_b * du_b;
            ++n_mem;
          }
        }
        const unsigned bits = __ballot_sync(kFull, member);
        if (lane == 0 && bits != 0u) col_words[m * W] = word & ~bits;
      }
    }
    if (real) {
      cp[k] = s_w;
      cp[K + k] = s_r;
      cp[2 * K + k] = s_b;
      cp[3 * K + k] = s_rr;
      cp[4 * K + k] = s_rb;
      cp[5 * K + k] = s_bb;
      cp[6 * K + k] = c_r;
      cp[7 * K + k] = c_b;
      cp[8 * K + k] = static_cast<float>(n_mem);
      cp[9 * K + k] = pers_in ? 1.f : 0.f;
    }
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
// them (see the kernel); detect_cons_wide_kernel keeps the first design.
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

// The warp-wide sum of a row's pdw in the narrow kernels' order, plus cb
__device__ __forceinline__ float wide_norm(const float* sp, int K, int lane,
                                           float zr, float zb, bool zvalid,
                                           float cb) {
  float sum = 0.f;
  for (int k = lane; k < K; k += 32) {
    float v = 0.f;
    if (zvalid) {
      float ir, ib;
      v = lane_pdw(sp, K, k, zr, zb, ir, ib);
    }
    sum += v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  return sum + cb;
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

// The consolidating kernel's three passes (see detect_cons_kernel) with
// the live-lane words in ``words`` [P, M, W] (device memory) and the
// normalizers read back from ``norm``
__global__ void __launch_bounds__(kThreads)
detect_cons_wide_kernel(const float* __restrict__ planes,
                        const float* __restrict__ z4,
                        float* __restrict__ vals, int* __restrict__ idx,
                        float* __restrict__ norm, int* __restrict__ count,
                        float* __restrict__ cons, unsigned* __restrict__ words,
                        int K, int M, int T, float min_fw, float cb,
                        float min_sep) {
  __shared__ Slots slots[kWarps];
  const int W = (K + 31) / 32;
  const int p = blockIdx.x;
  const float* sp = planes + static_cast<size_t>(p) * kConsPlanes * K;
  unsigned* pw = words + static_cast<size_t>(p) * M * W;
  float* pn = norm + static_cast<size_t>(p) * M;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // pass 1: a warp per row: the normalizer and the live lanes as words
  for (int m = warp; m < M; m += kWarps) {
    const float zr = z4[4 * m], zb = z4[4 * m + 1];
    const bool zvalid = z4[4 * m + 2] > 0.5f;
    const float nrm = wide_norm(sp, K, lane, zr, zb, zvalid, cb);
    const float thr = min_fw * nrm;
    for (int w0 = 0; w0 < W; w0 += 32) {
      unsigned word = 0u;
      for (int j = 0; j < 32 && w0 + j < W; ++j) {
        const int k = 32 * (w0 + j) + lane;
        bool live = false;
        if (k < K && zvalid) {
          float ir, ib;
          const float v = lane_pdw(sp, K, k, zr, zb, ir, ib);
          live = v >= thr && v > 0.f;
        }
        const unsigned b = __ballot_sync(kFull, live);
        if (lane == j) word = b;
      }
      if (w0 + lane < W) pw[m * W + w0 + lane] = word;
    }
    if (lane == 0) pn[m] = nrm;
  }
  __syncthreads();

  // pass 2: the column pass
  column_pass(sp, sp + kPdwPlanes * K, z4, pn, pw, K, M, min_sep,
              cons + static_cast<size_t>(p) * kConsOut * K);
  __syncthreads();

  // pass 3: the count and the top-T over the live non-member lanes
  for (int m = warp; m < M; m += kWarps) {
    const float zr = z4[4 * m], zb = z4[4 * m + 1];
    const unsigned* rw = pw + m * W;
    const auto key = [&](int k) -> unsigned {
      if (k >= K || !((rw[k >> 5] >> (k & 31)) & 1u)) return 0u;
      float ir, ib;
      return __float_as_uint(lane_pdw(sp, K, k, zr, zb, ir, ib));
    };
    const size_t row = static_cast<size_t>(p) * M + m;
    const int cnt =
        wide_select(key, K, T, lane, slots[warp], vals + row * T,
                    idx + row * T);
    if (lane == 0) count[row] = cnt;
  }
}

// Allows detect_wide_kernel the dynamic shared memory of a launch
cudaError_t allow_wide(size_t smem) {
  static int allowed[phd::kMaxDevices] = {};
  return phd::allow_smem(detect_wide_kernel, static_cast<int>(smem),
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

// The wide variants at any K (the wrapper takes them above 1024): cons ==
// nullptr runs the plain one on planes [P, 6, K], otherwise the
// consolidating one on planes [P, 13, K], writing cons [P, 10, K], with
// ``words`` uint32 [P, M, (K + 31) / 32] as scratch
extern "C" int phd_detect_wide(const float* planes, const float* z4,
                               float* vals, int* idx, float* norm, int* count,
                               float* cons, unsigned* words, int P, int K,
                               int M, int T, float min_fw, float cb,
                               float min_sep, void* stream) {
  if (P <= 0 || M <= 0) return 0;
  if (T <= 0 || T > K || (cons != nullptr && words == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cons == nullptr) {
    const size_t smem = wide_smem(K);
    const cudaError_t err = allow_wide(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    detect_wide_kernel<<<P, kThreads, smem, s>>>(planes, z4, vals, idx, norm,
                                                 count, K, M, T, min_fw, cb);
  } else
    detect_cons_wide_kernel<<<P, kThreads, 0, s>>>(
        planes, z4, vals, idx, norm, count, cons, words, K, M, T, min_fw, cb,
        min_sep);
  return static_cast<int>(cudaGetLastError());
}
