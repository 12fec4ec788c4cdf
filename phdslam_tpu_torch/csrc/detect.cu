// Fused detection grid + normalizer + top-T selection for the GM-PHD update.
//
// Replaces phdslam_tpu/ops/pallas_detect.py::_detect_kernel in all of its
// modes: plain, with adaptive trips (adaptive=True) and with same-source
// pre-consolidation (cons_ref, min_sep > 0), alone or together.
// Semantics, per particle p and measurement m:
//   pdw[k]  = pref[k] * exp(-0.5 d' S^-1 d), d = (zr - r[k], wrap(zb - b[k]))
//   norm    = sum_k pdw[k] + cb
//   live[k] = pdw[k] >= min_fw * norm && pdw[k] > 0 (and z valid)
//   vals/idx: the T heaviest live lanes, ties to the lowest k; trips past
//   the live lanes emit (0, 0); count = number of live lanes.
// Adaptive trips stop a row once its lanes are used up and write the (0, 0)
// tail the static trips would have written, so the outputs are the same
// bits (the Pallas kernel exits per block of 8 particles; a per-warp exit
// gives the same outputs).
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
// What bounds it on Hopper: per (p, m) the work is K exp() plus T
// arg-max reductions over K lanes; the only device-memory traffic is the
// particle's 6 (13) x K input planes and (2T + 2) outputs per row (and 10 x
// K cons), so the kernel is latency- and instruction-bound, not
// bandwidth-bound.
// Design, plain: one warp per (p, m) row, K / 32 features per lane held in
// registers, so the [M, K] grid never leaves the register file (the TPU
// kernel kept it in VMEM for the same reason). A block of 8 warps serves 8
// measurements of one particle and stages that particle's planes in shared
// memory once. The normalizer and live count are warp shuffles; each of
// the T trips is a lane-local max followed by a 5-step shuffle
// (max value, lowest index) reduction, which reproduces the TPU kernel's
// lowest-index tie rule without the one-hot iota planes it needed.
// Design, consolidating: the top-T needs per-column facts over all M rows
// (the column max, the head row, membership), which no row block sees, and
// the [M, K] grid does not fit in shared memory at K = 1024. So one block
// per particle runs three passes over the grid, recomputing pdw each time
// with the same device function (the same bits): (1) a warp per row for
// the normalizers, kept in shared memory; (2) a thread per column (a warp
// per 32 columns) for the head, the member test and the member sums, the
// membership kept as an [M, K] bit mask in shared memory (one __ballot_sync
// word per 32 columns and row); (3) a warp per row for the count and the
// top-T over the live lanes that are not members.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "wrap.cuh"

namespace {

constexpr int kWarps = 8;                       // warps per block
constexpr int kConsPlanes = 13;
constexpr int kConsOut = 10;
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

// One warp's row: pdw of features lane + 32 j into registers; returns the
// warp-wide sum of pdw
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
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// One warp's row: live lanes (pdw >= thr, > 0, and not a member when
// ``member`` holds the row's bit words), their count and the top-T
template <int KPL, bool kAdaptive>
__device__ __forceinline__ void row_select(const float (&pdw)[KPL], int K,
                                           int lane, float thr,
                                           const unsigned* member, int T,
                                           float* vals, int* idx,
                                           int* count) {
  // work: live pdw, -1 for dead lanes (as in the TPU kernel), -2 past K so
  // padding lanes never win even once every real lane is exhausted
  float work[KPL];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + 32 * j;
    bool live = k < K && pdw[j] >= thr && pdw[j] > 0.f;
    if (live && member != nullptr && ((member[j] >> lane) & 1u)) live = false;
    work[j] = live ? pdw[j] : (k < K ? -1.f : -2.f);
    cnt += live ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0) *count = cnt;

  for (int t = 0; t < T; ++t) {
    float bv = -3.f;
    int bk = INT_MAX;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {      // k rises with j: strict > keeps
      if (work[j] > bv) {                // the lowest k among equal values
        bv = work[j];
        bk = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
      if (ov > bv || (ov == bv && ok < bk)) {
        bv = ov;
        bk = ok;
      }
    }
    // every lane holds the same (bv, bk): the exit is warp-uniform. A trip
    // over used-up lanes (bv = -1, bk = 0) emits (0, 0), as written here.
    if (kAdaptive && bv <= 0.f) {
      for (int u = t + lane; u < T; u += 32) {
        vals[u] = 0.f;
        idx[u] = 0;
      }
      return;
    }
    if (lane == 0) {
      vals[t] = fmaxf(bv, 0.f);
      idx[t] = bk;
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      if (lane + 32 * j == bk) work[j] = -1.f;
  }
}

template <int KPL, bool kAdaptive>
__global__ void detect_kernel(const float* __restrict__ planes,
                              const float* __restrict__ z4,
                              float* __restrict__ vals,
                              int* __restrict__ idx,
                              float* __restrict__ norm,
                              int* __restrict__ count,
                              int K, int M, int T, float min_fw, float cb) {
  extern __shared__ float sp[];                 // [6, K] of particle p
  const int p = blockIdx.x;
  const float* src = planes + static_cast<size_t>(p) * 6 * K;
  for (int i = threadIdx.x; i < 6 * K; i += blockDim.x) sp[i] = src[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.y * kWarps + warp;
  if (m >= M) return;

  float pdw[KPL];
  const float nrm = row_pdw<KPL>(sp, K, lane, z4[4 * m], z4[4 * m + 1],
                                 z4[4 * m + 2] > 0.5f, pdw) + cb;
  const size_t row = static_cast<size_t>(p) * M + m;
  if (lane == 0) norm[row] = nrm;
  row_select<KPL, kAdaptive>(pdw, K, lane, min_fw * nrm, nullptr, T,
                             vals + row * T, idx + row * T, count + row);
}

template <int KPL, bool kAdaptive>
__global__ void __launch_bounds__(32 * kWarps)
detect_cons_kernel(const float* __restrict__ planes,
                   const float* __restrict__ z4, float* __restrict__ vals,
                   int* __restrict__ idx, float* __restrict__ norm,
                   int* __restrict__ count, float* __restrict__ cons, int K,
                   int M, int T, float min_fw, float cb, float min_sep) {
  // [13, K] planes | z4 [M, 4] | norms [M] | member bits [M, W]
  extern __shared__ float sp[];
  const int W = (K + 31) / 32;
  float* sz = sp + kConsPlanes * K;
  float* snorm = sz + 4 * M;
  unsigned* sbits = reinterpret_cast<unsigned*>(snorm + M);
  const int p = blockIdx.x;
  const float* src = planes + static_cast<size_t>(p) * kConsPlanes * K;
  for (int i = threadIdx.x; i < kConsPlanes * K; i += blockDim.x)
    sp[i] = src[i];
  for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) sz[i] = z4[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // pass 1: the normalizers, a warp per row
  for (int m = warp; m < M; m += kWarps) {
    float pdw[KPL];
    const float nrm = row_pdw<KPL>(sp, K, lane, sz[4 * m], sz[4 * m + 1],
                                   sz[4 * m + 2] > 0.5f, pdw) + cb;
    if (lane == 0) snorm[m] = nrm;
  }
  __syncthreads();

  // pass 2: a thread per column k, a warp per 32 consecutive columns
  float* cp = cons + static_cast<size_t>(p) * kConsOut * K;
  for (int kb = 32 * warp; kb < K; kb += 32 * kWarps) {
    const int k = kb + lane;
    const bool real = k < K;
    // the head copy: the heaviest live w_det, the lowest m among ties
    float best = -INFINITY;
    float uh_r = 0.f, uh_b = 0.f;
    if (real) {
      for (int m = 0; m < M; ++m) {
        if (!(sz[4 * m + 2] > 0.5f)) continue;
        float ir, ib;
        const float v = lane_pdw(sp, K, k, sz[4 * m], sz[4 * m + 1], ir, ib);
        if (v >= min_fw * snorm[m] && v > 0.f) {
          const float wd = v / snorm[m];
          if (wd > best) {
            best = wd;
            uh_r = ir;
            uh_b = ib;
          }
        }
      }
    }
    const float colmax = fmaxf(best, 0.f);
    const float wp = real ? sp[6 * K + k] : 0.f;
    const float q00 = real ? sp[7 * K + k] : 0.f;
    const float q01 = real ? sp[8 * K + k] : 0.f;
    const float q11 = real ? sp[9 * K + k] : 0.f;
    const float p00 = real ? sp[10 * K + k] : 0.f;
    const float p01 = real ? sp[11 * K + k] : 0.f;
    const float p11 = real ? sp[12 * K + k] : 0.f;
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
    for (int m = 0; m < M; ++m) {
      bool member = false;
      if (real && flag && sz[4 * m + 2] > 0.5f) {
        float ir, ib;
        const float v = lane_pdw(sp, K, k, sz[4 * m], sz[4 * m + 1], ir, ib);
        if (v >= min_fw * snorm[m] && v > 0.f) {
          const float du_r = ir - c_r;
          const float du_b = ib - c_b;
          const float quad = a00 * du_r * du_r + 2.f * a01 * du_r * du_b
                             + a11 * du_b * du_b;
          if (quad < min_sep) {
            member = true;
            const float wm = v / snorm[m];
            s_w += wm;
            s_r += wm * du_r;
            s_b += wm * du_b;
            s_rr += wm * du_r * du_r;
            s_rb += wm * du_r * du_b;
            s_bb += wm * du_b * du_b;
            ++n_mem;
          }
        }
      }
      const unsigned bits = __ballot_sync(0xffffffffu, member);
      if (lane == 0) sbits[m * W + (kb >> 5)] = bits;
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
  __syncthreads();

  // pass 3: the count and the top-T over live non-member lanes, a warp per
  // row
  for (int m = warp; m < M; m += kWarps) {
    float pdw[KPL];
    row_pdw<KPL>(sp, K, lane, sz[4 * m], sz[4 * m + 1], sz[4 * m + 2] > 0.5f,
                 pdw);
    const float nrm = snorm[m];
    const size_t row = static_cast<size_t>(p) * M + m;
    if (lane == 0) norm[row] = nrm;
    row_select<KPL, kAdaptive>(pdw, K, lane, min_fw * nrm, sbits + m * W, T,
                               vals + row * T, idx + row * T, count + row);
  }
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

size_t cons_smem(int K, int M) {
  return sizeof(float) * (kConsPlanes * static_cast<size_t>(K) + 5 * M)
         + sizeof(unsigned) * static_cast<size_t>(M) * ((K + 31) / 32);
}

template <int KPL, bool kAdaptive>
int launch(const Args& a, cudaStream_t stream) {
  if (a.cons == nullptr) {
    const dim3 grid(a.P, (a.M + kWarps - 1) / kWarps);
    detect_kernel<KPL, kAdaptive><<<grid, 32 * kWarps,
                                    sizeof(float) * 6 * a.K, stream>>>(
        a.planes, a.z4, a.vals, a.idx, a.norm, a.count, a.K, a.M, a.T,
        a.min_fw, a.cb);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = cons_smem(a.K, a.M);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = detect_cons_kernel<KPL, kAdaptive>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<a.P, 32 * kWarps, smem, stream>>>(
      a.planes, a.z4, a.vals, a.idx, a.norm, a.count, a.cons, a.K, a.M, a.T,
      a.min_fw, a.cb, a.min_sep);
  return static_cast<int>(cudaGetLastError());
}

template <int KPL>
int dispatch(const Args& a, int adaptive, cudaStream_t stream) {
  return adaptive ? launch<KPL, true>(a, stream)
                  : launch<KPL, false>(a, stream);
}

}  // namespace

// cons == nullptr: the plain kernel on planes [P, 6, K]; otherwise the
// consolidating kernel on planes [P, 13, K], writing cons [P, 10, K]
extern "C" int phd_detect(const float* planes, const float* z4, float* vals,
                          int* idx, float* norm, int* count, float* cons,
                          int P, int K, int M, int T, float min_fw, float cb,
                          float min_sep, int adaptive, void* stream) {
  if (P <= 0 || M <= 0) return 0;
  if (T <= 0 || T > K) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{planes, z4, vals, idx, norm, count, cons, P, K, M, T,
               min_fw, cb, min_sep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 128) return dispatch<4>(a, adaptive, s);
  if (K <= 256) return dispatch<8>(a, adaptive, s);
  if (K <= 512) return dispatch<16>(a, adaptive, s);
  if (K <= 1024) return dispatch<32>(a, adaptive, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
