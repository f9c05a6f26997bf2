// Segmental CRF recursions over a (time x duration x label) lattice that is
// never materialized, for Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by asr_craft_tpu_torch/kernels/segmental.py, which holds the plain
// PyTorch version of every kernel here.
//
// Replaces the five TPU kernels of asr_craft_tpu/kernels/segmental_pallas.py:
//   seg_forward_kernel<false> <- _seg_fwd_kernel (K9,
//                                segmental_forward_pallas): alpha and logZ
//   seg_backward_kernel       <- _seg_bwd_kernel (K10,
//                                segmental_backward_pallas): beta
//   seg_grad_kernel           <- _seg_grad_kernel and the drain after it (K11,
//                                segmental_grad_pallas): the xi pass, giving
//                                the end and start contributions A and S, the
//                                bias gradient gd and the transition partial
//                                gt; sum_partials_kernel (fdt_common.cuh)
//                                adds the per-utterance gd and gt
//   seg_forward_kernel<true>  <- _seg_vit_kernel (K12,
//                                segmental_viterbi_pallas): max-plus deltas,
//                                duration argmaxes, final score and label
//   seg_traceback_kernel      <- _seg_vit_tb_kernel (K13,
//                                segmental_viterbi_traceback_pallas): the
//                                segment-end markers of the best path
//
// Layouts (batch-major).  frame (B, T, L) f32: per-frame label scores.  bias
// (Dmax, L): the duration and label bias of a segment.  invd (Dmax,): 1 /
// (d + 1) for mean pooling, else 1.  lengths (B,) i32.  The transition
// factor is formed by the wrapper: P (L, L) = exp(trans - tmax[None, :]) with
// tmax the column maxima clamped at NEG_INF (K9, K11), Pt = exp(trans^T -
// tmax_r[None, :]) with tmax_r the row maxima (K10), or trans itself (K12,
// K13).  A segment labelled l over frames [t - d, t] scores
//   seg[t, d, l] = invd[d] * (CS[t + 1, l] - CS[t - d, l]) + bias[d, l],
// CS[k] the sum of the first k frames' scores, kept as a running sum inside
// the kernel (K10 walks down and keeps the sum of the frames above, whose
// differences are the same).
//
// The recursions.  The duration message depends on its source frame u alone
// and is formed once per frame:
//   q[u, l] = m_u + tmax[l] + log(max(sum_p exp(alpha[u, p] - m_u) P[p, l],
//             1e-38)),  m_u = max(max_p alpha[u, p], NEG_INF),  q[-1] = 0
//   alpha[t, l] = lse_{d <= min(t, Dmax - 1)} (q[t - 1 - d, l] + seg[t, d, l])
//   logZ = lse_l alpha[length - 1, l]
// K12 is its max-plus twin, M[u, l] = max_p (delta[u, p] + trans[p, l]),
// delta[t, l] = max_d (M[t - 1 - d, l] + seg[t, d, l]), with arg_d the
// shortest duration among equal maxima; beam_threshold prunes delta[t] after
// arg_d is taken and before M[t] is formed.  K12's sums are single IEEE
// operations in the plain version's order (no fused multiply-add), so deltas
// and arg_d equal the plain version's bit for bit and ties fall the same way.
// K10: beta[length - 1] = 0 and, below it,
//   z[t, l'] = lse_{d: t + d + 1 < length} (seg[t + d + 1, d, l'] +
//              beta[t + d + 1, l'])
//   beta[t, l] = zm + tmax_r[l] + log(max(sum_l' exp(z[l'] - zm) Pt[l', l],
//                1e-38))
// K11, per frame t < length with x[d, l] = seg[t, d, l] + beta[t, l] - logZ:
//   xi[d, l] = g * exp(q[t - 1 - d, l] + x[d, l])
//   A[t, l] = sum_d invd[d] xi[d, l];   S[t - d, l] += invd[d] xi[d, l]
//   gd[d, l] += xi[d, l];   F[u, l] += g * exp(x[d, l] + m_u)  (u = t - 1 - d)
//   gt[p, l] = sum_u exp(alpha[u, p] - m_u) F[u, l]
// with g_trans = sign(gt) * exp(trans + log|gt|) and the frame gradient
// (reverse cumulative sums of A and S) left to the caller.  Rows at and past
// the length hold NEG_INF (alphas, betas, deltas) or 0 (A, S, arg_d).
// NEG_INF is the finite -1e30 and every max is clamped at it.
//
// What bounds them on this card.  One block owns one utterance and walks its
// frames in order; a frame is Dmax * L window terms and one (L) x (L, L)
// product, far too little to fill an SM, so the time is the latency of the
// frame chain: the window pass, a row max, the product and three block
// barriers, up to 512 times.  Against that:
// - the window is Dmax circular slots in shared memory keyed by the source
//   frame modulo Dmax: nothing is shifted, a slot's real duration is
//   computed from the frame index, and durations that would start before
//   frame 0 are skipped, not masked;
// - a label's Dmax window terms and its product over predecessors are split
//   over kGroup lanes of a warp and merged with shuffles; the factor sits in
//   shared memory with its row stride padded to 8 mod 32;
// - the running cumulative score lives in a register of each lane; the row
//   max is taken redundantly by every warp.
// K11's gd and gt cannot be carried accumulators: blocks run in parallel and
// atomics would make gradients differ from run to run.  Each block sums its
// own utterance (gd in shared memory, gt in kTile x kTile register tiles,
// one outer product when a source frame's slot retires and the last Dmax at
// the end), and sum_partials_kernel adds the B partials in batch order: the
// same bits on every run.  K13 is one warp per utterance: a serial walk of
// one (L) argmax per segment.
// Widths.  The factor, the windows and the bias must fit a block's shared
// memory (227 KB), and K11's tiles must cover (L, L) with the block's
// threads (L <= 144); seg_smem_bytes says which (L, Dmax) a kernel takes and
// the wrapper raises beyond.  Config 4 runs L = 48, Dmax = 16.
// Not done yet: several utterances per block at small L; K11 has no frame
// chain of its own (alpha and beta are inputs) and could spread an
// utterance's frames over several blocks.

#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::group_dot;
using fdtk::kGroup;
using fdtk::kMaxThreads;
using fdtk::kNegInf;
using fdtk::kProdFloor;
using fdtk::kSmemLimit;
using fdtk::kTile;
using fdtk::kTileThreads;
using fdtk::opt_in;
using fdtk::padded_stride;
using fdtk::row_max;
using fdtk::stage_matrix;
using fdtk::sum_partials_kernel;
using fdtk::take_better;
using fdtk::threads_for;

enum Kind { kForward = 0, kViterbi = 1, kBackward = 2, kGrad = 3 };
constexpr int kTracebackThreads = 128;     // four utterances per block

// A launch's shared memory.  ps: the row stride of the transition factor;
// ok false: the kernel does not take this (L, Dmax).
struct Plan {
  int ps;
  size_t bytes;
  bool ok;
};

// The factor, the (Dmax, L) windows and bias, invd, three (L) vectors and,
// for K11, the per-slot scales.  K9, K10, K12: two windows; K11: q, CS, e,
// F, S and gd.
Plan make_plan(int kind, int L, int Dmax) {
  const int ps = padded_stride(L);
  const size_t windows = kind == kGrad ? 6 : 2;
  const size_t floats = (size_t)L * ps + (windows + 1) * Dmax * L + Dmax +
                        3 * (size_t)L + (kind == kGrad ? Dmax : 0);
  const size_t bytes = sizeof(float) * floats;
  bool ok = L >= 1 && Dmax >= 1 && bytes <= kSmemLimit &&
            (long)L * kGroup <= kMaxThreads;
  if (kind == kGrad) {
    const int nt = (L + kTile - 1) / kTile;
    ok = ok && nt * nt <= threads_for(L) && threads_for(L) <= kTileThreads;
  }
  return {ps, bytes, ok};
}

// The slot of source frame t - 1 - d when frame t sits in slot r = t mod
// Dmax (0 <= d < t, d < Dmax).
__device__ __forceinline__ int source_slot(int r, int d, int Dmax) {
  const int s = r - 1 - d;
  return s < 0 ? s + Dmax : s;
}

// message + seg[t, d, l] for the segment over frames [t - d, t]: the window
// holds q (or M) and CS[u + 1] of source frame u = t - 1 - d; d == t is the
// segment from frame 0, whose message is 0 and whose CS is 0.  EXACT: single
// IEEE operations in the plain version's order.
template <bool EXACT>
__device__ __forceinline__ float window_term(const float* qw,
                                             const float* csw,
                                             const float* biasv,
                                             const float* invd, int t, int r,
                                             int d, int l, int L, int Dmax,
                                             float cum) {
  float q = 0.0f, cs = 0.0f;
  if (d < t) {
    const int s = source_slot(r, d, Dmax);
    q = qw[s * L + l];
    cs = csw[s * L + l];
  }
  if (EXACT)
    return __fadd_rn(q, __fadd_rn(__fmul_rn(__fsub_rn(cum, cs), invd[d]),
                                  biasv[d * L + l]));
  return q + ((cum - cs) * invd[d] + biasv[d * L + l]);
}

__device__ __forceinline__ float group_max(float x) {
  for (int o = 1; o < kGroup; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int o = 1; o < kGroup; o <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Loads what every kernel keeps in shared memory beside the factor.
__device__ __forceinline__ void stage_bias(const float* __restrict__ bias_g,
                                           const float* __restrict__ invd_g,
                                           float* biasv, float* invd, int L,
                                           int Dmax) {
  for (int i = threadIdx.x; i < Dmax * L; i += blockDim.x)
    biasv[i] = bias_g[i];
  for (int d = threadIdx.x; d < Dmax; d += blockDim.x) invd[d] = invd_g[d];
}

// K9 (VIT false): out = alphas, zout = logZ; factor = P.
// K12 (VIT true): out = deltas, argd, zout = scores, lab0; factor = trans.
template <bool VIT>
__global__ void __launch_bounds__(kMaxThreads)
seg_forward_kernel(const float* __restrict__ frame,
                   const float* __restrict__ factor,
                   const float* __restrict__ tmax_g,
                   const float* __restrict__ bias_g,
                   const float* __restrict__ invd_g,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   int* __restrict__ argd, float* __restrict__ zout,
                   int* __restrict__ lab0, int T, int L, int Dmax, int ps,
                   int use_thr, float thr) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* Pm = smem;
  stage_matrix(factor, smem, L, ps);
  float* qw = smem + (size_t)L * ps;           // (Dmax, L) q or M by slot
  float* csw = qw + Dmax * L;                  // (Dmax, L) CS[u + 1] by slot
  float* biasv = csw + Dmax * L;               // (Dmax, L)
  float* invd = biasv + Dmax * L;              // (Dmax)
  float* a = invd + Dmax;                      // (L) alpha[t] / raw delta[t]
  float* e = a + L;                            // (L) exp(a - m) / delta[t]
  float* tmx = e + L;                          // (L)

  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* fb = frame + (size_t)b * T * L;
  float* ob = out + (size_t)b * T * L;
  int* ab = VIT ? argd + (size_t)b * T * L : nullptr;

  stage_bias(bias_g, invd_g, biasv, invd, L, Dmax);
  for (int l = tid; l < L; l += nth) {
    a[l] = kNegInf;
    e[l] = kNegInf;
    tmx[l] = VIT ? 0.0f : tmax_g[l];
  }
  for (size_t i = (size_t)len * L + tid; i < (size_t)T * L; i += nth) {
    ob[i] = kNegInf;
    if (VIT) ab[i] = 0;
  }
  __syncthreads();

  const int g = tid % kGroup, l = tid / kGroup;
  const bool ok = l < L, mine = ok && g == 0;
  float cum = 0.0f;                            // CS[t + 1, l]
  int r = 0;                                   // t mod Dmax
  for (int t = 0; t < len; ++t) {
    if (ok) cum += fb[(size_t)t * L + l];
    const int dhi = min(t, Dmax - 1);
    float m[1];
    if (VIT) {
      float bv = -INFINITY;
      int bd = INT_MAX;
      if (ok)
        for (int d = g; d <= dhi; d += kGroup) {
          const float c = window_term<true>(qw, csw, biasv, invd, t, r, d, l,
                                            L, Dmax, cum);
          if (c > bv) {                        // ascending d: the shortest
            bv = c;
            bd = d;
          }
        }
      for (int o = 1; o < kGroup; o <<= 1)
        take_better(bv, bd, __shfl_xor_sync(0xffffffffu, bv, o),
                    __shfl_xor_sync(0xffffffffu, bd, o));
      if (mine) a[l] = bv;
      __syncthreads();
      row_max<1>(a, L, m);
      if (mine) {
        if (use_thr && !(bv >= __fsub_rn(m[0], thr))) bv = kNegInf;
        e[l] = bv;
        ob[(size_t)t * L + l] = bv;
        ab[(size_t)t * L + l] = bd;
      }
      __syncthreads();
      // M[t, l] = max_p delta[t, p] + trans[p, l]
      float mv = -INFINITY;
      if (ok)
        for (int p = g; p < L; p += kGroup)
          mv = fmaxf(mv, __fadd_rn(e[p], Pm[(size_t)p * ps + l]));
      mv = group_max(mv);
      if (mine) {
        qw[r * L + l] = mv;
        csw[r * L + l] = cum;
      }
    } else {
      float mx = kNegInf;
      if (ok)
        for (int d = g; d <= dhi; d += kGroup)
          mx = fmaxf(mx, window_term<false>(qw, csw, biasv, invd, t, r, d, l,
                                            L, Dmax, cum));
      mx = group_max(mx);
      float sum = 0.0f;
      if (ok)
        for (int d = g; d <= dhi; d += kGroup)
          sum += expf(window_term<false>(qw, csw, biasv, invd, t, r, d, l, L,
                                         Dmax, cum) - mx);
      sum = group_sum(sum);
      const float alpha = mx + logf(fmaxf(sum, kProdFloor));
      if (mine) {
        a[l] = alpha;
        ob[(size_t)t * L + l] = alpha;
      }
      __syncthreads();
      row_max<1>(a, L, m);
      if (mine) e[l] = expf(alpha - m[0]);
      __syncthreads();
      float acc[1];
      group_dot<1>(e, Pm, ps, L, ok ? l : 0, g, ok, acc);
      if (mine) {
        qw[r * L + l] = m[0] + tmx[l] + logf(fmaxf(acc[0], kProdFloor));
        csw[r * L + l] = cum;
      }
    }
    __syncthreads();
    r = r + 1 == Dmax ? 0 : r + 1;
  }

  // the last frame's row: logZ = lse(alpha), or the best score and the
  // lowest label that reaches it
  if (tid < 32) {
    if (VIT) {
      float v = -INFINITY;
      int i = INT_MAX;
      for (int k = tid; k < L; k += 32) take_better(v, i, e[k], k);
      for (int o = 16; o > 0; o >>= 1)
        take_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
                    __shfl_xor_sync(0xffffffffu, i, o));
      if (tid == 0) {
        zout[b] = len > 0 ? v : kNegInf;
        lab0[b] = len > 0 ? i : 0;
      }
    } else {
      float m[1];
      row_max<1>(a, L, m);
      float sum = 0.0f;
      for (int k = tid; k < L; k += 32) sum += expf(a[k] - m[0]);
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (tid == 0) zout[b] = m[0] + logf(fmaxf(sum, kProdFloor));
    }
  }
}

// K10.  The window holds beta[v] and R[v + 1] of the frames above, R[k] the
// sum of the frames k .. length - 1: CS[b] - CS[a] = R[a] - R[b].
__global__ void __launch_bounds__(kMaxThreads)
seg_backward_kernel(const float* __restrict__ frame,
                    const float* __restrict__ Ptg,
                    const float* __restrict__ tmaxr_g,
                    const float* __restrict__ bias_g,
                    const float* __restrict__ invd_g,
                    const int* __restrict__ lengths, float* __restrict__ betas,
                    int T, int L, int Dmax, int ps) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* Pm = smem;
  stage_matrix(Ptg, smem, L, ps);
  float* bw = smem + (size_t)L * ps;           // (Dmax, L) beta[v] by slot
  float* rw = bw + Dmax * L;                   // (Dmax, L) R[v + 1] by slot
  float* biasv = rw + Dmax * L;
  float* invd = biasv + Dmax * L;
  float* x = invd + Dmax;                      // (L) z[t]
  float* v = x + L;                            // (L) exp(z - zm)
  float* tmx = v + L;                          // (L)

  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* fb = frame + (size_t)b * T * L;
  float* ob = betas + (size_t)b * T * L;

  stage_bias(bias_g, invd_g, biasv, invd, L, Dmax);
  for (int l = tid; l < L; l += nth) tmx[l] = tmaxr_g[l];
  for (size_t i = (size_t)len * L + tid; i < (size_t)T * L; i += nth)
    ob[i] = kNegInf;
  __syncthreads();

  const int g = tid % kGroup, l = tid / kGroup;
  const bool ok = l < L, mine = ok && g == 0;
  float rnow = 0.0f;                           // R[t + 1, l]
  int r = len > 0 ? (len - 1) % Dmax : 0;      // t mod Dmax
  for (int t = len - 1; t >= 0; --t) {
    float beta = 0.0f;                         // beta[length - 1] = 0
    if (t < len - 1) {
      const int dhi = min(Dmax - 1, len - 2 - t);
      float mx = kNegInf, sum = 0.0f;
      for (int pass = 0; pass < 2; ++pass) {
        if (ok)
          for (int d = g; d <= dhi; d += kGroup) {
            int s = r + 1 + d;                 // the slot of frame t + d + 1
            if (s >= Dmax) s -= Dmax;
            const float w = ((rnow - rw[s * L + l]) * invd[d] +
                             biasv[d * L + l]) + bw[s * L + l];
            if (pass == 0)
              mx = fmaxf(mx, w);
            else
              sum += expf(w - mx);
          }
        if (pass == 0) mx = group_max(mx);
      }
      sum = group_sum(sum);
      const float z = mx + logf(fmaxf(sum, kProdFloor));
      if (mine) x[l] = z;
      __syncthreads();
      float zm[1];
      row_max<1>(x, L, zm);
      if (mine) v[l] = expf(z - zm[0]);
      __syncthreads();
      float acc[1];
      group_dot<1>(v, Pm, ps, L, ok ? l : 0, g, ok, acc);
      beta = zm[0] + tmx[l < L ? l : 0] + logf(fmaxf(acc[0], kProdFloor));
    }
    if (mine) {
      ob[(size_t)t * L + l] = beta;
      bw[r * L + l] = beta;
      rw[r * L + l] = rnow;
    }
    if (ok) rnow += fb[(size_t)t * L + l];
    __syncthreads();
    r = r == 0 ? Dmax - 1 : r - 1;
  }
}

// acc += u^T v on this thread's kTile x kTile tile (rows p0.., columns
// l0..) of an (L, L) partial: K11's gt gains exp(alpha[u] - m_u)^T F[u] when
// source frame u retires.
__device__ __forceinline__ void tile_outer(const float* u, const float* v,
                                           int p0, int l0, int L,
                                           float (&acc)[kTile][kTile]) {
  float uu[kTile], vv[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    uu[i] = p0 + i < L ? u[p0 + i] : 0.0f;
    vv[i] = l0 + i < L ? v[l0 + i] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = fmaf(uu[i], vv[j], acc[i][j]);
}

// K11.  A, S (B, T, L); gd_part (B, Dmax, L) and gt_part (B, L, L): this
// utterance's partials, summed over the batch by sum_partials_kernel.
__global__ void __launch_bounds__(kTileThreads)
seg_grad_kernel(const float* __restrict__ frame, const float* __restrict__ Pg,
                const float* __restrict__ tmax_g,
                const float* __restrict__ bias_g,
                const float* __restrict__ invd_g,
                const int* __restrict__ lengths,
                const float* __restrict__ alphas,
                const float* __restrict__ betas,
                const float* __restrict__ logZ, const float* __restrict__ gvec,
                float* __restrict__ A, float* __restrict__ S,
                float* __restrict__ gd_part, float* __restrict__ gt_part,
                int T, int L, int Dmax, int ps) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* Pm = smem;
  stage_matrix(Pg, smem, L, ps);
  const int W = Dmax * L;
  float* qw = smem + (size_t)L * ps;           // q[u] by slot
  float* csw = qw + W;                         // CS[u + 1]
  float* ew = csw + W;                         // exp(alpha[u] - m_u)
  float* Fw = ew + W;                          // F[u]
  float* Sw = Fw + W;                          // S[k] by slot k mod Dmax
  float* gdacc = Sw + W;                       // (Dmax, L) this utterance's gd
  float* biasv = gdacc + W;
  float* invd = biasv + W;                     // (Dmax)
  float* mw = invd + Dmax;                     // (Dmax) m_u by slot
  float* a = mw + Dmax;                        // (L) alpha[t]
  float* enew = a + L;                         // (L) exp(alpha[t] - m_t)
  float* tmx = enew + L;                       // (L)

  // this thread's register tile of gt: rows p0.., columns l0..
  const int nt = (L + kTile - 1) / kTile;
  const bool tiled = tid < nt * nt;
  const int p0 = (tid / nt) * kTile, l0 = (tid % nt) * kTile;
  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.0f;
  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const size_t off = (size_t)b * T * L;
  const float* fb = frame + off;
  const float* alb = alphas + off;
  const float* beb = betas + off;
  float* Ab = A + off;
  float* Sb = S + off;
  const float gb = gvec[b], lz = logZ[b];

  stage_bias(bias_g, invd_g, biasv, invd, L, Dmax);
  for (int i = tid; i < W; i += nth) {
    Fw[i] = 0.0f;
    Sw[i] = 0.0f;
    gdacc[i] = 0.0f;
  }
  for (int l = tid; l < L; l += nth) tmx[l] = tmax_g[l];
  for (size_t i = (size_t)len * L + tid; i < (size_t)T * L; i += nth) {
    Ab[i] = 0.0f;
    Sb[i] = 0.0f;
  }
  __syncthreads();

  const int g = tid % kGroup, l = tid / kGroup;
  const bool ok = l < L, mine = ok && g == 0;
  float cum = 0.0f;                            // CS[t + 1, l]
  int r = 0;                                   // t mod Dmax
  for (int t = 0; t < len; ++t) {
    float x0 = 0.0f, at = kNegInf;
    if (ok) {
      cum += fb[(size_t)t * L + l];
      x0 = beb[(size_t)t * L + l] - lz;
    }
    if (mine) at = alb[(size_t)t * L + l];
    const int dhi = min(t, Dmax - 1);
    float asum = 0.0f;
    if (ok)
      for (int d = g; d <= dhi; d += kGroup) {
        float q = 0.0f, cs = 0.0f;
        int s = -1;                            // d == t: no source frame
        if (d < t) {
          s = source_slot(r, d, Dmax);
          q = qw[s * L + l];
          cs = csw[s * L + l];
        }
        const float xv = ((cum - cs) * invd[d] + biasv[d * L + l]) + x0;
        const float xi = gb * expf(q + xv);
        const float y = invd[d] * xi;
        asum += y;
        const int ks = s + 1 == Dmax ? 0 : s + 1;   // start frame t - d
        Sw[ks * L + l] += y;
        gdacc[d * L + l] += xi;
        if (s >= 0) Fw[s * L + l] += gb * expf(xv + mw[s]);
      }
    asum = group_sum(asum);
    if (mine) {
      Ab[(size_t)t * L + l] = asum;
      a[l] = at;
    }
    __syncthreads();
    float m[1];
    row_max<1>(a, L, m);
    if (mine) enew[l] = expf(at - m[0]);
    // slot r holds source frame t - Dmax, complete now: retire it
    if (t >= Dmax && tiled)
      tile_outer(ew + r * L, Fw + r * L, p0, l0, L, acc);
    // start frame t - Dmax + 1 is complete too: emit it
    if (mine && t >= Dmax - 1) {
      const int ks = r + 1 == Dmax ? 0 : r + 1;
      Sb[(size_t)(t - Dmax + 1) * L + l] = Sw[ks * L + l];
      Sw[ks * L + l] = 0.0f;
    }
    __syncthreads();
    float dot[1];
    group_dot<1>(enew, Pm, ps, L, ok ? l : 0, g, ok, dot);
    if (mine) {
      qw[r * L + l] = m[0] + tmx[l] + logf(fmaxf(dot[0], kProdFloor));
      csw[r * L + l] = cum;
      ew[r * L + l] = enew[l];
      Fw[r * L + l] = 0.0f;
    }
    if (tid == 0) mw[r] = m[0];
    __syncthreads();
    r = r + 1 == Dmax ? 0 : r + 1;
  }

  // the last Dmax source frames never met their overwrite: retire them in
  // frame order, and emit the start frames still in the window
  for (int u = max(0, len - Dmax); u < len; ++u)
    if (tiled) {
      const int s = u % Dmax;
      tile_outer(ew + s * L, Fw + s * L, p0, l0, L, acc);
    }
  if (mine)
    for (int k = max(0, len - Dmax + 1); k < len; ++k)
      Sb[(size_t)k * L + l] = Sw[(k % Dmax) * L + l];
  for (int i = tid; i < W; i += nth) gd_part[(size_t)b * W + i] = gdacc[i];
  if (tiled) {
    float* part = gt_part + (size_t)b * L * L;
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        if (p0 + i < L && l0 + j < L)
          part[(size_t)(p0 + i) * L + l0 + j] = acc[i][j];
  }
}

// K13: one warp per utterance.  From (length - 1, lab0): the segment ending
// at t with label lab starts at t - arg_d[t, lab]; its predecessor is the
// lowest p that maximises deltas[start - 1, p] + trans[p, lab].
__global__ void __launch_bounds__(kTracebackThreads)
seg_traceback_kernel(const float* __restrict__ deltas,
                     const int* __restrict__ argd,
                     const float* __restrict__ trans,
                     const int* __restrict__ lab0,
                     const int* __restrict__ lengths,
                     int* __restrict__ end_lab, int* __restrict__ end_start,
                     int B, int T, int L) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  int* el = end_lab + (size_t)b * T;
  int* es = end_start + (size_t)b * T;
  for (int i = lane; i < T; i += 32) {
    el[i] = -1;
    es[i] = 0;
  }
  __syncwarp();
  const float* db = deltas + (size_t)b * T * L;
  const int* ab = argd + (size_t)b * T * L;
  int t = min(max(lengths[b], 0), T) - 1;
  int lab = min(max(lab0[b], 0), L - 1);
  while (t >= 0) {
    const int start = t - ab[(size_t)t * L + lab];
    if (lane == 0) {
      el[t] = lab;
      es[t] = start;
    }
    if (start <= 0) break;
    const float* row = db + (size_t)(start - 1) * L;
    float v = -INFINITY;
    int i = INT_MAX;
    for (int p = lane; p < L; p += 32)
      take_better(v, i, __fadd_rn(row[p], trans[(size_t)p * L + lab]), p);
    for (int o = 16; o > 0; o >>= 1)
      take_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
                  __shfl_xor_sync(0xffffffffu, i, o));
    lab = i;
    t = start - 1;
  }
}

}  // namespace

extern "C" {

// A kernel's dynamic shared memory at (L, Dmax) in bytes, for the wrapper's
// check and the tests; 0: the kernel does not take them.  kind: 0 K9, 1 K12,
// 2 K10, 3 K11.
size_t seg_smem_bytes(int kind, int L, int Dmax) {
  const Plan p = make_plan(kind, L, Dmax);
  return p.ok ? p.bytes : 0;
}

// K9: alphas (B, T, L), logZ (B,).
int seg_forward(const float* frame, const float* P, const float* tmax,
                const float* bias, const float* invd, const int* lengths,
                float* alphas, float* logZ, int B, int T, int L, int Dmax,
                void* stream) {
  const Plan p = make_plan(kForward, L, Dmax);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = seg_forward_kernel<false>;
  cudaError_t err = opt_in(kernel, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads_for(L), p.bytes, static_cast<cudaStream_t>(stream)>>>(
      frame, P, tmax, bias, invd, lengths, alphas, nullptr, logZ, nullptr, T,
      L, Dmax, p.ps, 0, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

// K12: deltas, arg_d (B, T, L), scores, lab0 (B,).
int seg_viterbi(const float* frame, const float* trans, const float* bias,
                const float* invd, const int* lengths, float* deltas,
                int* argd, float* scores, int* lab0, int B, int T, int L,
                int Dmax, int use_thr, float thr, void* stream) {
  const Plan p = make_plan(kViterbi, L, Dmax);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = seg_forward_kernel<true>;
  cudaError_t err = opt_in(kernel, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads_for(L), p.bytes, static_cast<cudaStream_t>(stream)>>>(
      frame, trans, nullptr, bias, invd, lengths, deltas, argd, scores, lab0,
      T, L, Dmax, p.ps, use_thr, thr);
  return static_cast<int>(cudaGetLastError());
}

// K10: betas (B, T, L).
int seg_backward(const float* frame, const float* Pt, const float* tmax_r,
                 const float* bias, const float* invd, const int* lengths,
                 float* betas, int B, int T, int L, int Dmax, void* stream) {
  const Plan p = make_plan(kBackward, L, Dmax);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(seg_backward_kernel, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_backward_kernel<<<B, threads_for(L), p.bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      frame, Pt, tmax_r, bias, invd, lengths, betas, T, L, Dmax, p.ps);
  return static_cast<int>(cudaGetLastError());
}

// K11: A, S (B, T, L), the partials gd_part (B, Dmax, L) and gt_part
// (B, L, L), then gd (Dmax, L) and gt (L, L) = their sums in batch order.
int seg_grad(const float* frame, const float* P, const float* tmax,
             const float* bias, const float* invd, const int* lengths,
             const float* alphas, const float* betas, const float* logZ,
             const float* g, float* A, float* S, float* gd_part,
             float* gt_part, float* gd, float* gt, int B, int T, int L,
             int Dmax, void* stream) {
  const Plan p = make_plan(kGrad, L, Dmax);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(seg_grad_kernel, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  seg_grad_kernel<<<B, threads_for(L), p.bytes, s>>>(
      frame, P, tmax, bias, invd, lengths, alphas, betas, logZ, g, A, S,
      gd_part, gt_part, T, L, Dmax, p.ps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int n = Dmax * L;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(gd_part, gd, B, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  n = L * L;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(gt_part, gt, B, n);
  return static_cast<int>(cudaGetLastError());
}

// K13: end_lab (B, T) (-1 where no segment ends), end_start (B, T).
int seg_traceback(const float* deltas, const int* argd, const float* trans,
                  const int* lab0, const int* lengths, int* end_lab,
                  int* end_start, int B, int T, int L, void* stream) {
  const int per_block = kTracebackThreads / 32;
  seg_traceback_kernel<<<(B + per_block - 1) / per_block, kTracebackThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(
      deltas, argd, trans, lab0, lengths, end_lab, end_start, B, T, L);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
