// Log-semiring forward-backward over a SHARED transition matrix, for Hopper
// (sm_90a): the recursions.  Plain C interface, loaded with ctypes by
// asr_craft_tpu_torch/kernels/fwdbwd.py, which holds the plain PyTorch
// version of every kernel here.
//
// Replaces five TPU kernels with two templated recursions:
//   fb_forward_kernel<1>         <- _fwd_kernel (K6a, fwdbwd_pallas.py
//                                   forward_pallas): alpha and logZ
//   fb_forward_kernel<2>         <- _dual_fwd_kernel (K4, dual_pallas.py
//                                   forward_dual_pallas): free and
//                                   label-clamped alpha, the clamp penalty
//                                   formed from the frame labels
//   fb_backward_kernel<1, false> <- _bwd_kernel (K6b, backward_pallas): beta
//   fb_backward_kernel<2, false> <- _dual_bwd_kernel (K14,
//                                   backward_dual_pallas): free and clamped
//                                   beta
//   fb_backward_kernel<2, true>  <- _dual_bwd_grad_kernel (K5,
//                                   backward_dual_grad_pallas), its beta
//                                   recursion: betas are never stored; it
//                                   writes g_state and the rows U_t, V_t
//                                   of the transition gradient, whose
//                                   product UV = sum_t U_t^T V_t
//                                   (dual_pallas.py:226) is fwdbwd_mma.cu's
//                                   fb_contract_kernel on the tensor cores.
//
// Layouts (batch-major, as models.crf.potentials returns them).  state
// (B, T, L) f32 with the boundary masks folded in; the factor F (L, L)
// destination-major: row l holds what reaches destination l, F[l, p] =
// exp(trans[p, l] - tmax[l]) forward (tmax the column maxima clamped at
// NEG_INF) and exp(trans[l, p] - tmax_r[l]) backward (tmax_r the row maxima),
// both formed by the wrapper; labels (B, T) i32; lengths (B,) i32.  Outputs:
// alphas / betas / g_state (B, T, L) f32 per lattice, logZ (B,), and for K5
// U, V (B, T, 2, ld) with ld >= L (columns past L are not written).
//
// The step is the reference's rescaled-exp product.  Forward:
//   m = max(max_p alpha[p], NEG_INF)
//   alpha'[l] = m + tmax[l] + log(max(sum_p exp(alpha[p] - m) F[l, p],
//               1e-38)) + state2[t, l]
// backward, with x = beta + state2[t + 1]:
//   beta'[l] = m + tmax_r[l] + log(max(sum_p exp(x[p] - m) F[l, p], 1e-38))
// where state2 is state for the free lattice and state + (l / clamp_ns ==
// label ? 0 : NEG_INF) for the clamped one.  Frame 0 sets alpha to state2
// whatever the length; frames t >= length keep alpha; beta is 0 at
// t + 1 >= length.  K5 writes, per frame t with t + 1 < length and lattice
// i, V_t = exp(x - m) and
//   U_t[p] = exp(alpha[t, p] + m - z) * w,
// (rows with t + 1 >= length are 0), and g_state[t, l] = sum over lattices
// of exp(alpha[t, l] + beta[t, l] - z) * w for t < length, 0 past it.  The
// reference forms U_t as exp(alpha - mU) * exp(mU + m - z) * w with mU the
// row maximum of alpha[t]: one exponent here is the sum of its two, so U_t
// is finite wherever the reference's is and 0 wherever its scale is (and no
// second row maximum sits on the frame chain).  NEG_INF is finite (-1e30)
// and every max is clamped at it, so a lattice no state admits yields
// exp(-huge) = 0, not NaN: its alphas lie at or below NEG_INF while m and z
// are clamped there, so its U, V products and g_state are exactly 0.  All
// arithmetic is IEEE fp32.
//
// What bounds them on this card.  One block owns one utterance and walks its
// frames in order; at the configs' widths (L = 48, 42; L' = 138) a frame is
// 2 L^2 multiply-adds per lattice, far too little to fill an SM, so the time
// is the frame chain: a row max, an exp pass, the product, the log and two
// block barriers, 511 times.  What a first, simpler design paid on it,
// and what this one does instead:
// - loads from device memory on the chain.  The lane that finishes a
//   (destination, lattice) pair loads frame t's state entry and label into
//   registers one frame ahead, and K5's alpha[t, l] with cp.async into a
//   two-frame ring in shared memory, waiting for its own copy where it uses
//   it (measured on the card: 6-23% faster than a register load for alpha,
//   no faster for the state entry);
// - shared-memory traffic in the product.  A group of kGroup = 4 lanes owns
//   D destinations and splits the predecessors into contiguous quarters of
//   4 QV (fdt_common.cuh quarter_dot): a lane reads the lattices'
//   exponentials as QV float4 chunks, each once for all D destinations, and
//   holds its quarters of the D factor rows for the whole walk, in
//   registers where they fit (QV = 3, 5, 9 with D = 2: L <= 48, 80, 144)
//   or in shared memory (QV = 15, D = 4: L <= 232), which the wrapper picks
//   as template parameters: no branch in the frame loop.  Every warp still
//   reads every exponential, so the block's reads of them fall as 1 / D: at
//   L' = 138 ~650 wavefronts a frame, against ~1,900 scalar loads of the
//   factor and both lattices before; and the block is 3 to 9 warps, so its
//   barriers and its redundant row maxima cost less.  D = 2 measured best
//   on the card at L' = 138 (K4 19% and K5's recursion 24% faster than D =
//   4, whose five warps queue their multiply-adds on one scheduler in
//   two; D = 1 was no faster than D = 4) and as fast as D = 1 at L = 48;
// - the group's D NLAT sums are reduced and scattered by shuffles, each
//   finished (its log, its outputs) by one lane;
// - the row max, taken redundantly by every warp with no barrier, is one
//   redux.sync a lattice on order-keeping integer keys (fdt_common.cuh
//   row_max_redux): five rounds of shuffles a lattice were the largest
//   single cost of a frame (a knockout test on the card: ~40% at L = 48);
// - K5's outer products.  It writes its rows and leaves their product to the
//   tensor cores: no register tile, no second row max or exp pass on the
//   frame chain.
// Widths: L <= 232 (the shared layout's factor and vectors fit a block's
// shared memory); the wrapper raises beyond.  Not done yet: several
// utterances per block at small L, and the clamped lattice's sparsity (ns
// live states a frame).

#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>
#include <type_traits>

#include "fdt_common.cuh"

namespace {

using fdtk::FactorRows;
using fdtk::kGroup;
using fdtk::kNegInf;
using fdtk::kProdFloor;
using fdtk::kSmemLimit;
using fdtk::opt_in;
using fdtk::quarter_dot;
using fdtk::row_max_redux;
using fdtk::stage_rows_padded;

// The layouts a launch may take (kernels/fwdbwd.factor_layout picks one by
// L): QV float4 chunks of each of a group's D factor rows a lane, in
// registers or, for the widest lattices, in shared memory.
constexpr int kSharedQV = 15;             // L <= 240
constexpr int kFbThreads = 320;           // every layout's block, at most

// kGroup lanes for every D destinations, in whole warps; at least two
// warps (logZ takes one warp per lattice)
int fb_threads(int L, int D) {
  const int n = (kGroup * ((L + D - 1) / D) + 31) / 32 * 32;
  return n < 64 ? 64 : n;
}

bool layout_ok(int L, int qv, int D, int shared) {
  const bool known = shared ? qv == kSharedQV && D == 4
                            : (qv == 3 || qv == 5 || qv == 9) && D == 2;
  return L >= 1 && known && 16 * qv >= L && fb_threads(L, D) <= kFbThreads;
}

// The (dest, lattice) pairs a lane finishes: D NLAT over kGroup lanes
__host__ __device__ constexpr int owned(int D, int nlat) {
  return (D * nlat + kGroup - 1) / kGroup;
}

// A launch's dynamic shared memory, 0: not taken.  [the factor (L, Lq) if
// shared][the exponentials (nlat, Lq)][the carry (nlat, L)][K5: the ring of
// alpha entries (2 frames, owned pairs, threads)]
size_t smem_bytes(int L, int nlat, int qv, int D, int shared, int grad) {
  if (!layout_ok(L, qv, D, shared) || (nlat != 1 && nlat != 2)) return 0;
  const size_t Lq = 16 * (size_t)qv;
  const size_t ring = grad ? 2 * (size_t)owned(D, nlat) * fb_threads(L, D) : 0;
  const size_t bytes = sizeof(float) * ((shared ? (size_t)L * Lq : 0) +
                                        (size_t)nlat * (Lq + L) + ring);
  return bytes <= kSmemLimit ? bytes : 0;
}

__device__ __forceinline__ float clamp_penalty(int l, int label,
                                               int clamp_ns) {
  return l / clamp_ns == label ? 0.0f : kNegInf;
}

// The lane roles every kernel here shares.  Group `slot` (kGroup lanes)
// owns destinations l[d] = slot + d nslots; its lane g finishes the pairs q
// = g + kGroup j (pair q: destination q / NLAT, lattice q % NLAT).
template <int NLAT, int D>
struct Roles {
  static constexpr int OWN = owned(D, NLAT);
  int g, l[D];
  int ol[OWN], oi[OWN];          // the finished pairs' destination, lattice
  bool own[OWN];
  __device__ Roles(int L) {
    const int slot = threadIdx.x / kGroup, nslots = blockDim.x / kGroup;
    g = threadIdx.x % kGroup;
#pragma unroll
    for (int d = 0; d < D; ++d) l[d] = slot + d * nslots;
#pragma unroll
    for (int j = 0; j < OWN; ++j) {
      const int q = g + kGroup * j;
      ol[j] = slot + (q / NLAT) * nslots;
      oi[j] = q % NLAT;
      own[j] = q < D * NLAT && ol[j] < L;
    }
  }
};

template <int NLAT>
__device__ __forceinline__ float pick(const float (&v)[NLAT], int i) {
  return i == 0 ? v[0] : v[NLAT - 1];
}

// What an owned pair reads of frame t, loaded a frame before its use
struct Row {
  float s = 0.0f, a = 0.0f;   // the state entry, alpha (K5)
  int lab = 0;
};

template <int NLAT, int QV, int D, bool SHARED>
__global__ void __launch_bounds__(kFbThreads)
fb_forward_kernel(const float* __restrict__ state,
                  const float* __restrict__ Fg,
                  const float* __restrict__ tmax_g,
                  const int* __restrict__ labels,
                  const int* __restrict__ lengths, float* __restrict__ a0,
                  float* __restrict__ a1, float* __restrict__ z0,
                  float* __restrict__ z1, int T, int L, int clamp_ns) {
  constexpr int Lq = 16 * QV;
  using R = Roles<NLAT, D>;
  extern __shared__ float4 smem4[];
  float* Fs = reinterpret_cast<float*>(smem4);       // SHARED: (L, Lq)
  float* e = Fs + (SHARED ? (size_t)L * Lq : 0);     // (NLAT, Lq) exp
  float* alpha = e + NLAT * Lq;                      // (NLAT, L) carry
  const int tid = threadIdx.x, nth = blockDim.x;
  const R r(L);
  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* sb = state + (size_t)b * T * L;
  const int* lb = NLAT == 2 ? labels + (size_t)b * T : labels;
  float* out0 = a0 + (size_t)b * T * L;
  float* out1 = a1 + (size_t)b * T * L;
  auto out = [&](int i) { return i == 0 ? out0 : out1; };

  if constexpr (SHARED) stage_rows_padded(Fg, Fs, L, Lq);
  FactorRows<D, QV, SHARED> f;
  f.load(Fg, Fs, L, r.l, r.g);
  for (int j = tid; j < NLAT * Lq; j += nth) e[j] = 0.0f;   // pads stay 0
  float tm[R::OWN];
  // frame t's state entry and label, for the pairs this lane finishes
  auto fetch = [&](int t, Row (&rw)[R::OWN]) {
#pragma unroll
    for (int j = 0; j < R::OWN; ++j)
      if (t < len && r.own[j]) {
        rw[j].s = sb[(size_t)t * L + r.ol[j]];
        if (NLAT == 2) rw[j].lab = lb[t];
      }
  };
  // frame 0: alpha = state2, whatever the length
#pragma unroll
  for (int j = 0; j < R::OWN; ++j) {
    tm[j] = r.own[j] ? tmax_g[r.ol[j]] : 0.0f;
    if (r.own[j]) {
      float s = sb[r.ol[j]];
      if (NLAT == 2 && r.oi[j] == 1)
        s += clamp_penalty(r.ol[j], lb[0], clamp_ns);
      alpha[r.oi[j] * L + r.ol[j]] = s;
      out(r.oi[j])[r.ol[j]] = s;
    }
  }
  Row cur[R::OWN];
  fetch(1, cur);
  __syncthreads();

  for (int t = 1; t < len; ++t) {
    Row nxt[R::OWN];
    fetch(t + 1, nxt);                    // a frame ahead of its use
    float m[NLAT];
    row_max_redux<NLAT, (QV + 1) / 2>(alpha, L, m);
    for (int j = tid; j < NLAT * L; j += nth) {
      const int i = NLAT == 2 && j >= L ? 1 : 0;
      e[i * Lq + j - i * L] = expf(alpha[j] - pick(m, i));
    }
    __syncthreads();
    float acc[R::OWN];
    quarter_dot<NLAT, D, QV, SHARED>(e, f, r.g, acc);
#pragma unroll
    for (int j = 0; j < R::OWN; ++j) {
      if (!r.own[j]) continue;
      const int i = r.oi[j], l = r.ol[j];
      float st = cur[j].s;
      if (NLAT == 2 && i == 1) st += clamp_penalty(l, cur[j].lab, clamp_ns);
      const float v = pick(m, i) + tm[j] +
                      logf(fmaxf(acc[j], kProdFloor)) + st;
      alpha[i * L + l] = v;
      out(i)[(size_t)t * L + l] = v;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R::OWN; ++j) cur[j] = nxt[j];
  }

  // frames past the length keep the carry
  for (size_t i = (size_t)max(len, 1) * L + tid; i < (size_t)T * L; i += nth) {
    const int l = (int)(i % L);
    out0[i] = alpha[l];
    if (NLAT == 2) out1[i] = alpha[L + l];
  }

  // logZ = lse(carry): warp i sums lattice i
  float m[NLAT];
  row_max_redux<NLAT, (QV + 1) / 2>(alpha, L, m);
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < NLAT) {
    const float mi = warp == 0 ? m[0] : m[NLAT - 1];
    float sum = 0.0f;
    for (int l = lane; l < L; l += 32) sum += expf(alpha[warp * L + l] - mi);
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0)
      (warp == 0 ? z0 : z1)[b] = mi + logf(fmaxf(sum, kProdFloor));
  }
}

// GRAD false: o0, o1 = betas of the free / clamped lattice (B, T, L).
// GRAD true (NLAT 2): o0 = g_state (B, T, L); U, V the (B, T, 2, ld) rows
// of the transition gradient.
template <int NLAT, bool GRAD, int QV, int D, bool SHARED>
__global__ void __launch_bounds__(kFbThreads)
fb_backward_kernel(const float* __restrict__ state,
                   const float* __restrict__ Fg,
                   const float* __restrict__ tmaxr_g,
                   const int* __restrict__ labels,
                   const int* __restrict__ lengths,
                   const float* __restrict__ af, const float* __restrict__ ac,
                   const float* __restrict__ zf, const float* __restrict__ zc,
                   const float* __restrict__ wf, const float* __restrict__ wc,
                   float* __restrict__ o0, float* __restrict__ o1,
                   float* __restrict__ U, float* __restrict__ V, int T,
                   int L, int clamp_ns, int ld) {
  constexpr int Lq = 16 * QV;
  using R = Roles<NLAT, D>;
  extern __shared__ float4 smem4[];
  float* Fs = reinterpret_cast<float*>(smem4);       // SHARED: (L, Lq)
  float* v = Fs + (SHARED ? (size_t)L * Lq : 0);     // (NLAT, Lq) exp(x - m)
  float* x = v + NLAT * Lq;                          // (NLAT, L) beta + s2
  const int tid = threadIdx.x, nth = blockDim.x;
  const R r(L);
  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* sb = state + (size_t)b * T * L;
  const int* lb = NLAT == 2 ? labels + (size_t)b * T : labels;
  const float* abf = GRAD ? af + (size_t)b * T * L : nullptr;
  const float* abc = GRAD ? ac + (size_t)b * T * L : nullptr;
  auto ab = [&](int i) { return i == 0 ? abf : abc; };
  float* out0 = o0 + (size_t)b * T * L;
  float* out1 = NLAT == 2 && !GRAD ? o1 + (size_t)b * T * L : nullptr;
  auto out = [&](int i) { return i == 0 ? out0 : out1; };
  // row (t, lattice i) of U and V
  auto row = [&](int t, int i) {
    return ((size_t)b * T + t) * 2 * ld + (size_t)i * ld;
  };

  if constexpr (SHARED) stage_rows_padded(Fg, Fs, L, Lq);
  FactorRows<D, QV, SHARED> f;
  f.load(Fg, Fs, L, r.l, r.g);
  for (int j = tid; j < NLAT * Lq; j += nth) v[j] = 0.0f;   // pads stay 0
  float tm[R::OWN], z[R::OWN], w[R::OWN];
#pragma unroll
  for (int j = 0; j < R::OWN; ++j) {
    tm[j] = r.own[j] ? tmaxr_g[r.ol[j]] : 0.0f;
    z[j] = GRAD ? (r.oi[j] == 0 ? zf[b] : zc[b]) : 0.0f;
    w[j] = GRAD ? (r.oi[j] == 0 ? wf[b] : wc[b]) : 0.0f;
  }
  // beta is 0 from frame length - 1 on; g_state is 0 from frame length on,
  // U and V from frame length - 1 on
  {
    const int zero_from = GRAD ? len : max(len - 1, 0);
    for (size_t i = (size_t)zero_from * L + tid; i < (size_t)T * L;
         i += nth) {
      out0[i] = 0.0f;
      if (NLAT == 2 && !GRAD) out1[i] = 0.0f;
    }
    if (GRAD) {
      const int r0 = 2 * max(len - 1, 0);
      for (int i = tid; i < (2 * T - r0) * L; i += nth) {
        const int q = i / L, c = i - q * L;
        const size_t o = ((size_t)b * T * 2 + r0 + q) * ld + c;
        U[o] = 0.0f;
        V[o] = 0.0f;
      }
    }
  }
  // frame t's state entry, label and alpha, for the pairs this lane
  // finishes
  float* aring = x + NLAT * L;       // GRAD: (2, OWN, nth) alpha entries
  auto aslot = [&](int t, int j) {
    return aring + ((t & 1) * R::OWN + j) * nth + tid;
  };
  auto fetch = [&](int t, Row (&rw)[R::OWN]) {
#pragma unroll
    for (int j = 0; j < R::OWN; ++j) {
      const bool go = t >= 0 && r.own[j];
      const size_t at = go ? (size_t)t * L + r.ol[j] : 0;
      if (go) {
        rw[j].s = sb[at];
        if (NLAT == 2) rw[j].lab = lb[t];
      }
      if (GRAD)
        fdtk::cp_async4(aslot(t, j), ab(r.oi[j]) + at, go ? 4 : 0);
    }
    if (GRAD) fdtk::cp_async_commit();
  };
  // frame length - 1: beta = 0, so x = state2; g_state there
  float gi[R::OWN];
#pragma unroll
  for (int j = 0; j < R::OWN; ++j) {
    gi[j] = 0.0f;
    if (r.own[j] && len >= 1) {
      const size_t at = (size_t)(len - 1) * L + r.ol[j];
      float s = sb[at];
      if (NLAT == 2 && r.oi[j] == 1)
        s += clamp_penalty(r.ol[j], lb[len - 1], clamp_ns);
      x[r.oi[j] * L + r.ol[j]] = 0.0f + s;
      if (GRAD) gi[j] = expf(ab(r.oi[j])[at] + 0.0f - z[j]) * w[j];
    }
  }
  if (GRAD) {
#pragma unroll
    for (int j = 0; j < R::OWN; ++j) {
      gi[j] += __shfl_down_sync(0xffffffffu, gi[j], 1);
      if (r.own[j] && r.oi[j] == 0 && len >= 1)
        out0[(size_t)(len - 1) * L + r.ol[j]] = gi[j];
    }
  }
  Row cur[R::OWN];
  fetch(len - 2, cur);
  __syncthreads();

  for (int t = len - 2; t >= 0; --t) {
    Row nxt[R::OWN];
    fetch(t - 1, nxt);                    // a frame ahead of its use
    float m[NLAT];
    row_max_redux<NLAT, (QV + 1) / 2>(x, L, m);
    for (int j = tid; j < NLAT * L; j += nth) {
      const int i = NLAT == 2 && j >= L ? 1 : 0;
      const float ev = expf(x[j] - pick(m, i));
      v[i * Lq + j - i * L] = ev;
      if (GRAD) V[row(t, i) + j - i * L] = ev;
    }
    __syncthreads();
    float acc[R::OWN];
    quarter_dot<NLAT, D, QV, SHARED>(v, f, r.g, acc);
    if (GRAD) {
      fdtk::cp_async_wait<1>();           // frame t's alpha entries
#pragma unroll
      for (int j = 0; j < R::OWN; ++j) cur[j].a = *aslot(t, j);
    }
#pragma unroll
    for (int j = 0; j < R::OWN; ++j) {
      gi[j] = 0.0f;
      if (!r.own[j]) continue;
      const int i = r.oi[j], l = r.ol[j];
      const float mi = pick(m, i);
      const float nb = mi + tm[j] + logf(fmaxf(acc[j], kProdFloor));
      if (GRAD) {
        gi[j] = expf(cur[j].a + nb - z[j]) * w[j];
        U[row(t, i) + l] = expf(cur[j].a + mi - z[j]) * w[j];
      } else {
        out(i)[(size_t)t * L + l] = nb;
      }
      if (t > 0) {
        float st = cur[j].s;
        if (NLAT == 2 && i == 1)
          st += clamp_penalty(l, cur[j].lab, clamp_ns);
        x[i * L + l] = nb + st;
      }
    }
    if (GRAD) {
      // + the clamped lattice's term, held by the next lane
#pragma unroll
      for (int j = 0; j < R::OWN; ++j) {
        gi[j] += __shfl_down_sync(0xffffffffu, gi[j], 1);
        if (r.own[j] && r.oi[j] == 0) out0[(size_t)t * L + r.ol[j]] = gi[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R::OWN; ++j) cur[j] = nxt[j];
  }
  if (GRAD) fdtk::cp_async_wait<0>();
}

// Calls fn(nlat, QV, D, SHARED) as compile-time constants for the layout
// the wrapper picked; cudaErrorInvalidValue for one that is not built.
template <class Fn>
int by_layout(int nlat, int qv, int shared, Fn&& fn) {
  using std::integral_constant;
  using I = int;
  auto pick_layout = [&](auto n) -> int {
    if (shared)
      return fn(n, integral_constant<I, kSharedQV>{},
                integral_constant<I, 4>{}, std::true_type{});
    switch (qv) {
      case 3: return fn(n, integral_constant<I, 3>{},
                        integral_constant<I, 2>{}, std::false_type{});
      case 5: return fn(n, integral_constant<I, 5>{},
                        integral_constant<I, 2>{}, std::false_type{});
      case 9: return fn(n, integral_constant<I, 9>{},
                        integral_constant<I, 2>{}, std::false_type{});
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  return nlat == 2 ? pick_layout(integral_constant<I, 2>{})
                   : pick_layout(integral_constant<I, 1>{});
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int B, int threads, size_t bytes, void* stream,
           Args... args) {
  const cudaError_t err = opt_in(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// A recursion's dynamic shared memory at width L in bytes, for the
// wrapper's check and the tests; 0: no kernel takes this (L, layout).  qv,
// D, shared: the factor's layout (kernels/fwdbwd.factor_layout).
size_t fwdbwd_smem_bytes(int L, int nlat, int qv, int D, int shared,
                         int grad) {
  return smem_bytes(L, nlat, qv, D, shared, grad);
}

int fwdbwd_forward(const float* state, const float* F, const float* tmax,
                   const int* labels, const int* lengths, float* a0,
                   float* a1, float* z0, float* z1, int B, int T, int L,
                   int nlat, int clamp_ns, int qv, int D, int shared,
                   void* stream) {
  const size_t bytes = smem_bytes(L, nlat, qv, D, shared, 0);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_layout(nlat, qv, shared, [&](auto n, auto q, auto d, auto sh) {
    return launch(fb_forward_kernel<decltype(n)::value, decltype(q)::value,
                                    decltype(d)::value, decltype(sh)::value>,
                  B, fb_threads(L, D), bytes, stream, state, F, tmax, labels,
                  lengths, a0, a1, z0, z1, T, L, clamp_ns);
  });
}

int fwdbwd_backward(const float* state, const float* F, const float* tmax_r,
                    const int* labels, const int* lengths, float* b0,
                    float* b1, int B, int T, int L, int nlat, int clamp_ns,
                    int qv, int D, int shared, void* stream) {
  const size_t bytes = smem_bytes(L, nlat, qv, D, shared, 0);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_layout(nlat, qv, shared, [&](auto n, auto q, auto d, auto sh) {
    return launch(fb_backward_kernel<decltype(n)::value, false,
                                     decltype(q)::value, decltype(d)::value,
                                     decltype(sh)::value>,
                  B, fb_threads(L, D), bytes, stream, state, F, tmax_r,
                  labels, lengths, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, b0, b1, nullptr, nullptr, T, L, clamp_ns,
                  0);
  });
}

// K5's recursion: g_state (B, T, L) and the rows U, V (B, T, 2, ld).
int fwdbwd_backward_grad(const float* state, const float* F,
                         const float* tmax_r, const int* labels,
                         const int* lengths, const float* af, const float* ac,
                         const float* zf, const float* zc, const float* wf,
                         const float* wc, float* g_state, float* U, float* V,
                         int B, int T, int L, int ld, int clamp_ns, int qv,
                         int D, int shared, void* stream) {
  const size_t bytes = smem_bytes(L, 2, qv, D, shared, 1);
  if (bytes == 0 || ld < L) return static_cast<int>(cudaErrorInvalidValue);
  return by_layout(2, qv, shared, [&](auto, auto q, auto d, auto sh) {
    return launch(fb_backward_kernel<2, true, decltype(q)::value,
                                     decltype(d)::value, decltype(sh)::value>,
                  B, fb_threads(L, D), bytes, stream, state, F, tmax_r,
                  labels, lengths, af, ac, zf, zc, wf, wc, g_state, nullptr,
                  U, V, T, L, clamp_ns, ld);
  });
}

}  // extern "C"
