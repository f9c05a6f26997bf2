// Log-semiring forward-backward over a SHARED transition matrix, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
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
//                                   backward_dual_grad_pallas): the beta
//                                   recursion fused with the classical
//                                   gradient; betas are never stored
// and sum_partials_kernel (fdt_common.cuh), which finishes K5's transition
// gradient.
//
// Layouts (batch-major, as models.crf.potentials returns them).  state
// (B, T, L) f32 with the boundary masks folded in; P (L, L) = exp(trans -
// tmax[None, :]) with tmax (L,) the column maxima clamped at NEG_INF, or for
// the backward Pt (L, L) = exp(trans^T - tmax_r[None, :]) with tmax_r the row
// maxima (both formed by the wrapper); labels (B, T) i32; lengths (B,) i32.
// Outputs: alphas / betas / g_state (B, T, L) f32 per lattice, logZ (B,),
// UV (L, L) with g_trans = sign(UV) * exp(trans + log|UV|) left to the
// wrapper, as in the reference.
//
// The step is the reference's rescaled-exp product.  Forward:
//   m = max(max_p alpha[p], NEG_INF)
//   alpha'[l] = m + tmax[l] + log(max(sum_p exp(alpha[p] - m) P[p, l],
//               1e-38)) + state2[t, l]
// backward, with x = beta + state2[t + 1]:
//   beta'[l] = m + tmax_r[l] + log(max(sum_p exp(x[p] - m) Pt[p, l], 1e-38))
// where state2 is state for the free lattice and state + (l / clamp_ns ==
// label ? 0 : NEG_INF) for the clamped one.  Frame 0 sets alpha to state2
// whatever the length; frames t >= length keep alpha; beta is 0 at
// t + 1 >= length.  K5 adds, per frame t with t + 1 < length,
//   U[p] = exp(alpha[t, p] - mU) * exp(mU + m - z) * w,  V = exp(x - m)
//   UV += U^T V  (both lattices),
// and g_state[t, l] = sum over lattices of exp(alpha[t, l] + beta[t, l] -
// z) * w for t < length, 0 past it.  NEG_INF is finite (-1e30) and every max
// is clamped at it, so a lattice no state admits yields exp(-huge) = 0, not
// NaN.  All arithmetic is IEEE fp32.
//
// What bounds them on this card.  One block owns one utterance and walks its
// frames in order; at the configs' widths (L = 48, 42; L' = 138) a frame is
// 2 L^2 multiply-adds per lattice, far too little to fill an SM, so the time
// is the latency of the frame chain: a row max, an exp pass, the product and
// two or three block barriers, 511 times.  Against that:
// - both lattices ride one pass over P (each P[p, l] is read once for two
//   rows), which sits in shared memory with its row stride padded to 8 mod
//   32 so the kGroup lanes of a destination hit different banks (opted into
//   above 48 KB);
// - each destination's sum over predecessors is split over kGroup lanes of
//   a warp and merged with shuffles; the forward loads the frame's state
//   row before the product;
// - the row max is taken redundantly by every warp (shuffles, no barrier).
// K5's UV cannot be one carried accumulator: blocks run in parallel and
// atomics would make gradients differ from run to run.  Each block sums its
// own utterance's U^T V over its frames in a fixed order, and
// sum_partials_kernel adds the B partials in batch order: the same bits
// on every run.  Each thread keeps a kTile x kTile tile of the partial in
// registers: a frame costs it 4 kTile shared-memory loads of U and V, not a
// read-modify-write per element.
// Widths.  The factor and the working vectors must fit a block's shared
// memory, which holds for L <= 232; K5's tiles must cover (L, L) with the
// block's threads, which holds for L <= 144.  The configs train at L = 42,
// 48 and 138.  The wrapper raises beyond.
// Not done yet: several utterances per block at small L, and the xi product
// on tensor cores.

#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::kNegInf;

using fdtk::kGroup;
using fdtk::kMaxThreads;
using fdtk::kProdFloor;
using fdtk::kSmemLimit;
using fdtk::kTile;
using fdtk::kTileThreads;
using fdtk::group_dot;
using fdtk::opt_in;
using fdtk::padded_stride;
using fdtk::row_max;
using fdtk::stage_matrix;
using fdtk::threads_for;

// K5's register tiles cover the (L, L) partial when the block has
// ceil(L / kTile)^2 threads and is small enough for their registers.
bool tile_fits(int L) {
  const int nt = (L + kTile - 1) / kTile;
  return nt * nt <= threads_for(L) && threads_for(L) <= kTileThreads;
}

// A launch's shared memory.  ps: the row stride of the transition factor;
// bytes: the factor and the working vectors; ok false: the kernel does not
// take this L.
struct Plan {
  int ps;
  size_t bytes;
  bool ok;
};

// vectors: forward alpha, e; backward beta, x, v (+ a2, u with grad); tmax
size_t vector_floats(int L, int nlat, int grad, int forward) {
  const size_t per = forward ? 2 : (grad ? 5 : 3);
  return per * nlat * (size_t)L + L;
}

Plan make_plan(int L, int nlat, int grad, int forward) {
  const int ps = padded_stride(L);
  const size_t bytes =
      sizeof(float) * ((size_t)L * ps + vector_floats(L, nlat, grad, forward));
  return {ps, bytes, bytes <= kSmemLimit && (!grad || tile_fits(L))};
}

__device__ __forceinline__ float clamp_penalty(int l, int label,
                                               int clamp_ns) {
  return l / clamp_ns == label ? 0.0f : kNegInf;
}

template <int NLAT>
__global__ void __launch_bounds__(kMaxThreads)
fb_forward_kernel(const float* __restrict__ state,
                  const float* __restrict__ Pg,
                  const float* __restrict__ tmax_g,
                  const int* __restrict__ labels,
                  const int* __restrict__ lengths, float* __restrict__ a0,
                  float* __restrict__ a1, float* __restrict__ z0,
                  float* __restrict__ z1, int T, int L, int clamp_ns,
                  int ps) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* Pm = smem;
  stage_matrix(Pg, smem, L, ps);
  float* alpha = smem + (size_t)L * ps;        // (NLAT, L) carry
  float* e = alpha + NLAT * L;                 // (NLAT, L) exp(alpha - m)
  float* tmx = e + NLAT * L;                   // (L)

  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* sb = state + (size_t)b * T * L;
  const int* lb = NLAT == 2 ? labels + (size_t)b * T : nullptr;
  float* out[2] = {a0 + (size_t)b * T * L,
                   NLAT == 2 ? a1 + (size_t)b * T * L : nullptr};

  // frame 0: alpha = state2, whatever the length
  {
    const int lab = NLAT == 2 ? lb[0] : 0;
    for (int l = tid; l < L; l += nth) {
      const float s = sb[l];
      tmx[l] = tmax_g[l];
      alpha[l] = s;
      out[0][l] = s;
      if (NLAT == 2) {
        const float c = s + clamp_penalty(l, lab, clamp_ns);
        alpha[L + l] = c;
        out[1][l] = c;
      }
    }
  }
  __syncthreads();

  const int g = tid % kGroup, slot = tid / kGroup, nslots = nth / kGroup;
  for (int t = 1; t < len; ++t) {
    float m[NLAT];
    row_max<NLAT>(alpha, L, m);
    for (int j = tid; j < NLAT * L; j += nth)
      e[j] = expf(alpha[j] - m[NLAT == 2 && j >= L ? NLAT - 1 : 0]);
    __syncthreads();
    const int lab = NLAT == 2 ? lb[t] : 0;
    // a uniform loop, so every lane reaches the group's shuffles
    for (int l0 = 0; l0 < L; l0 += nslots) {
      const int l = l0 + slot;
      const bool ok = l < L;
      const bool mine = ok && g == 0;
      const float s = mine ? sb[(size_t)t * L + l] : 0.0f;
      float acc[NLAT];
      group_dot<NLAT>(e, Pm, ps, L, ok ? l : 0, g, ok, acc);
      if (mine) {
#pragma unroll
        for (int i = 0; i < NLAT; ++i) {
          const float st = i == 0 ? s : s + clamp_penalty(l, lab, clamp_ns);
          const float v =
              m[i] + tmx[l] + logf(fmaxf(acc[i], kProdFloor)) + st;
          alpha[i * L + l] = v;
          out[i][(size_t)t * L + l] = v;
        }
      }
    }
    __syncthreads();
  }

  // frames past the length keep the carry
  for (size_t i = (size_t)max(len, 1) * L + tid; i < (size_t)T * L; i += nth) {
    const int l = (int)(i % L);
    out[0][i] = alpha[l];
    if (NLAT == 2) out[1][i] = alpha[L + l];
  }

  // logZ = lse(carry): warp i sums lattice i
  float m[NLAT];
  row_max<NLAT>(alpha, L, m);
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
// GRAD true (NLAT 2): o0 = g_state (B, T, L), o1 = the (B, L, L) partials of
// UV, one slice per block, summed in kTile x kTile register tiles.
template <int NLAT, bool GRAD>
__global__ void __launch_bounds__(GRAD ? kTileThreads : kMaxThreads)
fb_backward_kernel(const float* __restrict__ state,
                   const float* __restrict__ Ptg,
                   const float* __restrict__ tmaxr_g,
                   const int* __restrict__ labels,
                   const int* __restrict__ lengths,
                   const float* __restrict__ af, const float* __restrict__ ac,
                   const float* __restrict__ zf, const float* __restrict__ zc,
                   const float* __restrict__ wf, const float* __restrict__ wc,
                   float* __restrict__ o0, float* __restrict__ o1, int T,
                   int L, int clamp_ns, int ps) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b = blockIdx.x;
  const float* Pm = smem;
  stage_matrix(Ptg, smem, L, ps);
  float* beta = smem + (size_t)L * ps;         // (NLAT, L)
  float* x = beta + NLAT * L;                  // beta + state2[t + 1]
  float* v = x + NLAT * L;                     // exp(x - m)
  float* tmx = v + NLAT * L;                   // (L)
  float* a2 = tmx + L;                         // GRAD: alpha[t]
  float* u = a2 + NLAT * L;                    // GRAD: scaled exp(a2 - mU)
  // this thread's register tile of the partial: rows p0.., columns l0..
  constexpr int kT = GRAD ? kTile : 1;
  const int nt = (L + kT - 1) / kT;
  const bool tiled = GRAD && tid < nt * nt;
  const int p0 = (tid / nt) * kT, l0 = (tid % nt) * kT;
  float acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = 0.0f;

  const int len = min(max(lengths[b], 0), T);
  const float* sb = state + (size_t)b * T * L;
  const int* lb = NLAT == 2 ? labels + (size_t)b * T : nullptr;
  const float* ab[2] = {GRAD ? af + (size_t)b * T * L : nullptr,
                        GRAD ? ac + (size_t)b * T * L : nullptr};
  float* out[2] = {o0 + (size_t)b * T * L,
                   NLAT == 2 && !GRAD ? o1 + (size_t)b * T * L : nullptr};
  float z[2] = {0.0f, 0.0f}, w[2] = {0.0f, 0.0f};
  if (GRAD) {
    z[0] = zf[b];
    z[1] = zc[b];
    w[0] = wf[b];
    w[1] = wc[b];
  }

  for (int j = tid; j < NLAT * L; j += nth) beta[j] = 0.0f;
  for (int l = tid; l < L; l += nth) tmx[l] = tmaxr_g[l];
  // beta is 0 from frame length - 1 on; g_state is 0 from frame length on
  const int zero_from = GRAD ? len : max(len - 1, 0);
  for (size_t i = (size_t)zero_from * L + tid; i < (size_t)T * L; i += nth) {
    out[0][i] = 0.0f;
    if (NLAT == 2 && !GRAD) out[1][i] = 0.0f;
  }
  if (GRAD && len >= 1) {
    const size_t row = (size_t)(len - 1) * L;
    for (int l = tid; l < L; l += nth)
      out[0][row + l] = expf(ab[0][row + l] + 0.0f - z[0]) * w[0] +
                        expf(ab[1][row + l] + 0.0f - z[1]) * w[1];
  }
  __syncthreads();

  const int g = tid % kGroup, slot = tid / kGroup, nslots = nth / kGroup;
  for (int t = len - 2; t >= 0; --t) {
    const int n = t + 1;
    const int lab = NLAT == 2 ? lb[n] : 0;
    for (int j = tid; j < NLAT * L; j += nth) {
      const int i = NLAT == 2 && j >= L ? 1 : 0;
      const int l = j - i * L;
      float s = sb[(size_t)n * L + l];
      if (i == 1) s += clamp_penalty(l, lab, clamp_ns);
      x[j] = beta[j] + s;
      if (GRAD) a2[j] = ab[i][(size_t)t * L + l];
    }
    __syncthreads();
    float m[NLAT], scale[NLAT], mU[NLAT];
    row_max<NLAT>(x, L, m);
    if (GRAD) {
      row_max<NLAT>(a2, L, mU);
#pragma unroll
      for (int i = 0; i < NLAT; ++i)
        scale[i] = expf(mU[i] + m[i] - z[i]) * w[i];
    }
    for (int j = tid; j < NLAT * L; j += nth) {
      const int i = NLAT == 2 && j >= L ? NLAT - 1 : 0;
      v[j] = expf(x[j] - m[i]);
      if (GRAD) u[j] = expf(a2[j] - mU[i]) * scale[i];
    }
    __syncthreads();
    // a uniform loop, so every lane reaches the group's shuffles
    for (int l0 = 0; l0 < L; l0 += nslots) {
      const int l = l0 + slot;
      const bool ok = l < L;
      float acc[NLAT];
      group_dot<NLAT>(v, Pm, ps, L, ok ? l : 0, g, ok, acc);
      if (ok && g == 0) {
        float gsum = 0.0f;
#pragma unroll
        for (int i = 0; i < NLAT; ++i) {
          const float nb = m[i] + tmx[l] + logf(fmaxf(acc[i], kProdFloor));
          beta[i * L + l] = nb;
          if (GRAD)
            gsum += expf(a2[i * L + l] + nb - z[i]) * w[i];
          else
            out[i][(size_t)t * L + l] = nb;
        }
        if (GRAD) out[0][(size_t)t * L + l] = gsum;
      }
    }
    if (tiled) {
      // UV[p, l] += U_f[p] V_f[l] + U_c[p] V_c[l] on this thread's tile
      float uf[kT], uc[kT], vf[kT], vc[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const bool pin = p0 + i < L, lin = l0 + i < L;
        uf[i] = pin ? u[p0 + i] : 0.0f;
        uc[i] = pin ? u[L + p0 + i] : 0.0f;
        vf[i] = lin ? v[l0 + i] : 0.0f;
        vc[i] = lin ? v[L + l0 + i] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j)
          acc[i][j] = fmaf(uc[i], vc[j], fmaf(uf[i], vf[j], acc[i][j]));
    }
    __syncthreads();
  }
  if (tiled) {
    float* part = o1 + (size_t)b * L * L;
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j)
        if (p0 + i < L && l0 + j < L)
          part[(size_t)(p0 + i) * L + l0 + j] = acc[i][j];
  }
}

}  // namespace

extern "C" {

// A kernel's dynamic shared memory at width L in bytes, for the wrapper's
// check and the tests; 0: the kernel does not take this L.
size_t fwdbwd_smem_bytes(int L, int nlat, int grad, int forward) {
  const Plan p = make_plan(L, nlat, grad, forward);
  return p.ok ? p.bytes : 0;
}

int fwdbwd_forward(const float* state, const float* P, const float* tmax,
                   const int* labels, const int* lengths, float* a0,
                   float* a1, float* z0, float* z1, int B, int T, int L,
                   int nlat, int clamp_ns, void* stream) {
  const Plan p = make_plan(L, nlat, 0, 1);
  if (!p.ok || (nlat != 1 && nlat != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = nlat == 2 ? fb_forward_kernel<2> : fb_forward_kernel<1>;
  cudaError_t err = opt_in(kernel, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads_for(L), p.bytes, static_cast<cudaStream_t>(stream)>>>(
      state, P, tmax, labels, lengths, a0, a1, z0, z1, T, L, clamp_ns, p.ps);
  return static_cast<int>(cudaGetLastError());
}

int fwdbwd_backward(const float* state, const float* Pt, const float* tmax_r,
                    const int* labels, const int* lengths, float* b0,
                    float* b1, int B, int T, int L, int nlat, int clamp_ns,
                    void* stream) {
  const Plan p = make_plan(L, nlat, 0, 0);
  if (!p.ok || (nlat != 1 && nlat != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = nlat == 2 ? fb_backward_kernel<2, false>
                          : fb_backward_kernel<1, false>;
  cudaError_t err = opt_in(kernel, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads_for(L), p.bytes, static_cast<cudaStream_t>(stream)>>>(
      state, Pt, tmax_r, labels, lengths, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, b0, b1, T, L, clamp_ns, p.ps);
  return static_cast<int>(cudaGetLastError());
}

// K5: g_state (B, T, L), the per-utterance partials part (B, L, L), then
// UV (L, L) = their sum in batch order.
int fwdbwd_backward_grad(const float* state, const float* Pt,
                         const float* tmax_r, const int* labels,
                         const int* lengths, const float* af, const float* ac,
                         const float* zf, const float* zc, const float* wf,
                         const float* wc, float* g_state, float* part,
                         float* UV, int B, int T, int L, int clamp_ns,
                         void* stream) {
  const Plan p = make_plan(L, 2, 1, 0);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fb_backward_kernel<2, true>;
  cudaError_t err = opt_in(kernel, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<B, threads_for(L), p.bytes, s>>>(
      state, Pt, tmax_r, labels, lengths, af, ac, zf, zc, wf, wc, g_state,
      part, T, L, clamp_ns, p.ps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = L * L;
  fdtk::sum_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, UV, B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
