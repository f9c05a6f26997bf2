// The training kernels of the frame-dependent-transition CRF for Hopper
// (sm_90a): the dual-lattice log-semiring forward recursion (K1) and the
// backward recursion with the complete weight gradient (K2).  Plain C
// interface, loaded with ctypes by asr_craft_tpu_torch/kernels/fdt_train.py;
// the plain PyTorch versions of the same functions are
// fdt_forward_planes_torch and fdt_dplane_wall_torch in that module.
//
// Replaces the TPU kernels of asr_craft_tpu/kernels/fdt_pallas.py:
//   fdt_train_fwd_kernel      <- fdt_forward_pallas, body _fwd_kernel (its
//                                recursion; the block's plane formation,
//                                _form called at :276, is fdt_mma.cu's
//                                plane kernel)
//   fdt_train_bwd_kernel      <- fdt_backward_grad_pallas, body _bwd_kernel
//                                (beta recursion and xi/gamma statistics);
//                                the same body's plane formation and
//                                contractions are the tensor-core kernels
//                                of fdt_mma.cu
//
// Layouts.  Wall (R, Du+1) packed by kernels/wall.build_wall, rows
// [state L' | self L' | adv L' | cross P*P (pi-major)], all state-major.
// planes (B, T, R4) f32, every frame's plane row Wall @ [x_t; 1]
// (fdt_mma.cu fdt_train_plane_kernel; R4 = R rounded up to 4, the pad
// never read).  labels (B, T) i32 at clamp_ns granularity (clamp_ns = ns:
// phone labels, 1: state labels), lengths (B,) i32.  alphas (B, T, 2, L')
// f32: frame t's free then clamped alpha, every frame (frames t >= length
// keep the carry).  zf, zc (B,) the log-partitions; wf, wc (B,) their
// cotangents.  dplane (B, T, R) f32: d(wf zf + wc zc) / d(plane row r at
// frame t) -- the state rows hold the posteriors gamma_t, the transition
// rows of frame t the xi of the transitions into frame t (zero at frame 0
// and at t >= length).
//
// What bounds them on this card.  Time is a serial loop: one block owns
// one utterance and walks its frames (K1 up, K2 down), so B=128 fills 128
// of the 132 SMs.  Neither forms a plane: the planes do not depend on alpha
// or beta, so fdt_mma.cu forms all of them first on the tensor cores, once
// a train step (K1's wrapper hands them on to K2).  What is left on the
// chain is the semiring work -- 2 lattices x (L' elementwise + P x P cross
// lse) a frame, and K2's 2 R exponentials for the xi -- and the barriers
// between its steps: latency, at one block an utterance.
//
// What the design does about it.  Both recursions read frame t+1's plane
// row (10.9 KB at the flagship) from device memory one frame ahead, into
// the other of two shared buffers, by one cp.async.bulk on an mbarrier,
// while the current frame's work runs (K2 also alpha_t, by cp.async).  The
// P x P cross-phone terms dominate a frame; they run on groups of 16 lanes
// merged by shuffles: K1 a group a destination phone pj (the lse over the
// source phones pi), K2 a group a source phone pi (the lse over pj and the
// xi, one exponential a term serving both).  K1 takes two barriers a frame
// -- the plane and alpha_t-1 in place (A), the cross lse complete (B) --
// and writes alpha_t into the other of two shared buffers and straight to
// device memory.  K2 takes three: the buffers in place (A), xs complete
// (B), the cross lse complete (C); beta_t and gamma_t are formed by one
// thread a label for both lattices.  dWall is shared by every utterance,
// and Hopper blocks run in parallel with no carry between them, so K2
// writes dplane to device memory and fdt_mma.cu contracts it in a fixed
// order.  Not done: several utterances a block, the cross block read
// without bank conflicts (K1's groups read a column of the pi-major cross
// block: at P = 48 a warp's 32 reads fall on 4 banks).
//
// Semantics held to the reference (ops/fdt.py, fdt_pallas.py):
//   alpha_0 = state2_0 (+ start mask: frame 0 enters first states only);
//   alpha_t = lse3(alpha[l] + self[l], alpha[l-1] + adv[l-1] (st > 0),
//             lse_pi(alpha[last(pi)] + cross[pi, p(l)]) (st == 0)) + state2_t
//   for t < length, else the carry; state2_t = state_t + end mask (st <
//   ns-1 at t == length-1) + clamp (l / clamp_ns != label_t, clamped lattice
//   only).  z = lse over L'.  Backward: beta = 0 at frames >= length-1,
//   gates exp(min(s - z, 40)) * w where the lattice is live (z > NEG_INF/2)
//   and the frame exists.  All arithmetic is IEEE fp32 (expf/logf, no fast
//   math).

#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::kNegInf;
using fdtk::lse3;
using fdtk::round_up4;

constexpr int kThreads = 768;       // 48 groups of kCrossLanes lanes
constexpr int kCrossLanes = 16;     // lanes a phone in the cross lse
constexpr int kMaxP = 128;          // the wrappers' phone cap
constexpr int kPerLane = kMaxP / kCrossLanes;

// K1's recursion: planes (2 R4, 16-byte aligned first) | alpha (2 x 2 L')
// | crossed (2 P), then two 8-byte mbarriers
__host__ __device__ inline int fwd_barrier_offset(int ns, int P) {
  const int Lp = ns * P;
  return (2 * round_up4(3 * Lp + P * P) + 4 * Lp + 2 * P + 1) & ~1;
}

size_t fwd_smem_floats(int ns, int P) {
  return (size_t)fwd_barrier_offset(ns, P) + 4;
}

// K2's recursion: planes (2 R4, 16-byte aligned first) | beta (2 L') | xs
// (2 L') | alpha (2 x 2 L') | crossb (2 P), then two 8-byte mbarriers
__host__ __device__ inline int bwd_barrier_offset(int ns, int P) {
  const int Lp = ns * P;
  return (2 * round_up4(3 * Lp + P * P) + 8 * Lp + 2 * P + 1) & ~1;
}

size_t bwd_smem_floats(int ns, int P) {
  return (size_t)bwd_barrier_offset(ns, P) + 4;
}

// state2 minus the plane's state row: the end mask (both lattices) and the
// clamp (lattice h == 1); frame t, expanded label l of phone-state st.
__device__ __forceinline__ float state_mask(int h, int l, int st, int ns,
                                            bool bnd_end, int clamp_ns,
                                            int label) {
  float s = (bnd_end && st != ns - 1) ? kNegInf : 0.0f;
  if (h == 1 && l / clamp_ns != label) s += kNegInf;
  return s;
}

// Frame t's plane row arrives in shared memory one frame ahead, in one of
// two buffers, by one cp.async.bulk on an mbarrier; alpha_t is written into
// the other of two buffers from the one that holds alpha_t-1.
__global__ void __launch_bounds__(kThreads)
fdt_train_fwd_kernel(const float* __restrict__ planes,
                     const int* __restrict__ labels,
                     const int* __restrict__ lengths,
                     float* __restrict__ alphas, float* __restrict__ zf,
                     float* __restrict__ zc, int T, int ns, int P,
                     int clamp_ns, int boundaries) {
  extern __shared__ float4 smem4[];
  const int Lp = ns * P, L2 = 2 * Lp, R4 = round_up4(3 * Lp + P * P);
  float* pbuf = reinterpret_cast<float*>(smem4);         // (2, R4) planes
  float* abuf = pbuf + 2 * R4;                           // (2, 2 L') alpha
  float* crossed = abuf + 2 * L2;                        // (2 P)
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
      pbuf + fwd_barrier_offset(ns, P));                 // (2) one a buffer

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int len_raw = lengths[b];
  const int len = min(max(len_raw, 0), T);
  const float* pb = planes + (size_t)b * T * R4;
  const int* lab = labels + (size_t)b * T;
  float* out = alphas + (size_t)b * T * L2;
  const bool bnd = boundaries && ns > 1;
  const unsigned row_bytes = sizeof(float) * R4;
  const int gl = tid & (kCrossLanes - 1);
  const unsigned gmask = ((1u << kCrossLanes) - 1)
                         << ((tid & 31) & ~(kCrossLanes - 1));

  // frame 0 always runs (a length-0 row still reports its initial lse)
  const int tend = max(len, 1);
  if (tid == 0) {
    fdtk::mbar_init(&bar[0], 1);
    fdtk::mbar_init(&bar[1], 1);
  }
  __syncthreads();                      // the barriers initialised
  if (tid == 0) fdtk::bulk_load(pbuf, pb, row_bytes, &bar[0]);
  int y_next = lab[0];                  // label of frame t, read a frame ahead
  for (int t = 0; t < tend; ++t) {
    const float* plane = pbuf + (t & 1) * R4;
    const float* a = abuf + ((t + 1) & 1) * L2;          // alpha_t-1
    float* an = abuf + (t & 1) * L2;                     // alpha_t
    const int y = y_next;
    if (t + 1 < tend) y_next = lab[t + 1];
    // plane t is the t-th row to land in buffer t & 1: that barrier's
    // (t >> 1)-th phase
    fdtk::mbar_wait(&bar[t & 1], (t >> 1) & 1);
    // (A) plane t and alpha_t-1 in place for every thread; frame t-1's
    // reads of buffer (t + 1) & 1 are done
    __syncthreads();
    if (tid == 0 && t + 1 < tend)
      fdtk::bulk_load(pbuf + ((t + 1) & 1) * R4, pb + (size_t)(t + 1) * R4,
                      row_bytes, &bar[(t + 1) & 1]);
    const bool bnd_end = bnd && t == len_raw - 1;
    if (t > 0) {
      // crossed[h, pj] = lse_pi(alpha_h[last(pi)] + cross[pi, pj]), a group
      // of kCrossLanes lanes a destination phone pj (pi split over the
      // group, merged with shuffles), both lattices; each term is formed
      // once and kept in registers for the max and the sum
      for (int pj = tid / kCrossLanes; pj < P; pj += nth / kCrossLanes) {
        const float* cr = plane + 3 * Lp + pj;
        float x0[kPerLane], x1[kPerLane];
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int pi = gl + k * kCrossLanes;
          if (pi < P) {
            const float c = cr[pi * P];
            x0[k] = a[pi * ns + ns - 1] + c;
            x1[k] = a[Lp + pi * ns + ns - 1] + c;
            m0 = fmaxf(m0, x0[k]);
            m1 = fmaxf(m1, x1[k]);
          }
        }
        for (int o = kCrossLanes / 2; o > 0; o >>= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(gmask, m0, o));
          m1 = fmaxf(m1, __shfl_xor_sync(gmask, m1, o));
        }
        m0 = fmaxf(m0, kNegInf);
        m1 = fmaxf(m1, kNegInf);
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          if (gl + k * kCrossLanes < P) {
            s0 += expf(x0[k] - m0);
            s1 += expf(x1[k] - m1);
          }
        }
        for (int o = kCrossLanes / 2; o > 0; o >>= 1) {
          s0 += __shfl_xor_sync(gmask, s0, o);
          s1 += __shfl_xor_sync(gmask, s1, o);
        }
        if (gl == 0) {
          crossed[pj] = m0 + logf(fmaxf(s0, 1e-35f));
          crossed[P + pj] = m1 + logf(fmaxf(s1, 1e-35f));
        }
      }
      __syncthreads();                  // (B) crossed complete
    }
    for (int i = tid; i < L2; i += nth) {
      const int h = i / Lp, l = i - h * Lp, st = l % ns, p = l / ns;
      float v;
      if (t == 0) {
        v = plane[l] + state_mask(h, l, st, ns, bnd_end, clamp_ns, y);
        if (bnd && st > 0) v += kNegInf;                 // start mask
      } else {
        const float* ah = a + h * Lp;
        float c;
        if (ns == 1) {
          c = crossed[h * P + p];
        } else {
          const float self_c = ah[l] + plane[Lp + l];
          const float adv_c = st > 0 ? ah[l - 1] + plane[2 * Lp + l - 1]
                                     : kNegInf;
          const float cross_c = st == 0 ? crossed[h * P + p] : kNegInf;
          c = lse3(self_c, adv_c, cross_c);
        }
        v = c + plane[l] + state_mask(h, l, st, ns, bnd_end, clamp_ns, y);
      }
      an[i] = v;
      out[(size_t)t * L2 + i] = v;
    }
  }
  __syncthreads();                      // the last alpha complete
  const float* alast = abuf + ((tend - 1) & 1) * L2;
  for (size_t i = (size_t)tend * L2 + tid; i < (size_t)T * L2; i += nth)
    out[i] = alast[i % L2];

  // z_h = lse over L' of the final carry: warp h reduces lattice h
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < 2) {
    const float* a = alast + warp * Lp;
    float m = -INFINITY;
    for (int l = lane; l < Lp; l += 32) m = fmaxf(m, a[l]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    m = fmaxf(m, kNegInf);
    float s = 0.0f;
    for (int l = lane; l < Lp; l += 32) s += expf(a[l] - m);
    for (int o = 16; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) (warp == 0 ? zf : zc)[b] = m + logf(fmaxf(s, 1e-35f));
  }
}

// The plane row of frame n (R4 floats) and alpha_t (2 L') arrive in shared
// memory one frame ahead, each in one of two buffers: the plane by one
// cp.async.bulk on an mbarrier, alpha by cp.async from every thread.
__global__ void __launch_bounds__(kThreads)
fdt_train_bwd_kernel(const float* __restrict__ planes,
                     const int* __restrict__ labels,
                     const int* __restrict__ lengths,
                     const float* __restrict__ alphas,
                     const float* __restrict__ zf,
                     const float* __restrict__ zc,
                     const float* __restrict__ wf,
                     const float* __restrict__ wc,
                     float* __restrict__ dplane, int T, int ns, int P,
                     int clamp_ns, int boundaries) {
  extern __shared__ float4 smem4[];
  const int Lp = ns * P, L2 = 2 * Lp, R = 3 * Lp + P * P;
  const int R4 = round_up4(R);
  float* pbuf = reinterpret_cast<float*>(smem4);         // (2, R4) planes
  float* beta = pbuf + 2 * R4;                           // (2 L')
  float* xs = beta + L2;                                 // (2 L') beta+state2
  float* abuf = xs + L2;                                 // (2, 2 L') alpha_t
  float* crossb = abuf + 2 * L2;                         // (2 P)
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
      pbuf + bwd_barrier_offset(ns, P));                 // (2) one a buffer

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int len_raw = lengths[b];
  const int len = min(max(len_raw, 0), T);
  const float* pb = planes + (size_t)b * T * R4;
  const int* lab = labels + (size_t)b * T;
  const float* ab = alphas + (size_t)b * T * L2;
  float* dp = dplane + (size_t)b * T * R;
  const bool bnd = boundaries && ns > 1;
  // per lattice h: log-partition, cotangent weight, and whether it lives
  // (a dead lattice, with no legal path, contributes zero gradient)
  const float z0 = zf[b], z1 = zc[b], w0 = wf[b], w1 = wc[b];
  const bool live0 = z0 > kNegInf * 0.5f, live1 = z1 > kNegInf * 0.5f;
  const unsigned row_bytes = sizeof(float) * R4;

  if (tid == 0) {
    fdtk::mbar_init(&bar[0], 1);
    fdtk::mbar_init(&bar[1], 1);
  }
  if (len >= 1)
    for (int i = tid; i < L2; i += nth)
      fdtk::cp_async4(abuf + ((len - 1) & 1) * L2 + i,
                      ab + (size_t)(len - 1) * L2 + i);
  fdtk::cp_async_commit();
  for (size_t i = (size_t)len * R + tid; i < (size_t)T * R; i += nth)
    dp[i] = 0.0f;
  if (len >= 1)                         // frame 0 has no transition
    for (int r = Lp + tid; r < R; r += nth) dp[r] = 0.0f;
  for (int i = tid; i < L2; i += nth) beta[i] = 0.0f;

  // `used` planes consumed, `issued` requested; plane j lives in buffer
  // j & 1, whose barrier completes its (j >> 1)-th phase when it lands
  int used = 0, issued = 0;
  int y_next = 0;                       // label of frame t + 1
  for (int t = len - 1; t >= 0; --t) {
    const bool has_next = t + 1 < len;  // frame n = t + 1 exists
    const int y = y_next;
    y_next = lab[t];
    const float* plane = pbuf + (used & 1) * R4;
    const float* at = abuf + (t & 1) * L2;
    fdtk::cp_async_wait<0>();           // this thread's share of alpha_t
    if (has_next) fdtk::mbar_wait(&bar[used & 1], (used >> 1) & 1);
    // (A) alpha_t and the plane of frame t+1 in place for every thread;
    // the buffers of step t+1 are free again
    __syncthreads();
    if (t >= 1) {                       // step t-1 reads plane t, alpha_t-1
      if (tid == 0)
        fdtk::bulk_load(pbuf + (issued & 1) * R4, pb + (size_t)t * R4,
                        row_bytes, &bar[issued & 1]);
      ++issued;
      for (int i = tid; i < L2; i += nth)
        fdtk::cp_async4(abuf + ((t - 1) & 1) * L2 + i,
                        ab + (size_t)(t - 1) * L2 + i);
    }
    fdtk::cp_async_commit();
    if (has_next) {
      const int n = t + 1;
      const bool bnd_end = bnd && n == len_raw - 1;
      for (int i = tid; i < L2; i += nth) {
        const int h = i / Lp, l = i - h * Lp, st = l % ns;
        xs[i] = beta[i] + plane[l] +
                state_mask(h, l, st, ns, bnd_end, clamp_ns, y);
      }
      __syncthreads();                  // (B) xs complete
      // The cross-phone terms, a group of kCrossLanes lanes a source phone
      // pi (pj split over the group, merged with shuffles), both lattices:
      //   m_h = max(max_pj(xs_h[first(pj)] + cross[pi, pj]), NEG_INF),
      //   e_h = exp(xs_h[first(pj)] + cross[pi, pj] - m_h),
      //   crossb[h, pi] = m_h + log(max(sum_pj e_h, 1e-35)),
      //   xi[pi, pj] = sum_h e_h g_h,
      //   g_h = exp(min(alpha_h[last(pi)] + m_h - z_h, 40)) w_h:
      // one exponential a term serves the lse and the xi, as in the TPU
      // kernel (which takes the max over all pi; here it is per pi)
      float* dpn = dp + (size_t)n * R;
      {
        const int gl = tid & (kCrossLanes - 1);
        const unsigned gmask = ((1u << kCrossLanes) - 1)
                               << ((tid & 31) & ~(kCrossLanes - 1));
        for (int pi = tid / kCrossLanes; pi < P; pi += nth / kCrossLanes) {
          const float* cr = plane + 3 * Lp + pi * P;
          float m[2], s[2] = {0.0f, 0.0f}, g[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* xh = xs + h * Lp;
            float v = -INFINITY;
            for (int pj = gl; pj < P; pj += kCrossLanes)
              v = fmaxf(v, xh[pj * ns] + cr[pj]);
            for (int o = kCrossLanes / 2; o > 0; o >>= 1)
              v = fmaxf(v, __shfl_xor_sync(gmask, v, o));
            m[h] = fmaxf(v, kNegInf);
            g[h] = (h ? live1 : live0)
                       ? expf(fminf(at[h * Lp + pi * ns + ns - 1] + m[h] -
                                        (h ? z1 : z0),
                                    40.0f)) *
                             (h ? w1 : w0)
                       : 0.0f;
          }
          for (int pj = gl; pj < P; pj += kCrossLanes) {
            const float c = cr[pj];
            const float e0 = expf(xs[pj * ns] + c - m[0]);
            const float e1 = expf(xs[Lp + pj * ns] + c - m[1]);
            s[0] += e0;
            s[1] += e1;
            dpn[3 * Lp + pi * P + pj] = e0 * g[0] + e1 * g[1];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            for (int o = kCrossLanes / 2; o > 0; o >>= 1)
              s[h] += __shfl_xor_sync(gmask, s[h], o);
            if (gl == 0) crossb[h * P + pi] = m[h] + logf(fmaxf(s[h], 1e-35f));
          }
        }
      }
      // xi of the self and advance transitions into frame n, summed over
      // the two lattices (zero rows at ns == 1)
      for (int r = Lp + tid; r < 3 * Lp; r += nth) {
        float v = 0.0f;
        for (int h = 0; h < 2; ++h) {
          if (ns == 1 || !(h ? live1 : live0)) continue;
          const float* a = at + h * Lp;
          const float* xh = xs + h * Lp;
          float s;
          if (r < 2 * Lp) {                              // self
            const int l = r - Lp;
            s = a[l] + plane[r] + xh[l];
          } else {                                       // advance
            const int l = r - 2 * Lp;
            if (l % ns == ns - 1) continue;
            s = a[l] + plane[r] + xh[l + 1];
          }
          v += expf(fminf(s - (h ? z1 : z0), 40.0f)) * (h ? w1 : w0);
        }
        dpn[r] = v;
      }
      __syncthreads();                  // (C) crossb complete
    }
    // beta_t (0 where frame t+1 does not exist) and gamma_t, the state rows
    // of frame t: one thread a label, both lattices
    for (int l = tid; l < Lp; l += nth) {
      const int st = l % ns, p = l / ns;
      float g = 0.0f;
      for (int h = 0; h < 2; ++h) {
        float bt = 0.0f;
        if (has_next) {
          const float* xh = xs + h * Lp;
          if (ns == 1) {
            bt = crossb[h * P + p];
          } else {
            const float self_c = xh[l] + plane[Lp + l];
            const float adv_c = st < ns - 1 ? xh[l + 1] + plane[2 * Lp + l]
                                            : kNegInf;
            const float cross_c = st == ns - 1 ? crossb[h * P + p]
                                               : kNegInf;
            bt = lse3(self_c, adv_c, cross_c);
          }
        }
        beta[h * Lp + l] = bt;
        if (h ? live1 : live0)
          g += expf(fminf(at[h * Lp + l] + bt - (h ? z1 : z0), 40.0f)) *
               (h ? w1 : w0);
      }
      dp[(size_t)t * R + l] = g;
    }
    if (has_next) ++used;
  }
}

int set_smem(const void* kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

extern "C" {

size_t fdt_train_fwd_smem_bytes(int ns, int P) {
  return sizeof(float) * fwd_smem_floats(ns, P);
}

size_t fdt_train_bwd_smem_bytes(int ns, int P) {
  return sizeof(float) * bwd_smem_floats(ns, P);
}

// planes (B, T, R4) from fdt_train_plane (fdt_mma.cu); P <= 128
int fdt_train_fwd(const float* planes, const int* labels, const int* lengths,
                  float* alphas, float* zf, float* zc, int B, int T, int ns,
                  int P, int clamp_ns, int boundaries, void* stream) {
  const size_t smem = fdt_train_fwd_smem_bytes(ns, P);
  const int err = set_smem((const void*)fdt_train_fwd_kernel, smem);
  if (err != 0) return err;
  fdt_train_fwd_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      planes, labels, lengths, alphas, zf, zc, T, ns, P, clamp_ns,
      boundaries);
  return static_cast<int>(cudaGetLastError());
}

// planes (B, T, R4) from fdt_train_plane (fdt_mma.cu)
int fdt_train_bwd(const float* planes, const int* labels, const int* lengths,
                  const float* alphas, const float* zf, const float* zc,
                  const float* wf, const float* wc, float* dplane, int B,
                  int T, int ns, int P, int clamp_ns, int boundaries,
                  void* stream) {
  const size_t smem = fdt_train_bwd_smem_bytes(ns, P);
  const int err = set_smem((const void*)fdt_train_bwd_kernel, smem);
  if (err != 0) return err;
  fdt_train_bwd_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      planes, labels, lengths, alphas, zf, zc, wf, wc, dplane, T, ns, P,
      clamp_ns, boundaries);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
