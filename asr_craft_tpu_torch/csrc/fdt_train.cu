// The training kernels of the frame-dependent-transition CRF for Hopper
// (sm_90a): the dual-lattice log-semiring forward (K1) and the backward
// with the complete weight gradient (K2).  Plain C interface, loaded with
// ctypes by asr_craft_tpu_torch/kernels/fdt_train.py; the plain PyTorch
// versions of the same functions are fdt_forward_wall_torch and
// fdt_backward_grad_wall_torch in that module.
//
// Replaces the TPU kernels of asr_craft_tpu/kernels/fdt_pallas.py:
//   fdt_train_fwd_kernel      <- fdt_forward_pallas, body _fwd_kernel
//   fdt_train_bwd_kernel      <- fdt_backward_grad_pallas, body _bwd_kernel
//                                (beta recursion and xi/gamma statistics);
//                                the same body's plane formation and
//                                contractions are the tensor-core kernels
//                                of fdt_mma.cu
//
// Layouts.  Wall (R, Du+1) packed by kernels/wall.build_wall, rows
// [state L' | self L' | adv L' | cross P*P (pi-major)], all state-major;
// K1 reads it as wall_t (fdt_common.cuh).  planes (B, T, R4) f32, every
// frame's plane row (fdt_mma.cu fdt_train_plane_kernel; R4 = R rounded up
// to 4).  feats (B, T, D) f32, labels (B, T) i32 at clamp_ns granularity
// (clamp_ns = ns: phone labels, 1: state labels), lengths (B,) i32.  alphas
// (B, T, 2, L') f32: frame t's free then clamped alpha, every frame (frames
// t >= length keep the carry).  zf, zc (B,) the log-partitions; wf, wc (B,)
// their cotangents.  dplane (B, T, R) f32: d(wf zf + wc zc) / d(plane row r
// at frame t) -- the state rows hold the posteriors gamma_t, the transition
// rows of frame t the xi of the transitions into frame t (zero at frame 0
// and at t >= length).
//
// What bounds them on this card.  Time is a serial loop: one block owns
// one utterance and walks its frames (forward up, backward down), so
// B=128 fills 128 of the 132 SMs.  K1 forms each frame's plane (R x Dw
// FMAs, 2736 x 145 at the config-2 flagship) from a Wall (1.59 MB) that
// does not fit one SM's shared memory and is re-read from L2 every frame:
// the SM's L2 port bounds a frame.  K2's recursion forms no plane: the
// planes do not depend on beta, so fdt_mma.cu forms all of them first on
// the tensor cores, and what is left on the chain is the semiring work (2
// lattices x (L' elementwise + P x P cross lse)) and 2 R exponentials a
// frame for the xi: latency, at one block an utterance.
//
// What the design does about it.  K1: the plane never leaves shared memory
// and frames past a row's length are neither formed nor updated.  K2's
// recursion reads frame t+1's plane row (10.9 KB at the flagship) and
// alpha_t from device memory one frame ahead, into the other of two
// shared buffers, while the current frame's work runs: the row by one
// cp.async.bulk on an mbarrier, alpha by cp.async.  A frame takes three
// barriers: the buffers in place (A), xs complete (B), the cross lse
// complete (C); beta_t and gamma_t are formed by one thread a label for
// both lattices, so no barrier separates them.  The P x P cross-phone terms
// dominate a frame: each source phone's lse runs on a group of 16 lanes
// merged by shuffles (the only chain of P terms), and one exponential a
// term serves both the lse and the xi.  dWall is shared by every
// utterance, and Hopper blocks run in parallel with no carry between them,
// so K2 writes dplane to device memory and fdt_mma.cu contracts it in a
// fixed order.
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

constexpr int kThreads = 768;       // one pass over 684 flagship row groups
constexpr int kCrossLanes = 16;     // K2's lanes per source phone

size_t fwd_smem_floats(int Du, int ns, int P) {
  const size_t Lp = (size_t)ns * P;
  // plane (16-byte aligned first) | x | alpha (2 L') | cand (2 L') | crossed
  return round_up4(3 * ns * P + P * P) + (size_t)(Du + 1) + 4 * Lp +
         2 * (size_t)P;
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

__global__ void __launch_bounds__(kThreads)
fdt_train_fwd_kernel(const float* __restrict__ wall_t,
                     const float* __restrict__ feats,
                     const int* __restrict__ labels,
                     const int* __restrict__ lengths,
                     float* __restrict__ alphas, float* __restrict__ zf,
                     float* __restrict__ zc, int T, int D, int u0, int Du,
                     int ns, int P, int clamp_ns, int boundaries) {
  extern __shared__ float4 smem4[];
  const int Lp = ns * P, L2 = 2 * Lp, Dw = Du + 1;
  const int R4 = round_up4(3 * Lp + P * P), Q = R4 / 4;
  float* plane = reinterpret_cast<float*>(smem4);        // (R4)
  float* x = plane + R4;                                 // (Dw) x_t | 1
  float* alpha = x + Dw;                                 // (2 L') carry
  float* cand = alpha + L2;                              // (2 L')
  float* crossed = cand + L2;                            // (2 P)

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int len_raw = lengths[b];
  const int len = min(max(len_raw, 0), T);
  const float* xb = feats + (size_t)b * T * D + u0;
  const int* lab = labels + (size_t)b * T;
  float* out = alphas + (size_t)b * T * L2;
  const bool bnd = boundaries && ns > 1;

  // frame 0 always runs (a length-0 row still reports its initial lse)
  const int tend = max(len, 1);
  for (int t = 0; t < tend; ++t) {
    fdtk::load_x(xb + (size_t)t * D, x, Du);
    __syncthreads();
    fdtk::form_plane(wall_t, x, smem4, Q, Dw);
    __syncthreads();
    const int y = lab[t];
    const bool bnd_end = bnd && t == len_raw - 1;
    if (t == 0) {
      for (int i = tid; i < L2; i += nth) {
        const int h = i / Lp, l = i - h * Lp, st = l % ns;
        float s = plane[l] + state_mask(h, l, st, ns, bnd_end, clamp_ns, y);
        if (bnd && st > 0) s += kNegInf;                 // start mask
        alpha[i] = s;
      }
    } else {
      // crossed[h, pj] = lse_pi(alpha_h[last(pi)] + cross[pi, pj])
      for (int i = tid; i < 2 * P; i += nth) {
        const int h = i / P, pj = i - h * P;
        const float* a = alpha + h * Lp + ns - 1;
        const float* cr = plane + 3 * Lp + pj;
        float m = -INFINITY;
        for (int pi = 0; pi < P; ++pi) m = fmaxf(m, a[pi * ns] + cr[pi * P]);
        m = fmaxf(m, kNegInf);
        float s = 0.0f;
        for (int pi = 0; pi < P; ++pi) s += expf(a[pi * ns] + cr[pi * P] - m);
        crossed[i] = m + logf(fmaxf(s, 1e-35f));
      }
      __syncthreads();
      for (int i = tid; i < L2; i += nth) {
        const int h = i / Lp, l = i - h * Lp, st = l % ns, p = l / ns;
        const float* a = alpha + h * Lp;
        float c;
        if (ns == 1) {
          c = crossed[h * P + p];
        } else {
          const float self_c = a[l] + plane[Lp + l];
          const float adv_c = st > 0 ? a[l - 1] + plane[2 * Lp + l - 1]
                                     : kNegInf;
          const float cross_c = st == 0 ? crossed[h * P + p] : kNegInf;
          c = lse3(self_c, adv_c, cross_c);
        }
        cand[i] = c + plane[l] +
                  state_mask(h, l, st, ns, bnd_end, clamp_ns, y);
      }
      __syncthreads();
      for (int i = tid; i < L2; i += nth) alpha[i] = cand[i];
    }
    __syncthreads();
    for (int i = tid; i < L2; i += nth) out[(size_t)t * L2 + i] = alpha[i];
    // the next frame's load_x/form_plane overwrite x and the plane only
    // after every thread has passed this barrier
    __syncthreads();
  }
  for (size_t i = (size_t)tend * L2 + tid; i < (size_t)T * L2; i += nth)
    out[i] = alpha[i % L2];

  // z_h = lse over L' of the final carry: warp h reduces lattice h
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < 2) {
    const float* a = alpha + warp * Lp;
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

size_t fdt_train_fwd_smem_bytes(int Du, int ns, int P) {
  return sizeof(float) * fwd_smem_floats(Du, ns, P);
}

size_t fdt_train_bwd_smem_bytes(int ns, int P) {
  return sizeof(float) * bwd_smem_floats(ns, P);
}

int fdt_train_fwd(const float* wall_t, const float* feats, const int* labels,
                  const int* lengths, float* alphas, float* zf, float* zc,
                  int B, int T, int D, int u0, int Du, int ns, int P,
                  int clamp_ns, int boundaries, void* stream) {
  const size_t smem = fdt_train_fwd_smem_bytes(Du, ns, P);
  const int err = set_smem((const void*)fdt_train_fwd_kernel, smem);
  if (err != 0) return err;
  fdt_train_fwd_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      wall_t, feats, labels, lengths, alphas, zf, zc, T, D, u0, Du, ns, P,
      clamp_ns, boundaries);
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
