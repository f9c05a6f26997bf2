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
// lse) a frame -- and the barriers between its steps: latency, at one
// block an utterance.  K2 also owes 2 R exponentials a frame for the xi and
// gamma, and R floats of dplane to device memory, none of which the chain
// needs.
//
// What the design does about it.  K1 reads frame t+1's plane row (10.9 KB
// at the flagship) from device memory one frame ahead, into the other of
// two shared buffers, by one cp.async.bulk on an mbarrier, while the
// current frame's work runs.  The P x P cross-phone terms dominate a
// frame; they run on groups of 16 lanes merged by shuffles: K1 a group a
// destination phone pj (the lse over the source phones pi), K2 a group a
// source phone pi (the lse over pj).  K1 takes two barriers a frame -- the
// plane and alpha_t-1 in place (A), the cross lse complete (B) -- and
// writes alpha_t into the other of two shared buffers and straight to
// device memory.
//
// K2 splits its block by roles (12 chain warps, 11 statistics warps, one
// feeder warp: 768 threads), joined only by mbarriers on a ring of `stages`
// slots in shared memory, one slot a frame (kernels/fdt_train.
// backward_stages: as many as a block's shared memory holds, up to 8; 8 at
// the flagship, 14.8 KB a slot; 2 at P = 128, ns = 3, 80 KB a slot):
//   - the feeder loads into a slot plane row n by cp.async.bulk and alpha_t
//     (t = n-1) and the label of frame n by cp.async, once the statistics
//     have released it, a ring ahead of both; while it waits it writes the
//     rows of dplane that are zero (frames >= length, frame 0's
//     transitions);
//   - the chain runs beta alone, from frame length-1 down: a group of 16
//     lanes takes two source phones at a time and forms their cross max m
//     and lse, the two interleaved; 4 ns of its lanes then form those
//     phones' beta_n-1 by lse3 and, next frame, xs_n-1 = beta_n-1 +
//     state2_n-1, so each lane reads back only its own beta and the frame
//     takes one named barrier (xs complete).  It writes xs, m and beta into
//     the slot, reads no alpha and writes nothing to device memory;
//   - the statistics follow up to a ring behind: from the slot alone they
//     write gamma_t, the self and advance xi and, after one named barrier
//     (the gates g_h complete), the cross xi, the exponential e_h =
//     exp(xs_h[first(pj)] + cross[pi, pj] - m_h) formed again (two rows a
//     half-warp, xs in registers), then release the slot.
// So the chain waits for the statistics only where they fall a whole ring
// behind.  dWall is shared by every utterance, and Hopper blocks run in
// parallel with no carry between them, so K2 writes dplane to device
// memory and fdt_mma.cu contracts it in a fixed order.  The split moves no
// arithmetic: each value is formed by the same expressions in the same
// order as by one role walking the frame (the xi's contraction e0 g0 + e1
// g1 = fma(e0, g0, e1 g1) written out), so dplane's bits do not depend on
// the roles.  What still bounds K2: the chain's latency (its barrier, two
// shuffle trees a pair of phones, the exponentials of the lse; 12 warps
// leave little to hide it) and, as P grows, the statistics' P x P
// exponentials, formed again beside the lse's: at P = 128 a ring of two
// couples the roles (PERF.md §7).  Not done: several utterances a block; a
// cluster of two blocks an utterance (K3's split: at B = 128 two blocks an
// SM); writing dplane over the planes it read; the cross block read
// without bank conflicts in K1 (its groups read a column of the pi-major
// cross block: at P = 48 a warp's 32 reads fall on 4 banks).
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

// K2's block: the chain's warps (a group of kCrossLanes lanes two source
// phones at a time), the statistics' warps and one feeder warp
constexpr int kChainWarps = 12;
constexpr int kStatWarps = 11;
constexpr int kChainThreads = 32 * kChainWarps;
constexpr int kStatThreads = 32 * kStatWarps;
constexpr int kBwdThreads = kChainThreads + kStatThreads + 32;

// K2's recursion: a ring of `stages` slots, each [plane row (R4, 16-byte
// aligned) | xs (2 L') | m (2 P) | beta (2 L') | alpha (2 L') | label (1)]
// rounded up to 4 floats, then two buffers of the xi gates (2 x 2 P), then
// 3 x stages 8-byte mbarriers
__host__ __device__ inline int bwd_slot_floats(int ns, int P) {
  const int Lp = ns * P;
  return round_up4(round_up4(3 * Lp + P * P) + 6 * Lp + 2 * P + 1);
}

__host__ __device__ inline int bwd_barrier_offset(int ns, int P,
                                                  int stages) {
  return (stages * bwd_slot_floats(ns, P) + 4 * P + 1) & ~1;
}

size_t bwd_smem_floats(int ns, int P, int stages) {
  return (size_t)bwd_barrier_offset(ns, P, stages) + 6 * stages;
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
          if (k * kCrossLanes >= P) break;
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

// p[0:n) = 0 by the 32 lanes of a warp: 16-byte stores between a scalar
// head and tail
__device__ void warp_zero(float* p, int n, int lane) {
  const int head = min(
      n, (int)((16 - (reinterpret_cast<size_t>(p) & 15)) & 15) >> 2);
  for (int i = lane; i < head; i += 32) p[i] = 0.0f;
  float4* q = reinterpret_cast<float4*>(p + head);
  const int n4 = (n - head) >> 2;
  for (int i = lane; i < n4; i += 32) q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = head + 4 * n4 + lane; i < n; i += 32) p[i] = 0.0f;
}

// Three roles, joined only by the ring's mbarriers.  Ring row j (0 to
// len-1) serves frame t = len-1-j of the statistics and, for j >= 1, frame
// n = t+1 of the chain, in slot j % stages:
//   full[s]  alpha_t, the label of frame n and plane row n landed (the
//            feeder: one arrival a lane by cp.async, and lane 0's
//            cp.async.bulk);
//   ready[s] the chain has written xs_n, m(n) and beta_t into the slot (one
//            arrival a chain warp; row 0 carries nothing of the chain);
//   empty[s] the statistics are done with the slot (one a statistics warp).
__global__ void __launch_bounds__(kBwdThreads)
fdt_train_bwd_kernel(const float* __restrict__ planes,
                     const int* __restrict__ labels,
                     const int* __restrict__ lengths,
                     const float* __restrict__ alphas,
                     const float* __restrict__ zf,
                     const float* __restrict__ zc,
                     const float* __restrict__ wf,
                     const float* __restrict__ wc,
                     float* __restrict__ dplane, int T, int ns, int P,
                     int clamp_ns, int boundaries, int stages) {
  extern __shared__ float4 smem4[];
  const int Lp = ns * P, L2 = 2 * Lp, R = 3 * Lp + P * P;
  const int R4 = round_up4(R), slot_f = bwd_slot_floats(ns, P);
  // a slot's pieces, from its plane row
  const int xs_off = R4, m_off = xs_off + L2, beta_off = m_off + 2 * P;
  const int alpha_off = beta_off + L2, label_off = alpha_off + L2;
  float* ring = reinterpret_cast<float*>(smem4);    // (stages, slot_f)
  float* gbuf = ring + stages * slot_f;             // (2, 2 P) the xi gates
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      ring + bwd_barrier_offset(ns, P, stages));
  unsigned long long* ready = full + stages;
  unsigned long long* empty = ready + stages;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len_raw = lengths[b];
  const int len = min(max(len_raw, 0), T);
  float* dp = dplane + (size_t)b * T * R;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      fdtk::mbar_init(&full[s], 33);
      fdtk::mbar_init(&ready[s], kChainWarps);
      fdtk::mbar_init(&empty[s], kStatWarps);
    }
  }
  __syncthreads();                      // the barriers initialised

  if (warp < kChainWarps) {
    // The chain: beta_n-1 from xs_n = beta_n + state2_n and plane n, nothing
    // else.  A group of kCrossLanes lanes takes two source phones at a time,
    // pa and pb = pa + ngrp, and forms each one's cross lse over pj (pj split
    // over the group, merged with shuffles; the two interleaved); then lane
    // u < 4 ns of the group (phone u / 2ns, lattice h, state st) forms that
    // phone's beta and, next frame, its xs: each lane reads back only its
    // own beta, so one barrier a frame (xs_n complete).
    const bool bnd = boundaries && ns > 1;
    const int gl = tid & (kCrossLanes - 1), grp = tid / kCrossLanes;
    const int ngrp = kChainThreads / kCrossLanes;
    const unsigned gmask = ((1u << kCrossLanes) - 1)
                           << ((tid & 31) & ~(kCrossLanes - 1));
    if (len >= 1 && lane == 0) fdtk::mbar_arrive(&ready[0]);
    const float* bprev = nullptr;       // beta_n (0 at n = len-1)
    int s = 1 % stages;
    unsigned ph = 0;
    for (int n = len - 1; n >= 1; --n) {
      float* slot = ring + s * slot_f;
      const float* plane = slot;
      float* xs = slot + xs_off;                   // (2 L') beta+state2
      const bool bnd_end = bnd && n == len_raw - 1;
      fdtk::mbar_wait(&full[s], ph);
      const int y = __float_as_int(slot[label_off]);
      for (int pa = grp; pa < P; pa += 2 * ngrp) {
        const int tasks = 2 * ns * (pa + ngrp < P ? 2 : 1);
        for (int u = gl; u < tasks; u += kCrossLanes) {
          const int r = u >= 2 * ns, q = u - r * 2 * ns;
          const int pi = pa + r * ngrp, h = q >= ns, st = q - h * ns;
          const int l = pi * ns + st, i = h * Lp + l;
          // state_mask(h, l, st, ...), l / clamp_ns taken as l or pi
          float mask = (bnd_end && st != ns - 1) ? kNegInf : 0.0f;
          if (h == 1 && (clamp_ns == 1 ? l : pi) != y) mask += kNegInf;
          xs[i] = (bprev ? bprev[i] : 0.0f) + plane[l] + mask;
        }
      }
      fdtk::named_sync(1, kChainThreads);          // xs_n complete
      // for source phone pi and both lattices:
      //   m_h = max(max_pj(xs_h[first(pj)] + cross[pi, pj]), NEG_INF),
      //   crossb_h = m_h + log(max(sum_pj exp(xs_h[first(pj)] +
      //              cross[pi, pj] - m_h), 1e-35)),
      //   beta_h[l] = lse3(xs_h[l] + self[l], xs_h[l+1] + adv[l] (st <
      //               ns-1), crossb_h (st == ns-1));
      // each term formed once and kept in registers for the max and the sum
      // (pb absent: pa's terms again, not stored)
      for (int pa = grp; pa < P; pa += 2 * ngrp) {
        const bool two = pa + ngrp < P;
        const int pb = two ? pa + ngrp : pa;
        const float* ca = plane + 3 * Lp + pa * P;
        const float* cb = plane + 3 * Lp + pb * P;
        float xa0[kPerLane], xa1[kPerLane], xb0[kPerLane], xb1[kPerLane];
        float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          if (k * kCrossLanes >= P) break;
          const int pj = gl + k * kCrossLanes;
          if (pj < P) {
            const float f0 = xs[pj * ns], f1 = xs[Lp + pj * ns];
            const float c = ca[pj], d = cb[pj];
            xa0[k] = f0 + c;
            xa1[k] = f1 + c;
            xb0[k] = f0 + d;
            xb1[k] = f1 + d;
            m[0] = fmaxf(m[0], xa0[k]);
            m[1] = fmaxf(m[1], xa1[k]);
            m[2] = fmaxf(m[2], xb0[k]);
            m[3] = fmaxf(m[3], xb1[k]);
          }
        }
        for (int o = kCrossLanes / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            m[v] = fmaxf(m[v], __shfl_xor_sync(gmask, m[v], o));
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) m[v] = fmaxf(m[v], kNegInf);
        float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          if (k * kCrossLanes >= P) break;
          if (gl + k * kCrossLanes < P) {
            e[0] += expf(xa0[k] - m[0]);
            e[1] += expf(xa1[k] - m[1]);
            e[2] += expf(xb0[k] - m[2]);
            e[3] += expf(xb1[k] - m[3]);
          }
        }
        for (int o = kCrossLanes / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            e[v] += __shfl_xor_sync(gmask, e[v], o);
        }
        float crossb[4];
#pragma unroll
        for (int v = 0; v < 4; ++v)
          crossb[v] = m[v] + logf(fmaxf(e[v], 1e-35f));
        if (gl == 0) {
          slot[m_off + pa] = m[0];
          slot[m_off + P + pa] = m[1];
          if (two) {
            slot[m_off + pb] = m[2];
            slot[m_off + P + pb] = m[3];
          }
        }
        const int tasks = 2 * ns * (two ? 2 : 1);
        for (int u = gl; u < tasks; u += kCrossLanes) {
          const int r = u >= 2 * ns, q = u - r * 2 * ns;
          const int pi = pa + r * ngrp, h = q >= ns, st = q - h * ns;
          const int l = pi * ns + st;
          const float* xh = xs + h * Lp;
          const float cbv = r ? (h ? crossb[3] : crossb[2])
                              : (h ? crossb[1] : crossb[0]);
          float bt;
          if (ns == 1) {
            bt = cbv;
          } else {
            const float self_c = xh[l] + plane[Lp + l];
            const float adv_c = st < ns - 1 ? xh[l + 1] + plane[2 * Lp + l]
                                            : kNegInf;
            const float cross_c = st == ns - 1 ? cbv : kNegInf;
            bt = lse3(self_c, adv_c, cross_c);
          }
          slot[beta_off + h * Lp + l] = bt;
        }
      }
      __syncwarp();
      if (lane == 0) fdtk::mbar_arrive(&ready[s]);
      bprev = slot + beta_off;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
  } else if (warp < kChainWarps + kStatWarps) {
    // The statistics, frame t from len-1 down to 0, up to a ring behind the
    // chain: the xi of the transitions into frame n = t+1 (row n) from
    // xs_n, m(n), plane n and alpha_t, and gamma_t (the state rows of row
    // t) from beta_t and alpha_t.  Each term is gated by exp(min(s - z,
    // 40)) w where its lattice lives (a dead lattice, with no legal path,
    // contributes zero gradient); the cross term's exponential splits as
    //   e_h = exp(xs_h[first(pj)] + cross[pi, pj] - m_h),
    //   g_h = exp(min(alpha_h[last(pi)] + m_h - z_h, 40)) w_h,
    //   xi[pi, pj] = sum_h e_h g_h,
    // as in the TPU kernel (which takes the max over all pi; here per pi).
    // One barrier a frame (the gates complete); the gates alternate
    // between two buffers, so a frame's gates never meet the last frame's
    // readers.
    const int sid = tid - kChainThreads;
    const float z0 = zf[b], z1 = zc[b], w0 = wf[b], w1 = wc[b];
    const bool live0 = z0 > kNegInf * 0.5f, live1 = z1 > kNegInf * 0.5f;
    int s = 0;
    unsigned ph = 0;
    for (int j = 0; j < len; ++j) {
      const int t = len - 1 - j;
      const bool has_next = j >= 1;       // frame n = t + 1 exists
      const float* slot = ring + s * slot_f;
      const float* plane = slot;
      const float* xs = slot + xs_off;
      const float* m = slot + m_off;
      const float* at = slot + alpha_off;
      fdtk::mbar_wait(&full[s], ph);
      if (has_next) fdtk::mbar_wait(&ready[s], ph);
      float* dpn = dp + (size_t)(t + 1) * R;
      float* g = gbuf + (j & 1) * 2 * P;
      if (has_next) {
        for (int i = sid; i < 2 * P; i += kStatThreads) {
          const int h = i >= P, pi = i - h * P;
          g[i] = (h ? live1 : live0)
                     ? expf(fminf(at[h * Lp + pi * ns + ns - 1] + m[i] -
                                      (h ? z1 : z0),
                                  40.0f)) *
                           (h ? w1 : w0)
                     : 0.0f;
        }
      }
      // label l (from the last thread down, beside the gates): the xi of
      // its self and advance transitions into frame n (rows Lp + l, 2 Lp +
      // l; zero at ns == 1) and gamma_t (row t, l), each summed over the two
      // lattices (beta_t = 0 where frame t+1 does not exist)
      for (int l = kStatThreads - 1 - sid; l < Lp; l += kStatThreads) {
        const bool adv_ok = ns > 1 && l % ns != ns - 1;
        float vs = 0.0f, va = 0.0f, gm = 0.0f;
        for (int h = 0; h < 2; ++h) {
          if (!(h ? live1 : live0)) continue;
          const float z = h ? z1 : z0, w = h ? w1 : w0;
          const float a = at[h * Lp + l];
          if (has_next && ns > 1) {
            const float* xh = xs + h * Lp;
            vs += expf(fminf(a + plane[Lp + l] + xh[l] - z, 40.0f)) * w;
            if (adv_ok)
              va += expf(fminf(a + plane[2 * Lp + l] + xh[l + 1] - z, 40.0f)) *
                    w;
          }
          const float bt = has_next ? slot[beta_off + h * Lp + l] : 0.0f;
          gm += expf(fminf(a + bt - z, 40.0f)) * w;
        }
        if (has_next) {
          dpn[Lp + l] = vs;
          dpn[2 * Lp + l] = va;
        }
        dp[(size_t)t * R + l] = gm;
      }
      if (has_next) {
        fdtk::named_sync(2, kStatThreads);         // the gates complete
        // the cross xi: two rows pi at a time a half-warp, lane hl the
        // columns pj = hl + 16 k (its xs in registers)
        const int hl = sid & 15, nh = kStatThreads / 16;
        float xa[kPerLane], xb[kPerLane];
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          if (k * 16 >= P) break;
          if (hl + 16 * k < P) {
            xa[k] = xs[(hl + 16 * k) * ns];
            xb[k] = xs[Lp + (hl + 16 * k) * ns];
          }
        }
        for (int pa = sid >> 4; pa < P; pa += 2 * nh) {
          const bool two = pa + nh < P;
          const int pb = two ? pa + nh : pa;
          const float* ca = plane + 3 * Lp + pa * P + hl;
          const float* cb = plane + 3 * Lp + pb * P + hl;
          float* oa = dpn + 3 * Lp + pa * P + hl;
          float* ob = dpn + 3 * Lp + pb * P + hl;
          const float ma0 = m[pa], ma1 = m[P + pa];
          const float mb0 = m[pb], mb1 = m[P + pb];
          const float ga0 = g[pa], ga1 = g[P + pa];
          const float gb0 = g[pb], gb1 = g[P + pb];
#pragma unroll
          for (int k = 0; k < kPerLane; ++k) {
            if (k * 16 >= P) break;
            if (hl + 16 * k < P) {
              const float c = ca[16 * k], d = cb[16 * k];
              const float ea0 = expf(xa[k] + c - ma0);
              const float ea1 = expf(xb[k] + c - ma1);
              const float eb0 = expf(xa[k] + d - mb0);
              const float eb1 = expf(xb[k] + d - mb1);
              // e0 g0 + e1 g1 as fma(e0, g0, e1 g1), written out so that
              // every unrolled copy rounds alike
              oa[16 * k] = __fmaf_rn(ea0, ga0, __fmul_rn(ea1, ga1));
              if (two) ob[16 * k] = __fmaf_rn(eb0, gb0, __fmul_rn(eb1, gb1));
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) fdtk::mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
  } else {
    // The feeder: ring row j gets alpha_t and, for j >= 1, the label and
    // the plane row of frame n = t+1, once the statistics have released its
    // slot; while it waits it writes the rows of dplane that are zero:
    // frames >= len (job z < T - len: row len + z) and frame 0's
    // transitions (the last job, where frame 0 exists).
    const float* pb = planes + (size_t)b * T * R4;
    const float* ab = alphas + (size_t)b * T * L2;
    const int* lab = labels + (size_t)b * T;
    const int nz = T - len + (len >= 1);
    int z = 0;
    auto zero_job = [&](int job) {
      if (job < T - len)
        warp_zero(dp + (size_t)(len + job) * R, R, lane);
      else
        warp_zero(dp + Lp, R - Lp, lane);
    };
    for (int j = 0; j < len; ++j) {
      const int s = j % stages, t = len - 1 - j;
      if (j >= stages) {
        const unsigned ph = (j / stages - 1) & 1;
        while (z < nz && !__shfl_sync(0xffffffffu,
                                      lane == 0 && fdtk::mbar_test(&empty[s],
                                                                   ph),
                                      0))
          zero_job(z++);
        fdtk::mbar_wait(&empty[s], ph);
      }
      float* slot = ring + s * slot_f;
      for (int i = lane; i < L2; i += 32)
        fdtk::cp_async4(slot + alpha_off + i, ab + (size_t)t * L2 + i);
      if (j >= 1 && lane == 0)
        fdtk::cp_async4(slot + label_off,
                        reinterpret_cast<const float*>(lab + t + 1));
      fdtk::cp_async_mbar_arrive(&full[s]);
      if (lane == 0) {
        if (j >= 1)
          fdtk::bulk_load(slot, pb + (size_t)(t + 1) * R4,
                          sizeof(float) * R4, &full[s]);
        else
          fdtk::mbar_arrive(&full[s]);
      }
    }
    while (z < nz) zero_job(z++);
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

size_t fdt_train_bwd_smem_bytes(int ns, int P, int stages) {
  return sizeof(float) * bwd_smem_floats(ns, P, stages);
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

// planes (B, T, R4) from fdt_train_plane (fdt_mma.cu); a ring of `stages`
// >= 2 plane rows (kernels/fdt_train.backward_stages)
int fdt_train_bwd(const float* planes, const int* labels, const int* lengths,
                  const float* alphas, const float* zf, const float* zc,
                  const float* wf, const float* wc, float* dplane, int B,
                  int T, int ns, int P, int clamp_ns, int boundaries,
                  int stages, void* stream) {
  const size_t smem = fdt_train_bwd_smem_bytes(ns, P, stages);
  const int err = set_smem((const void*)fdt_train_bwd_kernel, smem);
  if (err != 0) return err;
  fdt_train_bwd_kernel<<<B, kBwdThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      planes, labels, lengths, alphas, zf, zc, wf, wc, dplane, T, ns, P,
      clamp_ns, boundaries, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
