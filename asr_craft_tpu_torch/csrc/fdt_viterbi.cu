// Factored max-plus (Viterbi) decode over the frame-dependent-transition
// lattice, for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// asr_craft_tpu_torch/kernels/fdt_viterbi.py; the plain PyTorch version of
// the same function is fdt_viterbi_planes_torch in that module.
//
// Replaces the TPU kernel asr_craft_tpu/kernels/fdt_pallas.py
// fdt_viterbi_pallas, whose two pallas_calls become the two kernels here
// (the plane formation of the first, _form called at :930, is fdt_mma.cu's
// tensor-core plane kernel, launched first):
//   fdt_vit_fwd_kernel  <- _fdt_vit_fwd_kernel (max-plus forward, pruning,
//                          backpointers)
//   fdt_vit_tb_kernel   <- _fdt_vit_bwd_kernel (backpointer traceback;
//                          also the traceback of viterbi.cu's K7 and K8)
//
// Layouts.  planes (B, T, R4) f32, every frame's plane row Wall @ [x_t; 1]
// (fdt_mma.cu fdt_train_plane_kernel), rows r in [state L' | self L' | adv
// L' | cross P*P (pi-major)], all state-major (label l = phone * ns +
// state), R4 = R rounded up to 4 (the pad never read).  lengths (B,) i32.
// Outputs: bp (B, T, L') i32 holds the predecessor label of each state
// (identity at t = 0 and t >= length), last (B,) i32 / score (B,) f32 the
// final first-argmax label and score, paths (B, T) i32 the state-major
// labels.
//
// What bounds it on this card.  Time is a serial loop over an utterance's
// T frames: each frame is a chain of dependent shared-memory rounds and
// barriers (~0.8 us at the flagship), the max-plus step (self/adv
// elementwise, a P x P max with its first argmax for the cross terms) and,
// under a beam, the pruning counts.  The planes do not depend on the
// scores, so they are formed before the recursion, all frames at once, on
// the tensor cores, and stream in at 10.9 KB a frame and utterance.  One
// block an utterance fills only B of the 132 SMs (64 in the decode cell),
// and its cross max, 2,304 candidates a frame, is the longest link.
//
// What the design does about it.  Up to B = the SM count an exact decode
// runs on clusters of two blocks (CL = 2), block r owning a half of the
// destination phones and their labels (state-major, so the self and
// advance terms stay in the block and its rows of bp are one slice); the
// card takes two blocks an SM.  Larger batches (the decode CLI's
// sub-batches of up to 191) and beams run one block an utterance (CL = 1),
// on the same frame.  The frame:
//   - the plane rows come through a ring of S stages (8 where they fit):
//     one cp.async.bulk a row, .multicast::cluster to both blocks under a
//     cluster, issued by the feeder (the last thread, idle in the combine)
//     for the stage freed by the frame before;
//   - the cross max: a block's destinations along the lanes (a warp reads
//     consecutive destinations of one row pi: no bank conflict), the
//     predecessors cut into H slices of K consecutive phones (6 x 8 at the
//     flagship); a lane issues all its loads first, then takes their first
//     argmax by a tree that keeps the index order (take_right);
//   - beside it, the self, advance and state terms; barrier (B);
//   - the combine merges the H slices' argmaxes, in slice order, and
//     writes delta_t, bp and delta_t at each phone's last state, which the
//     peer's cross needs: a st.async to the peer's shared memory that
//     completes on the peer's mbarrier, no fence, no cluster barrier;
//   - barrier (A).
// So a frame waits on two barriers of its own block and, under a cluster,
// on the peer's 24 last states.  Frames past an utterance's length are not
// computed.  Measured at B=64, T=512 (PERF.md): 1.28 us a frame on the
// one-block design before, 0.72 on the cluster, 0.96 on one block.  Kept
// out of the loop: a cluster barrier with release (~0.6 us a frame: it
// fences at the cluster's scope).  Not done: the frame's fixed part (the
// waits, two barriers, the ring's refill: ~0.4 us) and the slices' merge
// through shared memory stay on the chain.
//
// Semantics held to the reference (ops/fdt.py fdt_viterbi, both packages):
// tie order self > advance > cross; the cross predecessor is the FIRST
// phone among equal maxima; the final label is the first argmax; pruning is
// threshold (keep >= max - thr, fp32) then exact top-k (keep >= the K-th
// largest, ties kept), on the initial frame too; boundaries restrict frame
// 0 to first states and frame length-1 to last states; frames t >= length
// keep the carry with identity backpointers.  All arithmetic is IEEE fp32.
//
// The traceback.  Its work is one dependent read a frame: the label of
// frame t indexes row t + 1 of the backpointers.  Read from device memory,
// each step would wait a load's latency (~0.2 us from L2, ~0.5 us from HBM
// inside a decode, where the planes stream through L2 while the forward
// writes bp).  So, as the TPU kernel streams blocks of frames into VMEM in
// descending order, one block an utterance streams its rows into a ring of
// shared-memory slots, blocks of C frames (as many as fill 32 KB, at most
// 128; C = 56 at L' = 144), top block first, by cp.async on mbarriers from
// three producer warps, up to two blocks ahead of the walk; one lane
// follows the path through the landed rows (a shared load and a clamp a
// frame), and its warp writes each block's labels out as one coalesced
// row.  The walk, not the stream, is the chain: ~30 ns a frame on an H100;
// slots of 16 KB, half the bytes in flight, were only 3-8% slower (PERF.md).

#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::block_argmax;
using fdtk::kNegInf;
using fdtk::kRedSlots;
using fdtk::round_up4;
using fdtk::take_better;

using fdtk::kTbMaxFrames;
using fdtk::kTbProducers;
using fdtk::kTbRing;
using fdtk::kTbThreads;
constexpr size_t kTbLabBytes = 4 * kTbMaxFrames;   // a block's labels

// The forward: CL blocks an utterance (one cluster) of fwd_threads(CL)
// threads, a ring of at most kMaxStages rows.
__host__ __device__ constexpr int fwd_threads(int CL) {
  return CL == 1 ? 384 : 192;
}
constexpr int kMaxStages = 16;
constexpr int kChunk = 8;           // loads in flight a cross or merge lane

// A block's cross max: its destination phones run along the lanes (a warp
// reads consecutive destinations of one row pi of the pi-major cross
// block: no bank conflict), padded to whole warps (jpad), and the
// predecessors pi are cut into H slices of K consecutive phones (slice h
// takes pi in [h K, h K + K)), whose first argmaxes the combine merges.
struct CrossShape {
  int jpad, H, K;
};

__host__ __device__ inline CrossShape cross_shape(int P, int CL) {
  const int jpad = ((P + CL - 1) / CL + 31) & ~31;
  int H = fwd_threads(CL) / jpad;
  H = H < P ? H : P;
  return {jpad, H, (P + H - 1) / H};
}

// Shared memory, in floats from a 16-byte aligned base: the ring of S
// plane rows (each R4, 16-byte aligned) | the frame's (self, advance,
// state score) of the block's labels (4 floats each) | delta (2 L') |
// delta at each phone's last state (2 P) | the beams' row (L') | the cross
// slices' (max, arg) (H jpad pairs) | red_v, red_i | S + 3 8-byte
// mbarriers (the ring's stages; the peer's last states by frame parity;
// the peer's last row).
struct FwdLayout {
  int pre, dbuf, last, cand, part, red, bar, floats;
};

__host__ __device__ inline FwdLayout fwd_layout(int ns, int P, int S,
                                                int CL) {
  const int Lp = ns * P;
  const CrossShape c = cross_shape(P, CL);
  FwdLayout f;
  f.pre = S * round_up4(3 * Lp + P * P);
  f.dbuf = f.pre + 4 * ns * ((P + CL - 1) / CL);
  f.last = f.dbuf + 2 * Lp;
  f.cand = f.last + 2 * P;
  f.part = (f.cand + Lp + 1) & ~1;
  f.red = f.part + 2 * c.H * c.jpad;
  f.bar = (f.red + 2 * kRedSlots + 1) & ~1;
  f.floats = f.bar + 2 * (S + 3);
  return f;
}

// (v, i) := the better of (v, i) and (v2, i2) where every index of the
// second is above the first's: the second only if strictly larger, so
// ties keep the lower index, as take_better does.
__device__ __forceinline__ void take_right(float& v, int& i, float v2,
                                           int i2) {
  const bool r = v2 > v;
  v = r ? v2 : v;
  i = r ? i2 : i;
}

// The first argmax of n = kChunk pairs (v[k], i[k]) in index order, by a
// tree of take_right.
__device__ __forceinline__ void chunk_argmax(float (&v)[kChunk],
                                             int (&i)[kChunk]) {
#pragma unroll
  for (int w = 1; w < kChunk; w *= 2)
#pragma unroll
    for (int k = 0; k + w < kChunk; k += 2 * w)
      take_right(v[k], i[k], v[k + w], i[k + w]);
}

// This block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// The address of this block's shared `p` in the shared memory of block
// `rank` of the cluster (the same offset).
__device__ __forceinline__ unsigned peer_smem(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(fdtk::smem_addr(p)), "r"(rank));
  return a;
}

// v to the peer's shared memory at `addr`, counted (4 bytes) on the peer's
// mbarrier at `bar`: the peer sees it once that barrier's phase completes,
// with no fence on either side.
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// This block's barrier `bar` expects `bytes` more in its current phase (one
// arrival of the count of 1 it was initialised with).
__device__ __forceinline__ void expect_bytes(unsigned long long* bar,
                                             unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          fdtk::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Every thread of the cluster meets here.  release: what any wrote before,
// to either block's shared memory, is seen after (a fence at the cluster's
// scope: used once, after the barriers' initialisation); relaxed: no
// ordering (before the blocks exit).
template <bool RELEASE>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (RELEASE)
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// One thread of each block of the cluster: expect a row of `bytes` on this
// block's `bar`; rank 0's thread also copies it from global memory, once,
// to the offset `dst` of every block of the cluster (cp.async.bulk
// .multicast::cluster), each block's `bar` counting what lands in it.  A
// block's count may land before its expectation: the phase completes on
// both.
template <int CL>
__device__ __forceinline__ void fetch_row(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar, int rank) {
  if constexpr (CL == 1) {
    fdtk::bulk_load(dst, src, bytes, bar);
  } else {
    expect_bytes(bar, bytes);
    if (rank == 0) {
      const unsigned short mask = (1u << CL) - 1;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
              fdtk::smem_addr(dst)),
          "l"(src), "r"(bytes), "r"(fdtk::smem_addr(bar)), "h"(mask)
          : "memory");
    }
  }
}

// Two blocks an SM: the cluster path runs up to one utterance an SM, the
// block path's sub-batches of up to 191 utterances fit the card at once.
template <int CL>
__global__ void __launch_bounds__(fwd_threads(CL), 2)
fdt_vit_fwd_kernel(const float* __restrict__ planes,
                   const int* __restrict__ lengths, int* __restrict__ bp,
                   int* __restrict__ last_out, float* __restrict__ score_out,
                   int T, int ns, int P, int boundaries, int use_thr,
                   float thr, int bw, int S) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int Lp = ns * P, R4 = round_up4(3 * Lp + P * P);
  const FwdLayout f = fwd_layout(ns, P, S, CL);
  const CrossShape cs = cross_shape(P, CL);
  float* ring = sm;                                      // (S, R4) planes
  float4* pre = reinterpret_cast<float4*>(sm + f.pre);   // (l1 - l0)
  float* dbuf = sm + f.dbuf;                             // (2, L') scores
  float* lastrow = sm + f.last;                          // (2, P)
  float* cand = sm + f.cand;                             // (L') beams' row
  float2* part = reinterpret_cast<float2*>(sm + f.part); // (H, jpad)
  float* red_v = sm + f.red;
  int* red_i = reinterpret_cast<int*>(red_v + kRedSlots);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(sm + f.bar); // (S) one a stage
  unsigned long long* xbar = full + S;    // (2) the peer's last states
  unsigned long long* fin = xbar + 2;     // the peer's last row

  const int rank = CL == 1 ? 0 : cluster_rank();
  const int b = blockIdx.x / CL;
  // this block's phones [p0, p1) and their labels [l0, l1)
  const int half = (P + CL - 1) / CL;
  const int p0 = min(rank * half, P), p1 = min(p0 + half, P);
  const int l0 = ns * p0, l1 = ns * p1;
  const int len_raw = lengths[b];
  const int len = min(max(len_raw, 0), T);
  const float* pb = planes + (size_t)b * T * R4;
  int* bpb = bp + (size_t)b * T * Lp;
  const bool bnd = boundaries && ns > 1;
  const bool beams = use_thr || bw > 0;
  const unsigned row_bytes = sizeof(float) * R4;
  // this thread's cross slice: destination p0 + cj, pi in [lo, hi)
  const int cj = tid % cs.jpad, ch = tid / cs.jpad;
  const bool crosser = ch < cs.H && p0 + cj < p1;
  const int lo = min(ch * cs.K, P), hi = min(lo + cs.K, P);
  // the feeder keeps the ring full and arms the peer's barrier: the last
  // thread, idle in the combine while there are fewer labels than threads
  const bool feeder = tid == nth - 1;
  // the peer's rows of last states, its delta rows and their barriers
  unsigned peer_last = 0, peer_d = 0, peer_x = 0, peer_fin = 0;
  if constexpr (CL > 1) {
    peer_last = peer_smem(lastrow, rank ^ 1);
    peer_d = peer_smem(dbuf, rank ^ 1);
    peer_x = peer_smem(xbar, rank ^ 1);
    peer_fin = peer_smem(fin, rank ^ 1);
  }
  // fn(l, phone, state) for each of this thread's labels of the block
  const int step_p = nth / ns, step_s = nth % ns;
  const int first_p = (l0 + tid) / ns, first_s = (l0 + tid) % ns;
  auto own = [&](auto&& fn) {
    int p = first_p, st = first_s;
    for (int l = l0 + tid; l < l1; l += nth) {
      fn(l, p, st);
      p += step_p;
      st += step_s;
      if (st >= ns) {
        st -= ns;
        ++p;
      }
    }
  };
  // the frame's delta at phone p's last state, here and in the peer
  auto publish = [&](int cur, int p, float v) {
    lastrow[cur * P + p] = v;
    if constexpr (CL > 1)
      st_async(peer_last + 4 * (cur * P + p), v, peer_x + 8 * cur);
  };

  // frame 0 always runs (a length-0 row still reports its initial max)
  const int tend = max(len, 1);
  if (tid == 0)
    for (int s = 0; s < S + 3; ++s) fdtk::mbar_init(&full[s], 1);
  if constexpr (CL > 1)
    cluster_barrier<true>();            // every block's barriers initialised
  else
    __syncthreads();
  if (feeder) {
    for (int t = 0; t < min(S, tend); ++t)
      fetch_row<CL>(ring + t * R4, pb + (size_t)t * R4, row_bytes, &full[t],
                    rank);
    if (CL > 1) {
      const unsigned peer_phones = P - (p1 - p0);
      expect_bytes(&xbar[0], sizeof(float) * peer_phones);
      if (tend > 1) expect_bytes(&xbar[1], sizeof(float) * peer_phones);
      if (rank == 0) expect_bytes(fin, sizeof(float) * ns * peer_phones);
    }
  }
  int s = 0, ring_phase = 0;            // frame t's stage, its phase parity
  for (int t = 0; t < tend; ++t) {
    const int cur = t & 1;
    const float* plane = ring + s * R4;
    const float* d = dbuf + (cur ^ 1) * Lp;              // delta_t-1
    float* dn = dbuf + cur * Lp;                         // delta_t
    fdtk::mbar_wait(&full[s], ring_phase);
    // the peer's last states of delta_t-1: its (t - 1) / 2-th row on
    // xbar[t-1 & 1]
    if (CL > 1 && t > 0) fdtk::mbar_wait(&xbar[cur ^ 1], ((t - 1) >> 1) & 1);
    const bool at_end = t == len_raw - 1;
    if (t == 0) {
      own([&](int l, int p, int st) {
        float v = plane[l];
        if (bnd) {
          v += st == 0 ? 0.0f : kNegInf;                       // start
          v += (at_end && st != ns - 1) ? kNegInf : 0.0f;      // end
        }
        dn[l] = v;
        bpb[l] = l;
        if (st == ns - 1 && !beams) publish(cur, p, v);
      });
    } else {
      // cross: max over predecessor phones pi of delta[last(pi)] +
      // cross[pi, pj].  A slice reads kChunk candidates at a time, every
      // load issued before the first comparison, and takes their first
      // argmax by a tree that keeps the index order: a NaN candidate
      // counts as -inf, and one past the slice is read as a copy of the
      // slice's last, which never wins against it (ties keep the left);
      // the state (-inf, 0) stands left of all, as take_better's start
      if (crosser) {
        const float* cr = plane + 3 * Lp + p0 + cj;
        const float* dl = lastrow + (cur ^ 1) * P;
        float mv = -INFINITY;
        int ma = 0;
        for (int pi0 = lo; pi0 < hi; pi0 += kChunk) {
          float v[kChunk];
          int ix[kChunk];
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            const int pi = min(pi0 + k, hi - 1);
            v[k] = fmaxf(dl[pi] + cr[pi * P], -INFINITY);
            ix[k] = pi0 + k;
          }
          chunk_argmax(v, ix);
          take_right(mv, ma, v[0], ix[0]);
        }
        part[ch * cs.jpad + cj] = make_float2(mv, __int_as_float(ma));
      }
      // the self and advance terms and the state score, which need no
      // cross max, while the slices run
      own([&](int l, int, int st) {
        float self_c = kNegInf, adv_c = kNegInf;
        if (ns > 1) {
          self_c = d[l] + plane[Lp + l];
          adv_c = st > 0 ? d[l - 1] + plane[2 * Lp + l - 1] : kNegInf;
        }
        float sc = plane[l];
        if (bnd) sc += (at_end && st != ns - 1) ? kNegInf : 0.0f;
        pre[l - l0] = make_float4(self_c, adv_c, sc, 0.0f);
      });
      __syncthreads();                  // (B) the cross slices complete
      if (feeder) {
        // every thread of the cluster is done with plane t - 1 (this
        // block's since the last frame's barrier, the peer's since its
        // last states of delta_t-1 landed): its stage takes frame t - 1 +
        // S; and every thread has waited for those, so their barrier may
        // expect delta_t+1's
        const int done = s == 0 ? S - 1 : s - 1;
        if (t - 1 + S < tend)
          fetch_row<CL>(ring + done * R4, pb + (size_t)(t - 1 + S) * R4,
                        row_bytes, &full[done], rank);
        if (CL > 1 && t + 1 < tend)
          expect_bytes(&xbar[cur ^ 1], sizeof(float) * (P - (p1 - p0)));
      }
      own([&](int l, int p, int st) {
        const float4 q = pre[l - l0];   // self, advance, state score
        float cm = -INFINITY;
        int ca = 0;
        if (st == 0) {
          // the slices' first argmaxes in slice order, every load before
          // the merge (past H: a copy of the last slice's, which never
          // wins against it)
          const float2* pp = part + (p - p0);
          for (int h0 = 0; h0 < cs.H; h0 += kChunk) {
            float v[kChunk];
            int ix[kChunk];
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
              const float2 x = pp[min(h0 + k, cs.H - 1) * cs.jpad];
              v[k] = x.x;
              ix[k] = __float_as_int(x.y);
            }
            chunk_argmax(v, ix);
            take_right(cm, ca, v[0], ix[0]);
          }
        }
        float best;
        int from;
        if (ns == 1) {
          best = cm;
          from = ca;
        } else {
          const float cross_c = st == 0 ? cm : kNegInf;
          best = fmaxf(fmaxf(q.x, q.y), cross_c);
          from = q.x == best  ? l
                 : q.y == best ? l - 1
                               : ca * ns + ns - 1;
        }
        const float v = best + q.z;
        dn[l] = v;
        bpb[(size_t)t * Lp + l] = from;
        if (st == ns - 1 && !beams) publish(cur, p, v);
      });
    }

    if constexpr (CL == 1) {            // the cluster takes no beams
      if (use_thr) {
        // each thread reads only its own labels before block_argmax's
        // barriers, and prunes them after
        float m = -INFINITY;
        int unused = 0;
        own([&](int l, int, int) { m = fmaxf(m, dn[l]); });
        block_argmax(m, unused, red_v, red_i);
        const float floor_v = m - thr;
        own([&](int l, int, int) {
          if (!(dn[l] >= floor_v)) dn[l] = kNegInf;
        });
      }
      if (bw > 0) {
        // top-k: v survives iff fewer than bw values of the frame's row
        // are strictly greater, which is exactly v >= (the bw-th largest
        // value), ties kept; the row is read from cand
        own([&](int l, int, int) { cand[l] = dn[l]; });
        __syncthreads();                // the frame's row complete
        own([&](int l, int, int) {
          const float v = cand[l];
          int above = 0;
          for (int j = 0; j < Lp; ++j) above += cand[j] > v;
          dn[l] = above >= bw ? kNegInf : v;
        });
      }
      if (beams)
        own([&](int l, int p, int st) {
          if (st == ns - 1) publish(cur, p, dn[l]);
        });
    }
    __syncthreads();                    // (A) this block's delta_t whole
    if (++s == S) {
      s = 0;
      ring_phase ^= 1;
    }
  }
  const int cur = (tend - 1) & 1;
  const float* dlast = dbuf + cur * Lp;
  if constexpr (CL > 1) {
    // the peer's last states of the last frame, then rank 1's last row to
    // rank 0; after that no block's shared memory is written, and both may
    // exit
    fdtk::mbar_wait(&xbar[cur], ((tend - 1) >> 1) & 1);
    if (rank == 1)
      own([&](int l, int, int) {
        st_async(peer_d + 4 * (cur * Lp + l), dlast[l], peer_fin);
      });
    else
      fdtk::mbar_wait(fin, 0);
    cluster_barrier<false>();
  }

  for (size_t i = (size_t)tend * Lp + rank * nth + tid; i < (size_t)T * Lp;
       i += CL * nth)
    bpb[i] = (int)(i % Lp);

  if (rank == 0) {
    // rank 0 holds the whole last row: its first argmax
    float v = -INFINITY;
    int a = INT_MAX;
    for (int l = tid; l < Lp; l += nth) take_better(v, a, dlast[l], l);
    block_argmax(v, a, red_v, red_i);
    if (tid == 0) {
      score_out[b] = v;
      last_out[b] = a;
    }
  }
}

// The traceback: one block an utterance (fdt_common.cuh's stream).  The
// label of frame t is clamp(bp[t + 1][label of t + 1]), frames t >= end =
// min(length, T) - 1 carry the final label and read no row, so the stream
// holds rows 1..end, in blocks of C frames: block k the rows of frames
// [kC, min(kC + C, end)), i.e. rows kC + 1 .. min(kC + C, end).  Lane 0 of
// warp 0 walks a landed block in shared memory, its labels go to a shared
// row, and the warp writes them out as one coalesced row of the path.
__global__ void __launch_bounds__(kTbThreads)
fdt_vit_tb_kernel(const int* __restrict__ bp, const int* __restrict__ last,
                  const int* __restrict__ lengths, int* __restrict__ paths,
                  int T, int Lp, int C) {
  extern __shared__ float4 tb_smem4[];
  const size_t slot = fdtk::tb_slot(C, Lp);
  int* ring = reinterpret_cast<int*>(tb_smem4);           // (kTbRing, slot)
  int* lab = ring + kTbRing * slot;                       // (kTbMaxFrames)
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(lab + kTbMaxFrames);
  unsigned long long* empty = full + kTbRing;

  const int b = blockIdx.x, tid = threadIdx.x;
  // A lattice of NaN scores wins no comparison, so its argmaxes may hold any
  // value: every label is clamped into range before it indexes a row.
  const int lst = min(max(last[b], 0), Lp - 1);
  const int end = min(lengths[b], T) - 1;
  const int nblk = end > 0 ? (end + C - 1) / C : 0;
  const int* bpb = bp + (size_t)b * T * Lp;
  if (tid == 0)
    for (int s = 0; s < kTbRing; ++s) {
      fdtk::mbar_init(&full[s], kTbProducers);
      fdtk::mbar_init(&empty[s], 1);
    }
  __syncthreads();                      // the barriers initialised

  if (tid >= 32) {                      // the stream, top block first
    for (int i = 0; i < nblk; ++i) {
      const int f0 = (nblk - 1 - i) * C, n = min(f0 + C, end) - f0;
      const int s = i % kTbRing;
      if (i >= kTbRing) fdtk::mbar_wait(&empty[s], (i / kTbRing - 1) & 1);
      fdtk::tb_stream(ring + s * slot, bpb + (size_t)(f0 + 1) * Lp, n * Lp,
                      tid - 32);
      fdtk::cp_async_mbar_arrive(&full[s]);
    }
    fdtk::cp_async_wait<0>();
    return;
  }

  int* pb = paths + (size_t)b * T;
  for (int t = max(end, 0) + tid; t < T; t += 32) pb[t] = lst;
  int cur = lst;
  for (int i = 0; i < nblk; ++i) {
    const int f0 = (nblk - 1 - i) * C, n = min(f0 + C, end) - f0;
    const int s = i % kTbRing;
    const int* src = bpb + (size_t)(f0 + 1) * Lp;
    fdtk::mbar_wait(&full[s], (i / kTbRing) & 1);
    if (tid == 0) {
      const int* row = ring + s * slot + fdtk::tb_align(src) + n * Lp;
      for (int j = n - 1; j >= 0; --j) {  // frame f0 + j reads row f0 + j + 1
        row -= Lp;
        cur = __vimin_s32_relu(row[cur], Lp - 1);  // max(min(., Lp-1), 0)
        lab[j] = cur;
      }
      fdtk::mbar_arrive(&empty[s]);
    }
    __syncwarp();
    for (int j = tid; j < n; j += 32) pb[f0 + j] = lab[j];
    __syncwarp();                       // lab read before the next block
  }
}

}  // namespace

extern "C" {

// The forward's shared memory: S plane rows in its ring, `cluster` blocks
// an utterance (1 or 2).
size_t fdt_viterbi_fwd_smem_bytes(int ns, int P, int stages, int cluster) {
  return sizeof(float) * fwd_layout(ns, P, stages, cluster).floats;
}

const char* fdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// planes (B, T, R4) from fdt_train_plane (fdt_mma.cu); P <= 128.  cluster
// 1: one block an utterance; 2: a cluster of two blocks an utterance, each
// block half of its phones (exact decodes only: no beam).  stages: the
// ring's plane rows (2 to kMaxStages; frame t's stage is refilled during
// frame t + 1).
int fdt_viterbi_fwd(const float* planes, const int* lengths, int* bp,
                    int* last, float* score, int B, int T, int ns, int P,
                    int boundaries, int use_thr, float thr, int bw,
                    int stages, int cluster, void* stream) {
  if ((cluster != 1 && cluster != 2) || stages < 2 ||
      stages > kMaxStages || (cluster == 2 && (use_thr || bw > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fdt_viterbi_fwd_smem_bytes(ns, P, stages, cluster);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 1) {
    cudaError_t err = fdtk::opt_in(fdt_vit_fwd_kernel<1>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fdt_vit_fwd_kernel<1><<<B, fwd_threads(1), smem, s>>>(
        planes, lengths, bp, last, score, T, ns, P, boundaries, use_thr, thr,
        bw, stages);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = fdtk::opt_in(fdt_vit_fwd_kernel<2>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * B);
  cfg.blockDim = dim3(fwd_threads(2));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fdt_vit_fwd_kernel<2>, planes, lengths, bp,
                           last, score, T, ns, P, boundaries, use_thr, thr,
                           bw, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The frames C of a traceback stream block at L' = Lp (0: one frame does
// not fit a block's shared memory).
int fdt_viterbi_traceback_frames(int Lp) {
  return fdtk::tb_frames(Lp, 1, kTbLabBytes);
}

// paths (B, T) from bp (B, T, L'), last and lengths (B,): one block an
// utterance
int fdt_viterbi_traceback(const int* bp, const int* last, const int* lengths,
                          int* paths, int B, int T, int Lp, void* stream) {
  const int C = fdt_viterbi_traceback_frames(Lp);
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fdtk::tb_bytes(C, Lp, 1, kTbLabBytes);
  cudaError_t err = fdtk::opt_in(fdt_vit_tb_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fdt_vit_tb_kernel<<<B, kTbThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      bp, last, lengths, paths, T, Lp, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
