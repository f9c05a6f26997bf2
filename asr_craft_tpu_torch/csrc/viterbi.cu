// Max-plus (Viterbi) decode over a SHARED transition matrix, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// asr_craft_tpu_torch/kernels/viterbi.py; the plain PyTorch version of both
// kernels is asr_craft_tpu_torch/ops/viterbi.py viterbi_forward on the dense
// (topology-masked) trans.
//
// Replaces the forward kernels of asr_craft_tpu/kernels/viterbi_pallas.py:
//   vit_dense_fwd_kernel   <- _vit_fwd_kernel (K7, viterbi_pallas): dense
//                             max-plus over a shared (L, L) trans, with the
//                             _beam_mask pruning
//   vit_nstate_fwd_kernel  <- _vit_fwd_nstate_kernel (K8,
//                             viterbi_pallas_nstate): the topology-factored
//                             n-state step (self, advance, P x P cross)
// The TPU kernels store the per-frame deltas and re-derive backpointers in a
// second kernel (_vit_bwd_kernel) because an argmax on the VPU was slow.
// Here the thread that owns destination label l keeps the argmax beside the
// max, so both kernels write backpointers in the forward pass, and the
// traceback is fdt_viterbi.cu's fdt_vit_tb_kernel, unchanged.
//
// Layouts (batch-major, as models.crf.potentials returns them).  state
// (B, T, L) f32, boundary masking already folded in; trans (L, L) f32, row =
// predecessor; lengths (B,) i32.  Outputs: bp (B, T, L) i32, the predecessor
// of each label (identity at t = 0 and t >= length), last (B,) i32 and
// score (B,) f32, the final first argmax and its value.  The n-state kernel
// also takes the legal-transition weights, state-major (l = q * ns + s):
// w_self (L), w_adv (L) (w_adv[l] = trans[l-1, l] for s > 0) and w_cross
// (P, P) (w_cross[q', q] = trans[q' * ns + ns - 1, q * ns]).
//
// What bounds them on this card.  Time is a serial loop: one block owns one
// utterance and walks its frames, each frame a dependent max-plus step.  At
// the configs' widths (L = 48, 42; L' = 138) the work per frame is small
// (L^2 = 2,304 pairs at L = 48) and the time is the latency of the frame
// chain: the loads and compares of each destination's running max over its
// predecessors, plus the block's barriers.  So each destination's
// predecessor loop is split over kGroup lanes of a warp (lane g takes p = g,
// g + kGroup, ...), whose (max, first argmax) pairs are merged with
// shuffles; the next frame's state potential is loaded before the loop, so
// its latency hides behind it.  The dense kernel keeps trans in shared
// memory when it fits (L <= 240: 83 KB at L = 144, opted into dynamically)
// and otherwise reads it from global memory, where it stays L2-resident
// (L' = 390: 608 KB); lanes on consecutive l read consecutive addresses of
// row p.  The n-state kernel does O(L') work for self/advance and O(P^2)
// for the cross max per frame instead of O(L'^2), with w_cross (at most
// 64 KB) in shared memory.  Frames past a row's length are not computed.
// Not done yet: several utterances per block at small L.
//
// Semantics held to the reference (ops/viterbi.py, the JAX XLA path).
// Every backpointer and the final label are the FIRST argmax in
// expanded-label order.  In the n-state kernel that order decides ties
// between legal predecessors: for s > 0, advance (l-1) before self (l); for
// s = 0, cross from phones q' < q, then self, then cross from q' >= q.
// Illegal predecessors carry the topology penalty NEG_INF in trans, so they
// lose to any live legal candidate; a destination whose legal best is dead
// (<= NEG_INF / 2: its legal predecessors were masked or pruned) is
// re-scanned densely over all L' predecessors through trans, so the dead
// states get the dense kernel's values and backpointers too.  Exact as long
// as |delta| + |trans| stay below 5e29 on live entries.  Pruning is
// threshold (keep >= max - thr, fp32), then exact top-k (keep >= the K-th
// largest, ties kept), on frame 0 too.  All arithmetic is IEEE fp32.

#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::block_argmax;
using fdtk::kNegInf;
using fdtk::kRedSlots;
using fdtk::take_better;

constexpr int kMaxThreads = 512;
constexpr int kGroup = 4;               // lanes per destination's max
constexpr float kDeadFloor = 0.5f * kNegInf;
constexpr size_t kSmemLimit = 232448;   // bytes a Hopper block may opt into

// n work items (kGroup lanes each, or one thread each), in whole warps
int threads_for(int n) {
  n = (n + 31) / 32 * 32;
  return n < 64 ? 64 : (n > kMaxThreads ? kMaxThreads : n);
}

size_t dense_tail_floats(int L) {
  return 2 * (size_t)L + 2 * kRedSlots;
}

// trans goes to shared memory when it fits beside the rest (L <= 240)
bool dense_trans_in_smem(int L) {
  const size_t floats = (size_t)L * L + dense_tail_floats(L);
  return sizeof(float) * floats <= kSmemLimit;
}

size_t dense_smem_floats(int L) {
  return (dense_trans_in_smem(L) ? (size_t)L * L : 0) + dense_tail_floats(L);
}

size_t nstate_smem_floats(int ns, int P) {
  const size_t L = (size_t)ns * P;
  // w_cross | w_self | w_adv | delta | cand | mrun | arun | red
  return (size_t)P * P + 4 * L + 2 * (size_t)P + 2 * kRedSlots;
}

// delta := prune(cand): threshold (keep cand >= max - thr), then top-k (a
// value survives iff fewer than bw values are strictly greater, which is
// exactly value >= the bw-th largest, ties kept).  cand is overwritten by
// the threshold.  Ends with a barrier.
__device__ void prune_into(float* cand, float* delta, int L, int use_thr,
                           float thr, int bw, float* red_v, int* red_i) {
  const int tid = threadIdx.x, nth = blockDim.x;
  if (use_thr) {
    float m = -INFINITY;
    int unused = 0;
    for (int l = tid; l < L; l += nth) m = fmaxf(m, cand[l]);
    block_argmax(m, unused, red_v, red_i);
    const float floor_v = m - thr;
    for (int l = tid; l < L; l += nth)
      if (!(cand[l] >= floor_v)) cand[l] = kNegInf;
    __syncthreads();
  }
  for (int l = tid; l < L; l += nth) {
    float v = cand[l];
    if (bw > 0) {
      int above = 0;
      for (int j = 0; j < L; ++j) above += cand[j] > v;
      if (above >= bw) v = kNegInf;
    }
    delta[l] = v;
  }
  __syncthreads();
}

// Frame 0 (identity backpointers, pruned initial scores) for a block's row.
__device__ void first_frame(const float* sb, int* bpb, float* cand,
                            float* delta, int L, int use_thr, float thr,
                            int bw, float* red_v, int* red_i) {
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    cand[l] = sb[l];
    bpb[l] = l;
  }
  __syncthreads();
  prune_into(cand, delta, L, use_thr, thr, bw, red_v, red_i);
}

// Identity backpointers past the last computed frame, then the final first
// argmax of delta.
__device__ void finish(const float* delta, int* bpb, int tend, int T, int L,
                       float* red_v, int* red_i, float* score_out,
                       int* last_out) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (size_t i = (size_t)tend * L + tid; i < (size_t)T * L; i += nth)
    bpb[i] = (int)(i % L);
  float v = -INFINITY;
  int a = INT_MAX;
  for (int l = tid; l < L; l += nth) take_better(v, a, delta[l], l);
  block_argmax(v, a, red_v, red_i);
  if (tid == 0) {
    score_out[blockIdx.x] = v;
    last_out[blockIdx.x] = a;
  }
}

// Merge the (max, first argmax) pairs of a group's kGroup lanes; every
// lane of the group gets the result.  All lanes of the warp must call it.
__device__ __forceinline__ void group_argmax(float& v, int& i) {
  for (int o = 1; o < kGroup; o <<= 1)
    take_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
                __shfl_xor_sync(0xffffffffu, i, o));
}

// This lane's (max, first argmax) over p = g, g + kGroup, ... < n of
// a[p * sa] + b[p * sb]: strict '>' in p order keeps the lane's first.
__device__ __forceinline__ void lane_max(const float* a, int sa,
                                         const float* b, int sb, int n,
                                         int g, float& best, int& from) {
  best = -INFINITY;
  from = INT_MAX;
#pragma unroll 4
  for (int p = g; p < n; p += kGroup) {
    const float v = a[(size_t)p * sa] + b[(size_t)p * sb];
    if (v > best) {
      best = v;
      from = p;
    }
  }
}

// One thread's (max, first argmax) over all p of delta[p] + tr[p * L + l]:
// the n-state kernel's dense re-scan of a dead destination.
__device__ void dense_column(const float* delta, const float* tr, int L,
                             int l, float& best, int& from) {
  best = delta[0] + tr[l];
  from = 0;
  for (int p = 1; p < L; ++p) {
    const float v = delta[p] + tr[(size_t)p * L + l];
    if (v > best) {
      best = v;
      from = p;
    }
  }
}

// kSmemTrans: trans is copied to shared memory (dense_trans_in_smem(L)).
template <bool kSmemTrans>
__global__ void __launch_bounds__(kMaxThreads)
vit_dense_fwd_kernel(const float* __restrict__ state,
                     const float* __restrict__ trans,
                     const int* __restrict__ lengths, int* __restrict__ bp,
                     int* __restrict__ last_out, float* __restrict__ score_out,
                     int T, int L, int use_thr, float thr, int bw) {
  extern __shared__ float smem[];
  float* delta = smem + (kSmemTrans ? (size_t)L * L : 0);
  float* cand = delta + L;
  float* red_v = cand + L;
  int* red_i = reinterpret_cast<int*>(red_v + kRedSlots);
  const int tid = threadIdx.x, nth = blockDim.x;
  if (kSmemTrans)
    for (int i = tid; i < L * L; i += nth) smem[i] = trans[i];
  const float* tr = kSmemTrans ? smem : trans;
  const int g = tid % kGroup, slot = tid / kGroup, nslots = nth / kGroup;

  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* sb = state + (size_t)b * T * L;
  int* bpb = bp + (size_t)b * T * L;

  first_frame(sb, bpb, cand, delta, L, use_thr, thr, bw, red_v, red_i);
  for (int t = 1; t < len; ++t) {
    // a uniform loop, so every lane reaches the group's shuffles
    for (int l0 = 0; l0 < L; l0 += nslots) {
      const int l = l0 + slot;
      const bool mine = l < L && g == 0;
      const float s_t = mine ? sb[(size_t)t * L + l] : 0.0f;
      float best;
      int from;
      lane_max(delta, 1, tr + (l < L ? l : 0), L, l < L ? L : 0, g, best,
               from);
      group_argmax(best, from);
      if (mine) {
        cand[l] = best + s_t;
        bpb[(size_t)t * L + l] = from;
      }
    }
    __syncthreads();
    prune_into(cand, delta, L, use_thr, thr, bw, red_v, red_i);
  }
  finish(delta, bpb, max(len, 1), T, L, red_v, red_i, score_out, last_out);
}

__global__ void __launch_bounds__(kMaxThreads)
vit_nstate_fwd_kernel(const float* __restrict__ state,
                      const float* __restrict__ trans,
                      const float* __restrict__ w_self_g,
                      const float* __restrict__ w_adv_g,
                      const float* __restrict__ w_cross_g,
                      const int* __restrict__ lengths, int* __restrict__ bp,
                      int* __restrict__ last_out,
                      float* __restrict__ score_out, int T, int ns, int P,
                      int use_thr, float thr, int bw) {
  extern __shared__ float smem[];
  const int L = ns * P;
  float* w_cross = smem;                       // (P, P)
  float* w_self = w_cross + P * P;             // (L)
  float* w_adv = w_self + L;                   // (L)
  float* delta = w_adv + L;                    // (L) carry
  float* cand = delta + L;                     // (L) new scores
  float* mrun = cand + L;                      // (P) best cross into q
  int* arun = reinterpret_cast<int*>(mrun + P);  // (P) its first phone q'
  float* red_v = reinterpret_cast<float*>(arun + P);
  int* red_i = reinterpret_cast<int*>(red_v + kRedSlots);
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < P * P; i += nth) w_cross[i] = w_cross_g[i];
  for (int l = tid; l < L; l += nth) {
    w_self[l] = w_self_g[l];
    w_adv[l] = w_adv_g[l];
  }

  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* sb = state + (size_t)b * T * L;
  int* bpb = bp + (size_t)b * T * L;

  const int g = tid % kGroup, slot = tid / kGroup, nslots = nth / kGroup;
  first_frame(sb, bpb, cand, delta, L, use_thr, thr, bw, red_v, red_i);
  for (int t = 1; t < len; ++t) {
    // cross into each phone's first state: max over q' of delta[last(q')]
    // + w_cross[q', q], first argmax in q' order (a uniform loop, so every
    // lane reaches the group's shuffles)
    for (int q0 = 0; q0 < P; q0 += nslots) {
      const int q = q0 + slot;
      float m;
      int a;
      lane_max(delta + ns - 1, ns, w_cross + (q < P ? q : 0), P,
               q < P ? P : 0, g, m, a);
      group_argmax(m, a);
      if (q < P && g == 0) {
        mrun[q] = m;
        arun[q] = a;
      }
    }
    __syncthreads();
    for (int l = tid; l < L; l += nth) {
      const int s = l % ns, q = l / ns;
      const float self_c = delta[l] + w_self[l];
      float best;
      int from;
      if (s == 0) {
        // cross from q' < q precedes self (index q*ns) in expanded order
        const float cm = mrun[q];
        const int ca = arun[q];
        if (cm > self_c || (cm == self_c && ca < q)) {
          best = cm;
          from = ca * ns + ns - 1;
        } else {
          best = self_c;
          from = l;
        }
      } else {
        // advance (l - 1) precedes self (l)
        const float adv_c = delta[l - 1] + w_adv[l];
        if (self_c > adv_c) {
          best = self_c;
          from = l;
        } else {
          best = adv_c;
          from = l - 1;
        }
      }
      if (!(best > kDeadFloor)) dense_column(delta, trans, L, l, best, from);
      cand[l] = best + sb[(size_t)t * L + l];
      bpb[(size_t)t * L + l] = from;
    }
    __syncthreads();
    prune_into(cand, delta, L, use_thr, thr, bw, red_v, red_i);
  }
  finish(delta, bpb, max(len, 1), T, L, red_v, red_i, score_out, last_out);
}

}  // namespace

extern "C" {

size_t viterbi_dense_smem_bytes(int L) {
  return sizeof(float) * dense_smem_floats(L);
}

size_t viterbi_nstate_smem_bytes(int ns, int P) {
  return sizeof(float) * nstate_smem_floats(ns, P);
}

int viterbi_dense_fwd(const float* state, const float* trans,
                      const int* lengths, int* bp, int* last, float* score,
                      int B, int T, int L, int use_thr, float thr, int bw,
                      void* stream) {
  const size_t smem = viterbi_dense_smem_bytes(L);
  auto kernel = dense_trans_in_smem(L) ? vit_dense_fwd_kernel<true>
                                       : vit_dense_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads_for(L * kGroup), smem,
           static_cast<cudaStream_t>(stream)>>>(
      state, trans, lengths, bp, last, score, T, L, use_thr, thr, bw);
  return static_cast<int>(cudaGetLastError());
}

int viterbi_nstate_fwd(const float* state, const float* trans,
                       const float* w_self, const float* w_adv,
                       const float* w_cross, const int* lengths, int* bp,
                       int* last, float* score, int B, int T, int ns, int P,
                       int use_thr, float thr, int bw, void* stream) {
  const size_t smem = viterbi_nstate_smem_bytes(ns, P);
  cudaError_t err = cudaFuncSetAttribute(
      vit_nstate_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = ns * P > P * kGroup ? ns * P : P * kGroup;
  vit_nstate_fwd_kernel<<<B, threads_for(items), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      state, trans, w_self, w_adv, w_cross, lengths, bp, last, score, T, ns,
      P, use_thr, thr, bw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
