// Max-plus (Viterbi) decode over a SHARED transition matrix, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// asr_craft_tpu_torch/kernels/viterbi.py, which picks each kernel's frame by
// width (dense_frame, nstate_frame); the plain PyTorch version of every
// kernel here is asr_craft_tpu_torch/ops/viterbi.py viterbi_forward on the
// dense (topology-masked) trans.
//
// Replaces the forward kernels of asr_craft_tpu/kernels/viterbi_pallas.py:
//   vit_dense_fwd_kernel   <- _vit_fwd_kernel (K7, viterbi_pallas): dense
//                             max-plus over a shared (L, L) trans, with the
//                             _beam_mask pruning; L <= 232
//   vit_dense_wide_kernel  <- the same, above L = 232 (the first frame)
//   vit_nstate_fwd_kernel  <- _vit_fwd_nstate_kernel (K8,
//                             viterbi_pallas_nstate): the topology-factored
//                             n-state step (self, advance, P x P cross);
//                             P <= 128 phones, 2 <= ns <= 8 states
// The TPU kernels store the per-frame deltas and re-derive backpointers in a
// second kernel (_vit_bwd_kernel) because an argmax on the VPU was slow.
// Here the lanes that own a destination keep the argmax beside the max, so
// the kernels write backpointers in the forward pass, and the traceback is
// fdt_viterbi.cu's fdt_vit_tb_kernel, unchanged.
//
// Layouts (batch-major, as models.crf.potentials returns them).  state
// (B, T, L) f32, boundary masking already folded in; trans (L, L) f32, row =
// predecessor; lengths (B,) i32.  Outputs: bp (B, T, L) i32, the predecessor
// of each label (identity at t = 0 and t >= length), last (B,) i32 and
// score (B,) f32, the final first argmax and its value.  The n-state kernel
// reads the legal transitions from trans itself, state-major (l = q ns + s):
// self trans[l, l], advance trans[l - 1, l] (s > 0) and cross trans[q' ns +
// ns - 1, q ns] (kernels/viterbi.py factored_weights names them).
//
// What bounds them on this card.  Time is a serial loop: one block owns one
// utterance and walks its frames, each frame a dependent max-plus step.  At
// the configs' widths (L = 48, 42; L' = 138) a frame is a few thousand
// adds and compares, far too little to fill an SM, so the time is the frame
// chain: its loads, compares, shuffles and block barriers, 511 times.  The
// first frame paid three barriers a frame in K8 (two in K7), a pass that
// copied the pruned row, the frame's potential loaded on the chain, a cross
// max read from shared memory with a stride of P floats a lane, self and
// advance one thread a state, and O(L^2) rank counts a frame under a beam
// width.  Both kernels now stand on the recursion frame of the
// forward-backward kernels and K12 (fwdbwd.cu, segmental.cu), in the
// max-plus semiring:
// - one shared row a frame: the raw (unpruned) new scores, double-buffered
//   by frame parity, so the frame takes ONE __syncthreads();
// - the beam is applied on read, by every lane to what it reads, against
//   the frame's cut: the threshold's cut is max - thr (each warp takes the
//   row max itself, one redux.sync on the floats' order keys), the beam
//   width's is the bw-th largest of the thresholded row (each warp selects
//   it itself: kth_largest), and a value survives both iff it is >= the
//   larger of the two cuts;
// - a group of kGroup = 4 lanes owns a destination (K7) or a phone (K8)
//   and each lane holds a contiguous quarter of the weights that
//   reach it, 4 QV floats padded with -INFINITY (a pad never wins or ties):
//   K7 the column of trans (destination-major, FactorRows: registers at QV
//   = 3, 5, 9, L <= 144; shared memory at QV = 15, L <= 232), K8 the cross
//   column w_cross[:, q] (registers, P <= 128);
// - a lane takes the first argmax over its ascending quarter of the pruned
//   row (K8: of the phones' last states, a compact row of P written beside
//   the full one), and the group merges by take_better (larger, then lower
//   index: a total order, so the lowest predecessor wins a tie);
// - K8's self and advance terms stay inside the phone: lane g takes states
//   s = g, g + 4 of its phone and keeps each state's raw score in a
//   register from the frame that wrote it; advance reads state s - 1
//   through a shuffle.  No block barrier;
// - frame t + 1's potentials arrive a frame ahead, in registers, and
//   backpointers go straight to device memory.
// The tie order in K8 is the expanded one: for s > 0, advance (l - 1) before
// self (l); for s = 0, cross from phones q' < q, then self, then cross from
// q' >= q.  A K8 destination whose legal best is dead (<= NEG_INF / 2: its
// legal predecessors were pruned or masked) takes the dense column over all
// L' predecessors (a destination-major copy of trans in shared memory where
// it fits beside the rows, L' <= 238, read a float4 quarter a lane; else
// trans from L2), so it gets the dense version's value and backpointer too.
// That re-scan is not rare: the start penalty kills every state but the
// first of a phone at frame 0, so the exact decode takes it at frames 1 ...
// ns - 2 of every row (2,944 at config 5, B = 64, T = 512), a threshold of
// 8 takes it 7 times a frame (236,820), a width of 16 85 times (2,775,065).
// So it is split over the group's lanes (merged by take_better) and kept
// out of the frame's code, a function of its own (noinline) with its
// registers apart, entered only by a warp one of whose states is dead.
//
// Measured on one H100 (B = 64, T = 512, against the first frame in the same
// call; PERF.md §6): K8 at config 5 0.78 -> 0.28 ms, with beam_threshold = 8
// 2.07 -> 0.85; K7 at config 1 0.30 -> 0.14, with the threshold 0.58 ->
// 0.19, at L' = 138 1.09 -> 0.51.  With beam_width = 16 both are slower
// than the first frame (K7 0.51 -> 0.60, K8 2.40 -> 2.81): each warp selects
// the cut itself, and K8 re-scans most of its states.  Tried and dropped:
// - two destinations a group in K7 (K4's choice): no faster exact
//   (within 1%), 5% slower with the threshold;
// - the re-scan inlined into the frame: K8 exact 0.28 -> 0.45 ms (a rare
//   branch's registers in the hot loop);
// - a group's dead states re-scanned in one pass over the row: 0.85 ->
//   1.31 ms with the threshold;
// - the width's select as one form: the count costs K8's 138-wide row
//   3.69 ms, a radix select costs K7 1.03 (two bits a round on redux.sync;
//   on ballots 1.13; one bit a round re-reading shared memory 2.96).

// Semantics held to the reference (ops/viterbi.py, the JAX XLA path).  Every
// sum is one IEEE fp32 add in the plain version's order (delta[p] +
// trans[p, l], then + state: __fadd_rn, so nothing fuses) and every max is
// exact, so bp, last and score are the plain version's bits.  Every
// backpointer and the final label are the FIRST argmax in expanded-label
// order.  Illegal predecessors carry the topology penalty NEG_INF in trans,
// so in K8 they lose to any live legal candidate (exact as long as |delta|
// + |trans| stay below 5e29 on live entries).  Pruning is threshold (keep >=
// max - thr, fp32), then exact top-k (keep >= the K-th largest, ties kept),
// on frame 0 too.
//
// The wide kernel (the first frame, L > 232): each destination's predecessor
// loop split over kGroup lanes (lane g takes p = g, g + kGroup, ...) merged
// with shuffles, trans read from L2 (L' = 390: 608 KB), then a pass that
// prunes the row into a second one behind its own barriers.

#include <climits>
#include <cmath>
#include <cstddef>
#include <type_traits>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::block_argmax;
using fdtk::FactorRows;
using fdtk::from_order_key;
using fdtk::kNegInf;
using fdtk::kRedSlots;
using fdtk::order_key;
using fdtk::take_better;

constexpr int kGroup = 4;               // lanes per destination
constexpr int kFrameThreads = 1024;     // the frame's blocks, at most
constexpr int kWideThreads = 512;       // the wide kernel's
constexpr int kSharedQV = 15;           // K7's factor in shared memory
constexpr int kMaxDenseL = 232;         // ... its widest (16 x 15 >= 232)
constexpr int kMaxPhones = 128;         // K8: the cross column in registers
constexpr int kMaxStates = 8;           // K8: two states a lane
constexpr float kDeadFloor = 0.5f * kNegInf;
constexpr size_t kSmemLimit = 232448;   // bytes a Hopper block may opt into
constexpr unsigned kAll = 0xffffffffu;

// ---------------------------------------------------------------------------
// The frame's pieces: the cut of a raw row, the beam on read, the group's
// merge.
// ---------------------------------------------------------------------------

// v, or NEG_INF where the frame's beam drops it
__device__ __forceinline__ float pruned(float v, bool prune, float cut) {
  return prune && !(v >= cut) ? kNegInf : v;
}

// The exact maximum of row[0, 4 n4) (pads -INFINITY), every warp for itself.
__device__ __forceinline__ float row_max_exact(const float* row, int n4) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float x = -INFINITY;
  for (int k = threadIdx.x & 31; k < n4; k += 32) {
    const float4 c = r4[k];
    x = fmaxf(x, fmaxf(fmaxf(c.x, c.y), fmaxf(c.z, c.w)));
  }
  return from_order_key(__reduce_max_sync(kAll, order_key(x)));
}

// The bw-th largest of row[0, L) after the threshold (values below cut_thr
// count as NEG_INF), every warp for itself; lane k holds the values of l =
// k, k + 32, ... (NK of them, L <= 32 NK).  A value v keeps its place in
// the top bw iff v >= it (ties at the bw-th kept).  Two forms, by what was
// faster on the card:
// - short rows (NK <= 3): a lane counts, for each of its values, the row's
//   values strictly greater (the row read as float4 chunks), and the warp
//   takes the smallest value with fewer than bw by one redux.sync on the
//   floats' order keys;
// - longer rows: a radix select, two bits a round from the top, on the
//   order keys as unsigned integers (0 past L: no value's key, and a digit
//   0 that is never counted), each round counting the keys with the prefix
//   and a digit >= 1, >= 2 and == 3 by two redux.sync (two counts packed in
//   one word).
template <int NK>
__device__ __forceinline__ float kth_largest(const float* row, int L, int bw,
                                             bool thr, float cut_thr) {
  const int lane = threadIdx.x & 31;
  if constexpr (NK <= 3) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const int n4 = L / 4;
    float v[NK];
    int n[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int l = lane + 32 * i;
      v[i] = l < L ? pruned(row[l], thr, cut_thr) : INFINITY;
      n[i] = 0;
    }
#pragma unroll 2
    for (int k = 0; k < n4; ++k) {
      const float4 x = r4[k];
      const float e[4] = {pruned(x.x, thr, cut_thr),
                          pruned(x.y, thr, cut_thr),
                          pruned(x.z, thr, cut_thr),
                          pruned(x.w, thr, cut_thr)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < NK; ++i) n[i] += e[j] > v[i];
    }
    for (int l = 4 * n4; l < L; ++l) {
      const float e = pruned(row[l], thr, cut_thr);
#pragma unroll
      for (int i = 0; i < NK; ++i) n[i] += e > v[i];
    }
    int kmin = INT_MAX;
#pragma unroll
    for (int i = 0; i < NK; ++i)
      if (lane + 32 * i < L && n[i] < bw) kmin = min(kmin, order_key(v[i]));
    return from_order_key(__reduce_min_sync(kAll, kmin));
  } else {
    unsigned key[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int l = lane + 32 * i;
      key[i] = l < L ? static_cast<unsigned>(
                           order_key(pruned(row[l], thr, cut_thr))) ^
                           0x80000000u
                     : 0u;
    }
    unsigned prefix = 0, hi = 0;
    int k = bw;
#pragma unroll 1
    for (int s = 30; s >= 0; s -= 2) {
      int c13 = 0, c2 = 0;
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        // 0: another prefix; else the digit + 1
        const unsigned d =
            (key[i] & hi) == prefix ? ((key[i] >> s) & 3u) + 1u : 0u;
        c13 += (d >= 2u) + (static_cast<int>(d == 4u) << 16);
        c2 += d >= 3u;
      }
      const int a = __reduce_add_sync(kAll, c13);
      const int n2 = __reduce_add_sync(kAll, c2);
      const int n1 = a & 0xffff, n3 = a >> 16;
      unsigned d;
      if (n3 >= k) {
        d = 3;
      } else if (n2 >= k) {
        d = 2;
        k -= n3;
      } else if (n1 >= k) {
        d = 1;
        k -= n2;
      } else {
        d = 0;
        k -= n1;
      }
      prefix |= d << s;
      hi |= 3u << s;
    }
    return from_order_key(static_cast<int>(prefix ^ 0x80000000u));
  }
}

// The cut of a raw row (4 n4 floats, pads -INFINITY): a value v survives
// the beam iff v >= cut.  -INFINITY with no beam.  BW: the kernel takes a
// beam width (its own instantiation, so the others carry no selection).
template <bool BW, int NK>
__device__ __forceinline__ float frame_cut(const float* row, int L, int n4,
                                           int use_thr, float thr, int bw) {
  float cut = -INFINITY;
  if (use_thr) cut = __fsub_rn(row_max_exact(row, n4), thr);
  if constexpr (BW)
    cut = fmaxf(cut, kth_largest<NK>(row, L, bw, use_thr != 0, cut));
  return cut;
}

// Merge the (max, first argmax) pairs of a group's kGroup lanes; every lane
// of the group gets the result.  All lanes of the warp must call it.
__device__ __forceinline__ void group_argmax(float& v, int& i) {
  for (int o = 1; o < kGroup; o <<= 1)
    take_better(v, i, __shfl_xor_sync(kAll, v, o),
                __shfl_xor_sync(kAll, i, o));
}

// The first argmax of x[p] + w[p] over the four predecessors p = base +
// 0 ... 3, x the raw row's chunk (pruned on read) and w its weights, merged
// into (best, from): strict '>' in ascending p keeps the first.
__device__ __forceinline__ void first_of4(float4 x, float4 w, int base,
                                          bool prune, float cut, float& best,
                                          int& from) {
  const float s[4] = {__fadd_rn(pruned(x.x, prune, cut), w.x),
                      __fadd_rn(pruned(x.y, prune, cut), w.y),
                      __fadd_rn(pruned(x.z, prune, cut), w.z),
                      __fadd_rn(pruned(x.w, prune, cut), w.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (s[j] > best) {
      best = s[j];
      from = base + j;
    }
}

// The first argmax of the pruned last row and its value, by warp 0,
// written to score_out / last_out.
__device__ __forceinline__ void final_argmax(const float* row, int L,
                                             bool prune, float cut,
                                             float* score_out,
                                             int* last_out) {
  if (threadIdx.x >= 32) return;
  float v = -INFINITY;
  int i = INT_MAX;
  for (int l = threadIdx.x; l < L; l += 32)
    take_better(v, i, pruned(row[l], prune, cut), l);
  for (int o = 16; o > 0; o >>= 1)
    take_better(v, i, __shfl_xor_sync(kAll, v, o),
                __shfl_xor_sync(kAll, i, o));
  if (threadIdx.x == 0) {
    score_out[blockIdx.x] = v;
    last_out[blockIdx.x] = i;
  }
}

// Identity backpointers of frame 0 and of frames [max(len, 1), T).
__device__ __forceinline__ void identity_bp(int* bpb, int len, int T, int L) {
  for (int l = threadIdx.x; l < L; l += blockDim.x) bpb[l] = l;
  for (size_t i = (size_t)max(len, 1) * L + threadIdx.x; i < (size_t)T * L;
       i += blockDim.x)
    bpb[i] = (int)(i % L);
}

// Sets row[n, total) to -INFINITY, the pads every reader may read.
__device__ __forceinline__ void pad_row(float* row, int n, int total) {
  for (int j = n + threadIdx.x; j < total; j += blockDim.x) row[j] = -INFINITY;
}

// ---------------------------------------------------------------------------
// K7 on the frame: group `slot` owns destination l = slot; its lane 0
// finishes it.
// ---------------------------------------------------------------------------

int dense_threads(int L) {
  const int n = (L * kGroup + 31) / 32 * 32;
  return n < 64 ? 64 : n;
}

size_t dense_smem_bytes(int L, int qv, int shared) {
  const bool reg = !shared && (qv == 3 || qv == 5 || qv == 9);
  const bool sh = shared && qv == kSharedQV;
  if (!(reg || sh) || L < 1 || 16 * qv < L || L > kMaxDenseL ||
      dense_threads(L) > kFrameThreads)
    return 0;
  const size_t Lq = 16 * (size_t)qv;
  const size_t bytes = sizeof(float) * ((shared ? L * Lq : 0) + 2 * Lq);
  return bytes <= kSmemLimit ? bytes : 0;
}

// The register layouts' blocks are at most 64 QV threads, which leaves a
// lane the registers its quarter needs.
template <int QV, bool SHARED, bool BW>
__global__ void __launch_bounds__(SHARED ? kFrameThreads : 64 * QV)
vit_dense_fwd_kernel(const float* __restrict__ state,
                     const float* __restrict__ trans,
                     const int* __restrict__ lengths, int* __restrict__ bp,
                     int* __restrict__ last_out, float* __restrict__ score_out,
                     int T, int L, int use_thr, float thr, int bw) {
  constexpr int Lq = 16 * QV;
  constexpr int NK = (QV + 1) / 2;                   // the row's keys a lane
  extern __shared__ float4 smem4[];
  float* Fs = reinterpret_cast<float*>(smem4);       // SHARED: (L, Lq)
  float* rows = Fs + (SHARED ? (size_t)L * Lq : 0);  // (2, Lq) by parity
  const int tid = threadIdx.x, nth = blockDim.x;
  const int g = tid % kGroup;
  const int l[1] = {tid / kGroup};                   // my destination
  const bool ok = l[0] < L, own = ok && g == 0;
  const int lo = ok ? l[0] : 0;
  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* sb = state + (size_t)b * T * L;
  int* bpb = bp + (size_t)b * T * L;

  // the factor, destination-major: F[l, p] = trans[p, l], -INFINITY past L
  FactorRows<1, QV, SHARED> f;
  if constexpr (SHARED) {
    for (int i = tid; i < L * Lq; i += nth) {
      const int r = i / Lq, c = i - r * Lq;
      Fs[i] = c < L ? trans[(size_t)c * L + r] : -INFINITY;
    }
    f.load(nullptr, Fs, L, l, g);
  } else {
#pragma unroll
    for (int k = 0; k < QV; ++k) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * (QV * g + k) + j;
        v[j] = ok && p < L ? trans[(size_t)p * L + lo] : -INFINITY;
      }
      f.r[0][k] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  pad_row(rows, L, Lq);
  pad_row(rows + Lq, L, Lq);
  identity_bp(bpb, len, T, L);
  // frame 0: the raw row is the potentials
  if (own) rows[lo] = sb[lo];
  float cur = own && len > 1 ? sb[(size_t)L + lo] : 0.0f;
  __syncthreads();

  const bool prune = use_thr != 0 || BW;
  float cut = frame_cut<BW, NK>(rows, L, Lq / 4, use_thr, thr, bw);
  for (int t = 1; t < len; ++t) {
    const float nxt = own && t + 1 < len ? sb[(size_t)(t + 1) * L + lo]
                                         : 0.0f;
    const float4* x = reinterpret_cast<const float4*>(
                          rows + ((t - 1) & 1) * Lq) + g * QV;
    float best = -INFINITY;
    int from = INT_MAX;
#pragma unroll
    for (int k = 0; k < QV; ++k)
      first_of4(x[k], f.at(0, k), 4 * (QV * g + k), prune, cut, best, from);
    group_argmax(best, from);
    if (own) {
      rows[(t & 1) * Lq + lo] = __fadd_rn(best, cur);
      bpb[(size_t)t * L + lo] = from;
    }
    __syncthreads();
    cut = frame_cut<BW, NK>(rows + (t & 1) * Lq, L, Lq / 4, use_thr, thr, bw);
    cur = nxt;
  }
  final_argmax(rows + ((max(len, 1) - 1) & 1) * Lq, L, prune, cut, score_out,
               last_out);
}

// ---------------------------------------------------------------------------
// K8 on the frame: group q (kGroup lanes) owns phone q; lane g owns states
// s = g + 4 j (j < SPL) of it.
// ---------------------------------------------------------------------------

int nstate_threads(int P) {
  const int n = (P * kGroup + 31) / 32 * 32;
  return n < 64 ? 64 : n;
}

// The floats of a raw row: L padded to 16 QVr, QVr odd (the re-scan reads a
// quarter of 4 QVr a lane, as the frame reads its factor).
__host__ __device__ inline int nstate_row(int L) {
  return 16 * (((L + 15) / 16) | 1);
}

// rows (2, Lr) | last-state rows (2, 16 QV) [| F (L, Lr)]
__host__ __device__ inline size_t nstate_rows_floats(int L, int qv) {
  return 2 * (size_t)nstate_row(L) + 32 * (size_t)qv;
}

// F[l, p] = trans[p, l], destination-major, fits beside the rows (L <= 232)
__host__ __device__ inline bool nstate_trans_in_smem(int L, int qv) {
  return sizeof(float) * ((size_t)L * nstate_row(L) +
                          nstate_rows_floats(L, qv)) <= kSmemLimit;
}

size_t nstate_smem_bytes(int ns, int P, int qv) {
  if ((qv != 3 && qv != 5 && qv != 9) || 16 * qv < P || P < 1 ||
      P > kMaxPhones || ns < 2 || ns > kMaxStates)
    return 0;
  const int L = ns * P;
  const size_t F = nstate_trans_in_smem(L, qv) ? (size_t)L * nstate_row(L)
                                               : 0;
  return sizeof(float) * (nstate_rows_floats(L, qv) + F);
}

struct Cand {
  float v;
  int i;
};

// The dense column of destination l over all L predecessors, for a dead
// destination, merged by the group: from F (Lr floats a row), lane g takes
// its contiguous quarter of the pruned row (Lr / 4 entries, two chains of
// alternate float4 chunks merged by take_better); without F (wide L'), p =
// g, g + 4, ... through trans in L2.  Every lane of the group gets it.  All
// lanes of the warp call it; a group with `on` false reads nothing.
__device__ __noinline__ Cand dense_column(const float* row, const float* Fs,
                                          const float* __restrict__ trans,
                                          int L, int Lr, int l, int g,
                                          bool on, bool prune, float cut) {
  Cand c{-INFINITY, INT_MAX};
  if (on) {
    if (Fs != nullptr) {
      const int qv = Lr / 16;
      const float4* x = reinterpret_cast<const float4*>(row) + g * qv;
      const float4* w =
          reinterpret_cast<const float4*>(Fs + (size_t)l * Lr) + g * qv;
      Cand c2{-INFINITY, INT_MAX};
      for (int k = 0; k < qv; k += 2) {
        first_of4(x[k], w[k], 4 * (qv * g + k), prune, cut, c.v, c.i);
        if (k + 1 < qv)
          first_of4(x[k + 1], w[k + 1], 4 * (qv * g + k + 1), prune, cut,
                    c2.v, c2.i);
      }
      take_better(c.v, c.i, c2.v, c2.i);
    } else {
#pragma unroll 4
      for (int p = g; p < L; p += kGroup) {
        const float v = __fadd_rn(pruned(row[p], prune, cut),
                                  trans[(size_t)p * L + l]);
        if (v > c.v) {
          c.v = v;
          c.i = p;
        }
      }
    }
  }
  group_argmax(c.v, c.i);
  return c;
}

template <int QV, int SPL, bool BW>
__global__ void __launch_bounds__(kMaxPhones * kGroup)
vit_nstate_fwd_kernel(const float* __restrict__ state,
                      const float* __restrict__ trans,
                      const int* __restrict__ lengths, int* __restrict__ bp,
                      int* __restrict__ last_out,
                      float* __restrict__ score_out, int T, int ns, int P,
                      int use_thr, float thr, int bw) {
  constexpr int Pq = 16 * QV;
  constexpr int NK = 2 * SPL * QV;       // the row's keys a lane (L <= 32 NK)
  extern __shared__ float4 smem4[];
  const int L = ns * P, Lr = nstate_row(L);
  float* rows = reinterpret_cast<float*>(smem4);     // (2, Lr) raw, by parity
  float* crow = rows + 2 * Lr;                       // (2, Pq) last states
  float* Fs = nstate_trans_in_smem(L, QV) ? crow + 2 * Pq : nullptr;
  const int tid = threadIdx.x;
  const int g = tid % kGroup, q = tid / kGroup;
  const bool qok = q < P;
  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* sb = state + (size_t)b * T * L;
  int* bpb = bp + (size_t)b * T * L;

  // the cross column w_cross[q', q] = trans[q' ns + ns - 1, q ns], a
  // quarter a lane, -INFINITY past P
  FactorRows<1, QV, false> wc;
#pragma unroll
  for (int k = 0; k < QV; ++k) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qp = 4 * (QV * g + k) + j;
      v[j] = qok && qp < P ? trans[(size_t)(qp * ns + ns - 1) * L + q * ns]
                           : -INFINITY;
    }
    wc.r[0][k] = make_float4(v[0], v[1], v[2], v[3]);
  }
  int ls[SPL];                         // my states' labels
  bool own[SPL];
  float wself[SPL], wadv[SPL], raw[SPL], cur[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int s = g + kGroup * j;
    own[j] = qok && s < ns;
    ls[j] = own[j] ? q * ns + s : 0;
    wself[j] = own[j] ? trans[(size_t)ls[j] * L + ls[j]] : 0.0f;
    wadv[j] = own[j] && s > 0 ? trans[(size_t)(ls[j] - 1) * L + ls[j]]
                              : 0.0f;
  }
  if (Fs != nullptr)        // the dense columns, destination-major
    for (int i = tid; i < L * Lr; i += blockDim.x) {
      const int r = i / Lr, c = i - r * Lr;
      Fs[i] = c < L ? trans[(size_t)c * L + r] : -INFINITY;
    }
  pad_row(rows, L, Lr);
  pad_row(rows + Lr, L, Lr);
  pad_row(crow, P, Pq);
  pad_row(crow + Pq, P, Pq);
  identity_bp(bpb, len, T, L);
  // frame 0: the raw row is the potentials
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    raw[j] = own[j] ? sb[ls[j]] : 0.0f;
    if (own[j]) {
      rows[ls[j]] = raw[j];
      if (g + kGroup * j == ns - 1) crow[q] = raw[j];
    }
    cur[j] = own[j] && len > 1 ? sb[(size_t)L + ls[j]] : 0.0f;
  }
  __syncthreads();

  const bool prune = use_thr != 0 || BW;
  float cut = frame_cut<BW, NK>(rows, L, Lr / 4, use_thr, thr, bw);
  for (int t = 1; t < len; ++t) {
    float nxt[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      nxt[j] = own[j] && t + 1 < len ? sb[(size_t)(t + 1) * L + ls[j]] : 0.0f;
    const float* rp = rows + ((t - 1) & 1) * Lr;
    // cross into phone q: the first argmax over q' of delta[last(q')] +
    // w_cross[q', q], a quarter a lane, merged by the group
    const float4* cx = reinterpret_cast<const float4*>(
                           crow + ((t - 1) & 1) * Pq) + g * QV;
    float cm = -INFINITY;
    int ca = INT_MAX;
#pragma unroll
    for (int k = 0; k < QV; ++k)
      first_of4(cx[k], wc.r[0][k], 4 * (QV * g + k), prune, cut, cm, ca);
    group_argmax(cm, ca);
    // self and advance, inside the phone: state s - 1 is lane g - 1's state
    // j, or for g = 0 lane 3's state j - 1
    float dp[SPL], up[SPL], wrap[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      dp[j] = pruned(raw[j], prune, cut);
      up[j] = __shfl_up_sync(kAll, dp[j], 1, kGroup);
      wrap[j] = __shfl_sync(kAll, dp[j], kGroup - 1, kGroup);
    }
    float best[SPL];
    int from[SPL];
    bool dead = false;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const float self_c = __fadd_rn(dp[j], wself[j]);
      if (g == 0 && j == 0) {
        // cross from q' < q precedes self (index q ns) in expanded order
        if (cm > self_c || (cm == self_c && ca < q)) {
          best[j] = cm;
          from[j] = ca * ns + ns - 1;
        } else {
          best[j] = self_c;
          from[j] = ls[j];
        }
      } else {
        // advance (l - 1) precedes self (l)
        const float adv_c = __fadd_rn(g > 0 ? up[j] : wrap[j > 0 ? j - 1 : 0],
                                      wadv[j]);
        if (self_c > adv_c) {
          best[j] = self_c;
          from[j] = ls[j];
        } else {
          best[j] = adv_c;
          from[j] = ls[j] - 1;
        }
      }
      dead |= own[j] && !(best[j] > kDeadFloor);
    }
    if (__any_sync(kAll, dead)) {
      // the dead states' dense columns, state by state of the group
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const bool mine = own[j] && !(best[j] > kDeadFloor);
        for (int o = 0; o < kGroup; ++o) {
          const bool on =
              __shfl_sync(kAll, static_cast<int>(mine), o, kGroup);
          if (!__any_sync(kAll, on)) continue;
          const Cand c = dense_column(rp, Fs, trans, L, Lr,
                                      q * ns + o + kGroup * j, g, on, prune,
                                      cut);
          if (on && g == o) {
            best[j] = c.v;
            from[j] = c.i;
          }
        }
      }
    }
    float* rt = rows + (t & 1) * Lr;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      raw[j] = __fadd_rn(best[j], cur[j]);
      if (own[j]) {
        rt[ls[j]] = raw[j];
        if (g + kGroup * j == ns - 1) crow[(t & 1) * Pq + q] = raw[j];
        bpb[(size_t)t * L + ls[j]] = from[j];
      }
      cur[j] = nxt[j];
    }
    __syncthreads();
    cut = frame_cut<BW, NK>(rt, L, Lr / 4, use_thr, thr, bw);
  }
  final_argmax(rows + ((max(len, 1) - 1) & 1) * Lr, L, prune, cut, score_out,
               last_out);
}

// ---------------------------------------------------------------------------
// The wide K7 (the first frame), above L = 232: trans from L2.
// ---------------------------------------------------------------------------

size_t wide_smem_floats(int L) {
  return 2 * (size_t)L + 2 * kRedSlots;
}

int wide_threads(int L) {
  const int n = (L * kGroup + 31) / 32 * 32;
  return n < 64 ? 64 : (n > kWideThreads ? kWideThreads : n);
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

// This lane's (max, first argmax) over p = g, g + kGroup, ... < n of
// a[p] + b[p * sb]: strict '>' in p order keeps the lane's first.
__device__ __forceinline__ void lane_max(const float* a, const float* b,
                                         int sb, int n, int g, float& best,
                                         int& from) {
  best = -INFINITY;
  from = INT_MAX;
#pragma unroll 4
  for (int p = g; p < n; p += kGroup) {
    const float v = a[p] + b[(size_t)p * sb];
    if (v > best) {
      best = v;
      from = p;
    }
  }
}

__global__ void __launch_bounds__(kWideThreads)
vit_dense_wide_kernel(const float* __restrict__ state,
                      const float* __restrict__ trans,
                      const int* __restrict__ lengths, int* __restrict__ bp,
                      int* __restrict__ last_out,
                      float* __restrict__ score_out, int T, int L,
                      int use_thr, float thr, int bw) {
  extern __shared__ float smem[];
  float* delta = smem;
  float* cand = delta + L;
  float* red_v = cand + L;
  int* red_i = reinterpret_cast<int*>(red_v + kRedSlots);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int g = tid % kGroup, slot = tid / kGroup, nslots = nth / kGroup;
  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* sb = state + (size_t)b * T * L;
  int* bpb = bp + (size_t)b * T * L;

  identity_bp(bpb, len, T, L);
  for (int l = tid; l < L; l += nth) cand[l] = sb[l];
  __syncthreads();
  prune_into(cand, delta, L, use_thr, thr, bw, red_v, red_i);
  for (int t = 1; t < len; ++t) {
    // a uniform loop, so every lane reaches the group's shuffles
    for (int l0 = 0; l0 < L; l0 += nslots) {
      const int l = l0 + slot;
      const bool mine = l < L && g == 0;
      const float s_t = mine ? sb[(size_t)t * L + l] : 0.0f;
      float best;
      int from;
      lane_max(delta, trans + (l < L ? l : 0), L, l < L ? L : 0, g, best,
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
  float v = -INFINITY;
  int a = INT_MAX;
  for (int l = tid; l < L; l += nth) take_better(v, a, delta[l], l);
  block_argmax(v, a, red_v, red_i);
  if (tid == 0) {
    score_out[b] = v;
    last_out[b] = a;
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int B, int threads, size_t bytes, void* stream,
           Args... args) {
  const cudaError_t err = fdtk::opt_in(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Calls fn(QV, SHARED) as compile-time constants for K7's layout;
// cudaErrorInvalidValue for one that is not built.
template <class Fn>
int by_dense_layout(int qv, int shared, Fn&& fn) {
  using std::integral_constant;
  if (shared) return fn(integral_constant<int, kSharedQV>{}, std::true_type{});
  switch (qv) {
    case 3: return fn(integral_constant<int, 3>{}, std::false_type{});
    case 5: return fn(integral_constant<int, 5>{}, std::false_type{});
    case 9: return fn(integral_constant<int, 9>{}, std::false_type{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Calls fn(QV, SPL) as compile-time constants for K8's layout.
template <class Fn>
int by_nstate_layout(int qv, int ns, Fn&& fn) {
  using std::integral_constant;
  auto pick = [&](auto spl) -> int {
    switch (qv) {
      case 3: return fn(integral_constant<int, 3>{}, spl);
      case 5: return fn(integral_constant<int, 5>{}, spl);
      case 9: return fn(integral_constant<int, 9>{}, spl);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  return ns > kGroup ? pick(integral_constant<int, 2>{})
                     : pick(integral_constant<int, 1>{});
}

}  // namespace

extern "C" {

// K7's dynamic shared memory in bytes at width L on the frame's layout (qv,
// shared: kernels/viterbi.py dense_frame), or with qv = 0 on the wide
// kernel; 0 where no kernel takes it.
size_t viterbi_dense_smem_bytes(int L, int qv, int shared) {
  if (qv == 0)
    return L > kMaxDenseL ? sizeof(float) * wide_smem_floats(L) : 0;
  return dense_smem_bytes(L, qv, shared);
}

// K8's, at P phones of ns states with the cross column's qv
// (kernels/viterbi.py nstate_frame); 0 where it does not take them.
size_t viterbi_nstate_smem_bytes(int ns, int P, int qv) {
  return nstate_smem_bytes(ns, P, qv);
}

int viterbi_dense_fwd(const float* state, const float* trans,
                      const int* lengths, int* bp, int* last, float* score,
                      int B, int T, int L, int use_thr, float thr, int bw,
                      int qv, int shared, void* stream) {
  const size_t bytes = viterbi_dense_smem_bytes(L, qv, shared);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (qv == 0)
    return launch(vit_dense_wide_kernel, B, wide_threads(L), bytes, stream,
                  state, trans, lengths, bp, last, score, T, L, use_thr, thr,
                  bw);
  return by_dense_layout(qv, shared, [&](auto q, auto sh) {
    constexpr int Q = decltype(q)::value;
    constexpr bool S = decltype(sh)::value;
    return launch(bw > 0 ? vit_dense_fwd_kernel<Q, S, true>
                         : vit_dense_fwd_kernel<Q, S, false>,
                  B, dense_threads(L), bytes, stream, state, trans, lengths,
                  bp, last, score, T, L, use_thr, thr, bw);
  });
}

int viterbi_nstate_fwd(const float* state, const float* trans,
                       const int* lengths, int* bp, int* last, float* score,
                       int B, int T, int ns, int P, int use_thr, float thr,
                       int bw, int qv, void* stream) {
  const size_t bytes = nstate_smem_bytes(ns, P, qv);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_nstate_layout(qv, ns, [&](auto q, auto spl) {
    constexpr int Q = decltype(q)::value, S = decltype(spl)::value;
    return launch(bw > 0 ? vit_nstate_fwd_kernel<Q, S, true>
                         : vit_nstate_fwd_kernel<Q, S, false>,
                  B, nstate_threads(P), bytes, stream, state, trans, lengths,
                  bp, last, score, T, ns, P, use_thr, thr, bw);
  });
}

}  // extern "C"
