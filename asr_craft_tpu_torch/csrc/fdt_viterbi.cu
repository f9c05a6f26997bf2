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
// What bounds it on this card.  Time is a serial loop: one block owns one
// utterance and walks its T frames, so B=64 fills 64 of the 132 SMs.  The
// planes do not depend on the scores, so they are formed before the
// recursion, all frames at once, on the tensor cores; the recursion's frame
// is the max-plus step (self/adv elementwise, a P x P max with its argmax
// for the cross terms) and, under a beam, the pruning counts: latency, at
// one block an utterance.
//
// What the design does about it.  Frame t+1's plane row (10.9 KB at the
// flagship) is read from device memory one frame ahead, into the other of
// two shared buffers, by one cp.async.bulk on an mbarrier, while the
// current frame's work runs.  The cross max runs on a group of 16 lanes a
// destination phone pj (pi split over the group, merged by shuffles with
// the first-argmax order take_better, so the merge order does not change
// the argmax).  The scores are kept in two shared buffers (delta_t-1 read,
// delta_t written): the exact decode takes two barriers a frame, the plane
// and delta_t-1 in place (A) and the cross max complete (B).  Frames past
// an utterance's length are not computed at all.  Not done: several
// utterances a block, so B=64 fills the card.
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

constexpr int kFwdThreads = 768;    // 48 groups of kCrossLanes lanes
using fdtk::kTbMaxFrames;
using fdtk::kTbProducers;
using fdtk::kTbRing;
using fdtk::kTbThreads;
constexpr size_t kTbLabBytes = 4 * kTbMaxFrames;   // a block's labels
constexpr int kCrossLanes = 16;     // lanes a destination phone
constexpr int kMaxP = 128;          // the wrapper's phone cap

// planes (2 R4, 16-byte aligned first) | delta (2 L') | cand (L') | mrun
// (P) | arun (P) | red_v, red_i (kRedSlots each), then two 8-byte mbarriers
__host__ __device__ inline int fwd_barrier_offset(int ns, int P) {
  const int Lp = ns * P;
  return (2 * round_up4(3 * Lp + P * P) + 3 * Lp + 2 * P + 2 * kRedSlots +
          1) & ~1;
}

size_t fwd_smem_floats(int ns, int P) {
  return (size_t)fwd_barrier_offset(ns, P) + 4;
}

__global__ void __launch_bounds__(kFwdThreads)
fdt_vit_fwd_kernel(const float* __restrict__ planes,
                   const int* __restrict__ lengths, int* __restrict__ bp,
                   int* __restrict__ last_out, float* __restrict__ score_out,
                   int T, int ns, int P, int boundaries, int use_thr,
                   float thr, int bw) {
  extern __shared__ float4 smem4[];
  const int Lp = ns * P, R4 = round_up4(3 * Lp + P * P);
  float* pbuf = reinterpret_cast<float*>(smem4);         // (2, R4) planes
  float* dbuf = pbuf + 2 * R4;                           // (2, L') scores
  float* cand = dbuf + 2 * Lp;                           // (L') top-k
  float* mrun = cand + Lp;                               // (P) cross max
  int* arun = reinterpret_cast<int*>(mrun + P);          // (P) cross arg
  float* red_v = reinterpret_cast<float*>(arun + P);
  int* red_i = reinterpret_cast<int*>(red_v + kRedSlots);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
      pbuf + fwd_barrier_offset(ns, P));                 // (2) one a buffer

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int len_raw = lengths[b];
  const int len = min(max(len_raw, 0), T);
  const float* pb = planes + (size_t)b * T * R4;
  int* bpb = bp + (size_t)b * T * Lp;
  const bool bnd = boundaries && ns > 1;
  const unsigned row_bytes = sizeof(float) * R4;
  const int gl = tid & (kCrossLanes - 1);
  const unsigned gmask = ((1u << kCrossLanes) - 1)
                         << ((tid & 31) & ~(kCrossLanes - 1));

  // frame 0 always runs (a length-0 row still reports its initial max)
  const int tend = max(len, 1);
  if (tid == 0) {
    fdtk::mbar_init(&bar[0], 1);
    fdtk::mbar_init(&bar[1], 1);
  }
  __syncthreads();                      // the barriers initialised
  if (tid == 0) fdtk::bulk_load(pbuf, pb, row_bytes, &bar[0]);
  for (int t = 0; t < tend; ++t) {
    const float* plane = pbuf + (t & 1) * R4;
    const float* d = dbuf + ((t + 1) & 1) * Lp;          // delta_t-1
    float* dn = dbuf + (t & 1) * Lp;                     // delta_t
    // plane t is the t-th row to land in buffer t & 1: that barrier's
    // (t >> 1)-th phase
    fdtk::mbar_wait(&bar[t & 1], (t >> 1) & 1);
    // (A) plane t and delta_t-1 in place for every thread; frame t-1's
    // reads of buffer (t + 1) & 1 are done
    __syncthreads();
    if (tid == 0 && t + 1 < tend)
      fdtk::bulk_load(pbuf + ((t + 1) & 1) * R4, pb + (size_t)(t + 1) * R4,
                      row_bytes, &bar[(t + 1) & 1]);

    const bool at_end = t == len_raw - 1;
    if (t == 0) {
      for (int l = tid; l < Lp; l += nth) {
        const int st = l % ns;
        float s = plane[l];
        if (bnd) {
          s += st == 0 ? 0.0f : kNegInf;                       // start
          s += (at_end && st != ns - 1) ? kNegInf : 0.0f;      // end
        }
        dn[l] = s;
        bpb[l] = l;
      }
    } else {
      // cross: max over predecessor phones pi of delta[last(pi)] +
      // cross[pi, pj], a group of kCrossLanes lanes a destination pj; each
      // lane walks its pi upward and the group merges by take_better, a
      // total order, so the result is the FIRST argmax (lane state (-inf,
      // 0): every finite candidate beats it)
      for (int pj = tid / kCrossLanes; pj < P; pj += nth / kCrossLanes) {
        const float* cr = plane + 3 * Lp + pj;
        float m = -INFINITY;
        int a = 0;
#pragma unroll
        for (int k = 0; k < kMaxP / kCrossLanes; ++k) {
          const int pi = gl + k * kCrossLanes;
          if (pi < P) take_better(m, a, d[pi * ns + ns - 1] + cr[pi * P], pi);
        }
        for (int o = kCrossLanes / 2; o > 0; o >>= 1)
          take_better(m, a, __shfl_xor_sync(gmask, m, o),
                      __shfl_xor_sync(gmask, a, o));
        if (gl == 0) {
          mrun[pj] = m;
          arun[pj] = a;
        }
      }
      __syncthreads();                  // (B) the cross max complete
      for (int l = tid; l < Lp; l += nth) {
        const int st = l % ns, p = l / ns;
        float best;
        int from;
        if (ns == 1) {
          best = mrun[p];
          from = arun[p];
        } else {
          const float self_c = d[l] + plane[Lp + l];
          const float adv_c =
              st > 0 ? d[l - 1] + plane[2 * Lp + l - 1] : kNegInf;
          const float cross_c = st == 0 ? mrun[p] : kNegInf;
          best = fmaxf(fmaxf(self_c, adv_c), cross_c);
          from = self_c == best  ? l
                 : adv_c == best ? l - 1
                                 : arun[p] * ns + ns - 1;
        }
        float s = plane[l];
        if (bnd) s += (at_end && st != ns - 1) ? kNegInf : 0.0f;
        dn[l] = best + s;
        bpb[(size_t)t * Lp + l] = from;
      }
    }

    if (use_thr) {
      // each thread reads only its own labels before block_argmax's
      // barriers, and prunes them after
      float m = -INFINITY;
      int unused = 0;
      for (int l = tid; l < Lp; l += nth) m = fmaxf(m, dn[l]);
      block_argmax(m, unused, red_v, red_i);
      const float floor_v = m - thr;
      for (int l = tid; l < Lp; l += nth)
        if (!(dn[l] >= floor_v)) dn[l] = kNegInf;
    }
    if (bw > 0) {
      // top-k: v survives iff fewer than bw values are strictly greater,
      // which is exactly v >= (the bw-th largest value), ties kept
      __syncthreads();                  // delta_t complete
      for (int l = tid; l < Lp; l += nth) {
        const float v = dn[l];
        int above = 0;
        for (int j = 0; j < Lp; ++j) above += dn[j] > v;
        cand[l] = above >= bw ? kNegInf : v;
      }
      __syncthreads();                  // every count read delta_t
      for (int l = tid; l < Lp; l += nth) dn[l] = cand[l];
    }
  }
  __syncthreads();                      // the last delta complete
  const float* dlast = dbuf + ((tend - 1) & 1) * Lp;

  for (size_t i = (size_t)tend * Lp + tid; i < (size_t)T * Lp; i += nth)
    bpb[i] = (int)(i % Lp);

  float v = -INFINITY;
  int a = INT_MAX;
  for (int l = tid; l < Lp; l += nth) take_better(v, a, dlast[l], l);
  block_argmax(v, a, red_v, red_i);
  if (tid == 0) {
    score_out[b] = v;
    last_out[b] = a;
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

size_t fdt_viterbi_fwd_smem_bytes(int ns, int P) {
  return sizeof(float) * fwd_smem_floats(ns, P);
}

const char* fdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// planes (B, T, R4) from fdt_train_plane (fdt_mma.cu); P <= 128
int fdt_viterbi_fwd(const float* planes, const int* lengths, int* bp,
                    int* last, float* score, int B, int T, int ns, int P,
                    int boundaries, int use_thr, float thr, int bw,
                    void* stream) {
  const size_t smem = fdt_viterbi_fwd_smem_bytes(ns, P);
  cudaError_t err = cudaFuncSetAttribute(
      fdt_vit_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fdt_vit_fwd_kernel<<<B, kFwdThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      planes, lengths, bp, last, score, T, ns, P, boundaries, use_thr, thr,
      bw);
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
