// Factored max-plus (Viterbi) decode over the frame-dependent-transition
// lattice, for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// asr_craft_tpu_torch/kernels/fdt_viterbi.py; the plain PyTorch version of
// the same function is fdt_viterbi_wall_torch in that module.
//
// Replaces the TPU kernel asr_craft_tpu/kernels/fdt_pallas.py
// fdt_viterbi_pallas, whose two pallas_calls become the two kernels here:
//   fdt_vit_fwd_kernel  <- _fdt_vit_fwd_kernel (max-plus forward with
//                          in-kernel plane formation, pruning, backpointers)
//   fdt_vit_tb_kernel   <- _fdt_vit_bwd_kernel (backpointer traceback)
//
// Layouts.  Wall is the packed parameter matrix of kernels/wall.build_wall,
// passed TRANSPOSED and zero-padded as wall_t (Dw, R4) with Dw = Du + 1
// (bias last), R4 = R rounded up to a multiple of 4, and rows r in
// [state L' | self L' | adv L' | cross P*P (pi-major)], all state-major
// (label l = phone * ns + state).  The plane formation is fdt_common.cuh's,
// shared with the training kernels (fdt_train.cu).
// feats (B, T, D) f32, lengths (B,) i32.  Outputs: bp (B, T, L') i32 holds
// the predecessor label of each state (identity at t = 0 and t >= length),
// last (B,) i32 / score (B,) f32 the final first-argmax label and score,
// paths (B, T) i32 the state-major labels.
//
// What bounds it on this card.  Time is a serial loop: one block owns one
// utterance and walks its T frames.  Each frame forms the plane
// (R x Dw FMAs; 2736 x 145 at the config-2 flagship) from a Wall that does
// not fit one SM's shared memory (1.6 MB) and is therefore re-read from L2
// every frame, so an SM spends most of a frame streaming Wall through its
// L2 port.  The DP itself (self/adv elementwise, a P x P max for cross,
// the pruning counts) is small beside it.
//
// What this first design does about it.  Wall is transposed once per call
// so that each thread forms 4 adjacent rows from one 16-byte load per input
// dim, consecutive threads reading consecutive row groups (coalesced, and
// enough bytes in flight to keep the SM's L2 port busy rather than waiting
// on load latency); x_t is broadcast from shared memory, and the plane
// never leaves shared memory (it never goes to HBM, as on the TPU).
// Frames past an utterance's length are not computed at all.  Not done
// yet: splitting an utterance's rows over a cluster of blocks so Wall stays
// resident in distributed shared memory (and B=64 fills more than 64 SMs).
//
// Semantics held to the reference (ops/fdt.py fdt_viterbi, both packages):
// tie order self > advance > cross; the cross predecessor is the FIRST
// phone among equal maxima; the final label is the first argmax; pruning is
// threshold (keep >= max - thr, fp32) then exact top-k (keep >= the K-th
// largest, ties kept), on the initial frame too; boundaries restrict frame
// 0 to first states and frame length-1 to last states; frames t >= length
// keep the carry with identity backpointers.  All arithmetic is IEEE fp32.

#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::kNegInf;
using fdtk::round_up4;

constexpr int kFwdThreads = 768;    // one pass over 684 flagship row groups
constexpr int kTbThreads = 128;
constexpr int kRedSlots = 33;       // one per warp + one for the result

// (v, i) := the better of (v, i) and (v2, i2): larger value, then lower
// index.  A total order, so every reduction tree gives the first argmax.
__device__ __forceinline__ void take_better(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Block-wide (max, lowest index of the max); every thread gets the result.
// Two barriers, so consecutive calls may reuse red_v / red_i.
__device__ void block_argmax(float& v, int& i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    take_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
                __shfl_xor_sync(0xffffffffu, i, o));
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? red_v[lane] : -INFINITY;
    i = lane < nw ? red_i[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1)
      take_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
                  __shfl_xor_sync(0xffffffffu, i, o));
    if (lane == 0) {
      red_v[kRedSlots - 1] = v;
      red_i[kRedSlots - 1] = i;
    }
  }
  __syncthreads();
  v = red_v[kRedSlots - 1];
  i = red_i[kRedSlots - 1];
}

size_t fwd_smem_floats(int Du, int ns, int P) {
  const size_t Lp = (size_t)ns * P;
  const size_t R4 = round_up4(3 * ns * P + P * P);
  // plane (16-byte aligned first) | x | delta | cand | mrun | arun | red
  return R4 + (size_t)(Du + 1) + 2 * Lp + 2 * (size_t)P + 2 * kRedSlots;
}

__global__ void __launch_bounds__(kFwdThreads)
fdt_vit_fwd_kernel(const float* __restrict__ wall_t,
                   const float* __restrict__ feats,
                   const int* __restrict__ lengths, int* __restrict__ bp,
                   int* __restrict__ last_out, float* __restrict__ score_out,
                   int T, int D, int u0, int Du, int ns, int P,
                   int boundaries, int use_thr, float thr, int bw) {
  extern __shared__ float4 smem4[];
  const int Lp = ns * P, R4 = round_up4(3 * Lp + P * P), Dw = Du + 1;
  const int Q = R4 / 4;                                  // row groups
  float* plane = reinterpret_cast<float*>(smem4);        // (R4)
  float* x = plane + R4;                                 // (Dw)  x_t | 1
  float* delta = x + Dw;                                 // (L') carry
  float* cand = delta + Lp;                              // (L') new scores
  float* mrun = cand + Lp;                               // (P) cross max
  int* arun = reinterpret_cast<int*>(mrun + P);          // (P) cross arg
  float* red_v = reinterpret_cast<float*>(arun + P);
  int* red_i = reinterpret_cast<int*>(red_v + kRedSlots);

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int len_raw = lengths[b];
  const int len = min(max(len_raw, 0), T);
  const float* xb = feats + (size_t)b * T * D + u0;
  int* bpb = bp + (size_t)b * T * Lp;
  const bool bnd = boundaries && ns > 1;

  // frame 0 always runs (a length-0 row still reports its initial max)
  const int tend = max(len, 1);
  for (int t = 0; t < tend; ++t) {
    fdtk::load_x(xb + (size_t)t * D, x, Du);
    __syncthreads();
    fdtk::form_plane(wall_t, x, smem4, Q, Dw);   // plane = Wall @ [x_t; 1]
    __syncthreads();

    const bool at_end = t == len_raw - 1;
    if (t == 0) {
      for (int l = tid; l < Lp; l += nth) {
        const int st = l % ns;
        float s = plane[l];
        if (bnd) {
          s += st == 0 ? 0.0f : kNegInf;                       // start
          s += (at_end && st != ns - 1) ? kNegInf : 0.0f;      // end
        }
        cand[l] = s;
        bpb[l] = l;
      }
    } else {
      // cross: max over predecessor phones pi of delta[last(pi)] +
      // cross[pi, pj]; strict '>' in pi order keeps the first argmax
      for (int pj = tid; pj < P; pj += nth) {
        const float* cr = plane + 3 * Lp + pj;
        float m = delta[ns - 1] + cr[0];
        int a = 0;
        for (int pi = 1; pi < P; ++pi) {
          const float v = delta[pi * ns + ns - 1] + cr[pi * P];
          if (v > m) {
            m = v;
            a = pi;
          }
        }
        mrun[pj] = m;
        arun[pj] = a;
      }
      __syncthreads();
      for (int l = tid; l < Lp; l += nth) {
        const int st = l % ns, p = l / ns;
        float best;
        int from;
        if (ns == 1) {
          best = mrun[p];
          from = arun[p];
        } else {
          const float self_c = delta[l] + plane[Lp + l];
          const float adv_c =
              st > 0 ? delta[l - 1] + plane[2 * Lp + l - 1] : kNegInf;
          const float cross_c = st == 0 ? mrun[p] : kNegInf;
          best = fmaxf(fmaxf(self_c, adv_c), cross_c);
          from = self_c == best  ? l
                 : adv_c == best ? l - 1
                                 : arun[p] * ns + ns - 1;
        }
        float s = plane[l];
        if (bnd) s += (at_end && st != ns - 1) ? kNegInf : 0.0f;
        cand[l] = best + s;
        bpb[(size_t)t * Lp + l] = from;
      }
    }
    __syncthreads();

    if (use_thr) {
      float m = -INFINITY;
      int unused = 0;
      for (int l = tid; l < Lp; l += nth) m = fmaxf(m, cand[l]);
      block_argmax(m, unused, red_v, red_i);
      const float floor_v = m - thr;
      for (int l = tid; l < Lp; l += nth)
        if (!(cand[l] >= floor_v)) cand[l] = kNegInf;
      __syncthreads();
    }
    // top-k: v survives iff fewer than bw values are strictly greater,
    // which is exactly v >= (the bw-th largest value), ties kept
    for (int l = tid; l < Lp; l += nth) {
      float v = cand[l];
      if (bw > 0) {
        int above = 0;
        for (int j = 0; j < Lp; ++j) above += cand[j] > v;
        if (above >= bw) v = kNegInf;
      }
      delta[l] = v;
    }
    __syncthreads();
  }

  for (size_t i = (size_t)tend * Lp + tid; i < (size_t)T * Lp; i += nth)
    bpb[i] = (int)(i % Lp);

  float v = -INFINITY;
  int a = INT_MAX;
  for (int l = tid; l < Lp; l += nth) take_better(v, a, delta[l], l);
  block_argmax(v, a, red_v, red_i);
  if (tid == 0) {
    score_out[b] = v;
    last_out[b] = a;
  }
}

// One thread per utterance follows the backpointers from T-1 down to 0;
// frames t >= length-1 carry the final label.
__global__ void fdt_vit_tb_kernel(const int* __restrict__ bp,
                                  const int* __restrict__ last,
                                  const int* __restrict__ lengths,
                                  int* __restrict__ paths, int B, int T,
                                  int Lp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* bpb = bp + (size_t)b * T * Lp;
  int* pb = paths + (size_t)b * T;
  const int lst = last[b];
  const int end = min(lengths[b], T) - 1;
  int cur = lst;
  for (int t = T - 1; t >= 0; --t) {
    cur = t >= end ? lst : bpb[(size_t)(t + 1) * Lp + cur];
    pb[t] = cur;
  }
}

}  // namespace

extern "C" {

size_t fdt_viterbi_fwd_smem_bytes(int Du, int ns, int P) {
  return sizeof(float) * fwd_smem_floats(Du, ns, P);
}

const char* fdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fdt_viterbi_fwd(const float* wall_t, const float* feats,
                    const int* lengths, int* bp, int* last, float* score,
                    int B, int T, int D, int u0, int Du, int ns, int P,
                    int boundaries, int use_thr, float thr, int bw,
                    void* stream) {
  const size_t smem = fdt_viterbi_fwd_smem_bytes(Du, ns, P);
  cudaError_t err = cudaFuncSetAttribute(
      fdt_vit_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fdt_vit_fwd_kernel<<<B, kFwdThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      wall_t, feats, lengths, bp, last, score, T, D, u0, Du, ns, P,
      boundaries, use_thr, thr, bw);
  return static_cast<int>(cudaGetLastError());
}

int fdt_viterbi_traceback(const int* bp, const int* last, const int* lengths,
                          int* paths, int B, int T, int Lp, void* stream) {
  const int blocks = (B + kTbThreads - 1) / kTbThreads;
  fdt_vit_tb_kernel<<<blocks, kTbThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      bp, last, lengths, paths, B, T, Lp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
