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
//                                (beta recursion and xi/gamma statistics)
//   fdt_train_contract_kernel <- the same body's per-block contractions
//                                dWall += dplane @ xu^T and dxu = Wall^T @
//                                dplane, which the TPU runs in-kernel on
//                                its matrix unit
//
// Layouts.  Wall (R, Du+1) packed by kernels/wall.build_wall, rows
// [state L' | self L' | adv L' | cross P*P (pi-major)], all state-major;
// the recursions read it as wall_t (fdt_common.cuh).  feats (B, T, D) f32,
// labels (B, T) i32 at clamp_ns granularity (clamp_ns = ns: phone labels,
// 1: state labels), lengths (B,) i32.  alphas (B, T, 2, L') f32: frame t's
// free then clamped alpha, every frame (frames t >= length keep the carry).
// zf, zc (B,) the log-partitions; wf, wc (B,) their cotangents.  dplane
// (B, T, R) f32: d(wf zf + wc zc) / d(plane row r at frame t) -- the state
// rows hold the posteriors gamma_t, the transition rows of frame t the xi
// of the transitions into frame t (zero at frame 0 and at t >= length).
//
// What bounds them on this card.  Time is a serial loop: one block owns
// one utterance and walks its frames (forward up, backward down), so
// B=128 fills 128 of the 132 SMs.  Each frame forms its plane (R x Dw
// FMAs, 2736 x 145 at the config-2 flagship) from a Wall (1.59 MB) that
// does not fit one SM's shared memory and is re-read from L2 every frame:
// the SM's L2 port bounds a frame.  The semiring work (2 lattices x (L'
// elementwise + P x P cross lse)) is small beside it, and K2 adds 2 R
// exponentials a frame for the xi.  K2's output dplane is 4 R bytes a
// frame: 717 MB at B=128, T=512, written once and read by the contraction
// (once per 64-column tile of dWall, three times).  The contraction is
// 2 N R (Du+1) FLOPs (N = B T; 52 GFLOP at the flagship) in fp32 FMAs.
//
// What this first design does about it.  The plane never leaves shared
// memory in either recursion (K2 re-forms frame t+1's plane instead of
// storing planes, as the TPU kernel does); frames past a row's length are
// neither formed nor updated.  dWall is shared by every utterance, and
// Hopper blocks run in parallel with no carry between them, so K2 writes
// dplane to device memory and a second, separate kernel contracts it:
// each block owns a 64 x 64 output tile and one chunk of the frames
// (register-blocked 4 x 4 per thread, 16-deep shared-memory tiles); the
// 43 x 3 tiles of the flagship's dWall alone would fill one block per SM,
// so the frames are split into up to 16 chunks and a third kernel adds
// the chunks' partial sums in a fixed order.  The gradient is the same
// from run to run -- no atomics.  The feature cotangent (grad_feats) is
// the same kernel with the other operand layout.  Not done yet: tensor
// cores (3xTF32 for fp32 accuracy), and keeping Wall resident across a
// cluster of blocks.
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
constexpr int kTile = 64;           // contraction output tile (rows, cols)
constexpr int kTileK = 16;          // contraction depth per shared tile
constexpr int kContractThreads = 256;

size_t fwd_smem_floats(int Du, int ns, int P) {
  const size_t Lp = (size_t)ns * P;
  // plane (16-byte aligned first) | x | alpha (2 L') | cand (2 L') | crossed
  return round_up4(3 * ns * P + P * P) + (size_t)(Du + 1) + 4 * Lp +
         2 * (size_t)P;
}

size_t bwd_smem_floats(int Du, int ns, int P) {
  const size_t Lp = (size_t)ns * P;
  // plane | x | beta (2 L') | xs (2 L') | alpha_t (2 L') | crossb (2 P)
  return round_up4(3 * ns * P + P * P) + (size_t)(Du + 1) + 6 * Lp +
         2 * (size_t)P;
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

__global__ void __launch_bounds__(kThreads)
fdt_train_bwd_kernel(const float* __restrict__ wall_t,
                     const float* __restrict__ feats,
                     const int* __restrict__ labels,
                     const int* __restrict__ lengths,
                     const float* __restrict__ alphas,
                     const float* __restrict__ zf,
                     const float* __restrict__ zc,
                     const float* __restrict__ wf,
                     const float* __restrict__ wc,
                     float* __restrict__ dplane, int T, int D, int u0,
                     int Du, int ns, int P, int clamp_ns, int boundaries) {
  extern __shared__ float4 smem4[];
  const int Lp = ns * P, L2 = 2 * Lp, Dw = Du + 1, R = 3 * Lp + P * P;
  const int R4 = round_up4(R), Q = R4 / 4;
  float* plane = reinterpret_cast<float*>(smem4);        // (R4) frame t+1
  float* x = plane + R4;                                 // (Dw)
  float* beta = x + Dw;                                  // (2 L')
  float* xs = beta + L2;                                 // (2 L') beta+state2
  float* at = xs + L2;                                   // (2 L') alpha_t
  float* crossb = at + L2;                               // (2 P)

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int len_raw = lengths[b];
  const int len = min(max(len_raw, 0), T);
  const float* xb = feats + (size_t)b * T * D + u0;
  const int* lab = labels + (size_t)b * T;
  const float* ab = alphas + (size_t)b * T * L2;
  float* dp = dplane + (size_t)b * T * R;
  const bool bnd = boundaries && ns > 1;
  // per lattice h: log-partition, cotangent weight, and whether it lives
  // (a dead lattice, with no legal path, contributes zero gradient)
  const float z0 = zf[b], z1 = zc[b], w0 = wf[b], w1 = wc[b];
  const bool live0 = z0 > kNegInf * 0.5f, live1 = z1 > kNegInf * 0.5f;

  for (size_t i = (size_t)len * R + tid; i < (size_t)T * R; i += nth)
    dp[i] = 0.0f;
  if (len >= 1)                         // frame 0 has no transition
    for (int r = Lp + tid; r < R; r += nth) dp[r] = 0.0f;
  for (int i = tid; i < L2; i += nth) beta[i] = 0.0f;

  for (int t = len - 1; t >= 0; --t) {
    for (int i = tid; i < L2; i += nth) at[i] = ab[(size_t)t * L2 + i];
    if (t + 1 < len) {                  // frame t+1 exists
      const int n = t + 1;
      fdtk::load_x(xb + (size_t)n * D, x, Du);
      __syncthreads();
      fdtk::form_plane(wall_t, x, smem4, Q, Dw);
      __syncthreads();
      const int y = lab[n];
      const bool bnd_end = bnd && n == len_raw - 1;
      for (int i = tid; i < L2; i += nth) {
        const int h = i / Lp, l = i - h * Lp, st = l % ns;
        xs[i] = beta[i] + plane[l] +
                state_mask(h, l, st, ns, bnd_end, clamp_ns, y);
      }
      __syncthreads();
      // xi of the transitions into frame n, summed over the two lattices
      float* dpn = dp + (size_t)n * R;
      for (int r = Lp + tid; r < R; r += nth) {
        float v = 0.0f;
        for (int h = 0; h < 2; ++h) {
          if (!(h ? live1 : live0)) continue;
          const float* a = at + h * Lp;
          const float* xh = xs + h * Lp;
          float s;
          if (r < 2 * Lp) {                              // self
            if (ns == 1) continue;
            const int l = r - Lp;
            s = a[l] + plane[r] + xh[l];
          } else if (r < 3 * Lp) {                       // advance
            const int l = r - 2 * Lp;
            if (ns == 1 || l % ns == ns - 1) continue;
            s = a[l] + plane[r] + xh[l + 1];
          } else {                                       // cross
            const int k = r - 3 * Lp, pi = k / P, pj = k - pi * P;
            s = a[pi * ns + ns - 1] + plane[r] + xh[pj * ns];
          }
          v += expf(fminf(s - (h ? z1 : z0), 40.0f)) * (h ? w1 : w0);
        }
        dpn[r] = v;
      }
      // crossb[h, pi] = lse_pj(xs_h[first(pj)] + cross[pi, pj])
      for (int i = tid; i < 2 * P; i += nth) {
        const int h = i / P, pi = i - h * P;
        const float* xh = xs + h * Lp;
        const float* cr = plane + 3 * Lp + pi * P;
        float m = -INFINITY;
        for (int pj = 0; pj < P; ++pj) m = fmaxf(m, xh[pj * ns] + cr[pj]);
        m = fmaxf(m, kNegInf);
        float s = 0.0f;
        for (int pj = 0; pj < P; ++pj) s += expf(xh[pj * ns] + cr[pj] - m);
        crossb[i] = m + logf(fmaxf(s, 1e-35f));
      }
      __syncthreads();
      for (int i = tid; i < L2; i += nth) {
        const int h = i / Lp, l = i - h * Lp, st = l % ns, p = l / ns;
        if (ns == 1) {
          beta[i] = crossb[h * P + p];
        } else {
          const float self_c = xs[i] + plane[Lp + l];
          const float adv_c = st < ns - 1 ? xs[i + 1] + plane[2 * Lp + l]
                                          : kNegInf;
          const float cross_c = st == ns - 1 ? crossb[h * P + p] : kNegInf;
          beta[i] = lse3(self_c, adv_c, cross_c);
        }
      }
    } else {
      for (int i = tid; i < L2; i += nth) beta[i] = 0.0f;
    }
    __syncthreads();
    // gamma_t: the state rows of frame t
    for (int l = tid; l < Lp; l += nth) {
      float g = 0.0f;
      if (live0) g += expf(fminf(at[l] + beta[l] - z0, 40.0f)) * w0;
      if (live1)
        g += expf(fminf(at[Lp + l] + beta[Lp + l] - z1, 40.0f)) * w1;
      dp[(size_t)t * R + l] = g;
    }
    __syncthreads();
  }
}

// C = A B over a 64 x 64 output tile per block, summed over k in one fixed
// order.  mode 0 (dWall): C (R, Du+1) = sum_n dplane[n, r] xu[n, d] with
// xu[n] = [feats[n, u0:u0+Du]; 1]; M = R, Nc = Du+1, K = N frames.  The
// frames are split into gridDim.z chunks of k_split: block z writes its
// chunk's sum to out + z M Nc, and fdt_train_sum_kernel adds the chunks
// in order (split-K without atomics, so still deterministic).
// mode 1 (dfeats): out[n, u0 + d] = sum_r dplane[n, r] Wall[r, d];
// M = N frames, Nc = Du, K = R, one chunk.
__global__ void __launch_bounds__(kContractThreads)
fdt_train_contract_kernel(const float* __restrict__ dplane,
                          const float* __restrict__ src,
                          float* __restrict__ out, int mode, int M, int Nc,
                          int K, int k_split, int R, int D, int u0, int Du) {
  __shared__ __align__(16) float As[kTileK][kTile];
  __shared__ __align__(16) float Bs[kTileK][kTile];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  const int kb = blockIdx.z * k_split, ke = min(K, kb + k_split);
  if (mode == 0) out += (size_t)blockIdx.z * M * Nc;
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += kTileK) {
    for (int e = tid; e < kTile * kTileK; e += kContractThreads) {
      int i, k;
      if (mode == 0) {                  // A[i=r, k=n]: coalesced along r
        i = e % kTile;
        k = e / kTile;
      } else {                          // A[i=n, k=r]: coalesced along r
        k = e % kTileK;
        i = e / kTileK;
      }
      const int gi = i0 + i, gk = k0 + k;
      float v = 0.0f;
      if (gi < M && gk < ke)
        v = mode == 0 ? dplane[(size_t)gk * R + gi]
                      : dplane[(size_t)gi * R + gk];
      As[k][i] = v;
      const int j = e % kTile, kj = e / kTile;
      const int gj = j0 + j, gkj = k0 + kj;
      float u = 0.0f;
      if (gj < Nc && gkj < ke) {
        if (mode == 0)
          u = gj < Du ? src[(size_t)gkj * D + u0 + gj] : 1.0f;
        else
          u = src[(size_t)gkj * (Du + 1) + gj];
      }
      Bs[kj][j] = u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + ty * 4 + r;
    if (gi >= M) continue;
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + tx * 4 + c;
      if (gj >= Nc) continue;
      if (mode == 0)
        out[(size_t)gi * (Du + 1) + gj] = acc[r][c];
      else
        out[(size_t)gi * D + u0 + gj] = acc[r][c];
    }
  }
}

// out[e] = sum over chunks z = 0, 1, .. of part[z, e], in that order.
__global__ void fdt_train_sum_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, size_t n,
                                     int splits) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + e];
    out[e] = s;
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

size_t fdt_train_bwd_smem_bytes(int Du, int ns, int P) {
  return sizeof(float) * bwd_smem_floats(Du, ns, P);
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

int fdt_train_bwd(const float* wall_t, const float* feats, const int* labels,
                  const int* lengths, const float* alphas, const float* zf,
                  const float* zc, const float* wf, const float* wc,
                  float* dplane, int B, int T, int D, int u0, int Du, int ns,
                  int P, int clamp_ns, int boundaries, void* stream) {
  const size_t smem = fdt_train_bwd_smem_bytes(Du, ns, P);
  const int err = set_smem((const void*)fdt_train_bwd_kernel, smem);
  if (err != 0) return err;
  fdt_train_bwd_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      wall_t, feats, labels, lengths, alphas, zf, zc, wf, wc, dplane, T, D,
      u0, Du, ns, P, clamp_ns, boundaries);
  return static_cast<int>(cudaGetLastError());
}

// splits > 1 (mode 0 only) sums the frames in up to `splits` chunks into
// part (splits, R, Du+1), then adds the chunks into out.
int fdt_train_contract(const float* dplane, const float* src, float* out,
                       float* part, int mode, int N, int R, int D, int u0,
                       int Du, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = mode == 0 ? R : N;
  const int Nc = mode == 0 ? Du + 1 : Du;
  const int K = mode == 0 ? N : R;
  if (mode != 0 || splits < 1) splits = 1;
  // chunks of whole kTileK steps; `used` <= splits of them cover K
  const int k_split =
      ((K + splits - 1) / splits + kTileK - 1) / kTileK * kTileK;
  const int used = (K + k_split - 1) / k_split;
  const dim3 grid((M + kTile - 1) / kTile, (Nc + kTile - 1) / kTile,
                  used);
  fdt_train_contract_kernel<<<grid, kContractThreads, 0, s>>>(
      dplane, src, used > 1 ? part : out, mode, M, Nc, K, k_split, R, D, u0,
      Du);
  if (used > 1) {
    const size_t n = (size_t)M * Nc;
    const int blocks = (int)((n + 255) / 256);
    fdt_train_sum_kernel<<<blocks, 256, 0, s>>>(part, out, n, used);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
