// Pieces shared by the fdt kernels (fdt_viterbi.cu: K3; fdt_train.cu: K1,
// K2): the semiring zero, the in-block plane formation, and the guarded
// three-way log-sum-exp of the reference.
//
// Plane formation.  Wall is the packed parameter matrix of
// asr_craft_tpu_torch/kernels/wall.py build_wall, passed TRANSPOSED and
// zero-padded as wall_t (Dw, R4) with Dw = Du + 1 (bias last) and R4 = R
// rounded up to a multiple of 4 (kernels/wall.py wall_t4).  One frame's
// plane is Wall @ [x_t; 1]: each thread forms 4 adjacent rows from one
// 16-byte load per input dim, consecutive threads reading consecutive row
// groups (coalesced), with sequential fp32 FMAs over the input dims, bias
// last.  x_t is broadcast from shared memory and the plane stays there.
#pragma once

#include <cuda_runtime.h>

namespace fdtk {

constexpr float kNegInf = -1e30f;   // ops/semiring.py NEG_INF: finite

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

// x[0:Du] = xrow[0:Du] (one frame's input dims), x[Du] = 1 (the bias).
// The caller synchronises before the plane reads x.
__device__ __forceinline__ void load_x(const float* __restrict__ xrow,
                                       float* x, int Du) {
  for (int k = threadIdx.x; k < Du; k += blockDim.x) x[k] = xrow[k];
  if (threadIdx.x == 0) x[Du] = 1.0f;
}

// plane4[q] = rows 4q..4q+3 of Wall @ [x; 1], q < Q = R4 / 4.
__device__ __forceinline__ void form_plane(const float* __restrict__ wall_t,
                                           const float* x, float4* plane4,
                                           int Q, int Dw) {
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const float4* w = reinterpret_cast<const float4*>(wall_t) + q;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int k = 0; k < Dw; ++k) {
      const float4 v = __ldg(w + (size_t)k * Q);
      const float xk = x[k];
      acc.x = fmaf(v.x, xk, acc.x);
      acc.y = fmaf(v.y, xk, acc.y);
      acc.z = fmaf(v.z, xk, acc.z);
      acc.w = fmaf(v.w, xk, acc.w);
    }
    plane4[q] = acc;
  }
}

// log(e^a + e^b + e^c) with the reference's guards (fdt_pallas.py _lse3):
// the max is clamped at NEG_INF and the sum floored at 1e-35.
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(fmaxf(a, b), c), kNegInf);
  return m + logf(fmaxf(expf(a - m) + expf(b - m) + expf(c - m), 1e-35f));
}

}  // namespace fdtk
