// Pieces shared by the port's kernels (fdt_viterbi.cu: K3; fdt_train.cu:
// K1, K2; viterbi.cu: K7, K8; fwdbwd.cu: K4-K6, K14; segmental.cu: K9-K13):
// the semiring zero, the block-wide first argmax of the max-plus decodes,
// the in-block plane formation, the guarded three-way log-sum-exp of the
// reference and, at the end, the pieces of the recursions over one (L, L)
// transition factor held in shared memory.
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

#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

namespace fdtk {

constexpr float kNegInf = -1e30f;   // ops/semiring.py NEG_INF: finite
constexpr int kRedSlots = 33;       // one per warp + one for the result

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

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
// red_v / red_i hold kRedSlots entries.  Two barriers, so consecutive
// calls may reuse them.
__device__ inline void block_argmax(float& v, int& i, float* red_v,
                                    int* red_i) {
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

// ---------------------------------------------------------------------------
// Pieces shared by the log-semiring recursions over one (L, L) transition
// factor (fwdbwd.cu: K4, K5, K6a, K6b, K14; segmental.cu: K9-K13).
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 1024;
constexpr int kGroup = 4;               // lanes per destination's sum
constexpr int kTile = 6;                // a thread's tile of an (L, L) partial
constexpr int kTileThreads = 640;       // ... leaves it ~100 registers
constexpr float kProdFloor = 1e-38f;    // the reference's log floor
constexpr size_t kSmemLimit = 232448;   // bytes a Hopper block may opt into

// kGroup lanes per label, in whole warps; at least two warps (logZ takes
// one warp per lattice)
inline int threads_for(int L) {
  const long n = ((long)L * kGroup + 31) / 32 * 32;
  return n < 64 ? 64 : (n > kMaxThreads ? kMaxThreads : (int)n);
}

// The row stride of an (L, L) factor in shared memory, padded to 8 mod 32 so
// the kGroup lanes of a destination hit different banks.
inline int padded_stride(int L) { return L + ((8 - L % 32) + 32) % 32; }

// m[i] = max(max_l v[i * L + l], NEG_INF), computed by every warp for
// itself, so no barrier is needed before its use.
template <int NLAT>
__device__ __forceinline__ void row_max(const float* v, int L,
                                        float (&m)[NLAT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NLAT; ++i) {
    float x = kNegInf;
    for (int l = lane; l < L; l += 32) x = fmaxf(x, v[i * L + l]);
    for (int o = 16; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    m[i] = x;
  }
}

// acc[i] = sum_p e[i * L + p] * Pm[p * stride + l], the p split over the
// kGroup lanes of a destination (lane g takes p = g, g + kGroup, ...) and
// merged with shuffles: every lane of the group gets the sum.  All lanes of
// the warp must call it; lanes with ok false add nothing.
template <int NLAT>
__device__ __forceinline__ void group_dot(const float* e, const float* Pm,
                                          int stride, int L, int l, int g,
                                          bool ok, float (&acc)[NLAT]) {
#pragma unroll
  for (int i = 0; i < NLAT; ++i) acc[i] = 0.0f;
  if (ok) {
    const float* col = Pm + l;
#pragma unroll 4
    for (int p = g; p < L; p += kGroup) {
      const float w = col[(size_t)p * stride];
#pragma unroll
      for (int i = 0; i < NLAT; ++i) acc[i] = fmaf(e[i * L + p], w, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < NLAT; ++i)
    for (int o = 1; o < kGroup; o <<= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
}

// Copies the (L, L) factor to shared memory with row stride ps.
__device__ __forceinline__ void stage_matrix(const float* __restrict__ Pg,
                                             float* smem, int L, int ps) {
  int r = threadIdx.x / L, c = threadIdx.x % L;
  const int dr = blockDim.x / L, dc = blockDim.x % L;
  for (int i = threadIdx.x; i < L * L; i += blockDim.x) {
    smem[(size_t)r * ps + c] = Pg[i];
    c += dc;
    r += dr;
    if (c >= L) {
      c -= L;
      ++r;
    }
  }
}

// out[i] = sum_b part[b, i], b in order: a fixed summation order
static __global__ void sum_partials_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, int B,
                                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += part[(size_t)b * n + i];
  out[i] = acc;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace fdtk
