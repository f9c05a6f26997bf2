// The matrix products of the frame-dependent-transition CRF on Hopper's
// tensor cores (sm_90a): the planes of every frame, which K1's, K2's and
// K3's recursions read, and K2's contractions, in the model's precision
// (CrfConfig.precision; the recursions stay IEEE fp32 in every mode):
//   highest: fp32 accuracy by 3xTF32 (m16n8k8 TF32 mma);
//   bf16x3:  the reference's split (fdt_pallas.py _mm, :67-100): hi =
//            bf16(x), lo = bf16(x - hi), hi.hi + hi.lo + lo.hi in fp32, on
//            the bf16 tensor cores (m16n8k16 bf16 mma);
//   default: one TF32 pass (cvt.rna on each operand, one m16n8k8 mma where
//            highest issues three).  JAX's Precision.DEFAULT on an fp32 dot
//            is one TF32 pass on an NVIDIA card, and it is the card's
//            single-pass product of fp32 operands; a single bf16 pass would
//            copy the TPU's lowering, not the reference's meaning here.
// Plain C interface, loaded with ctypes by
// asr_craft_tpu_torch/kernels/fdt_train.py, whose fdt_planes_torch and
// contract_wall_torch are the plain versions.
//
// Replaces, in asr_craft_tpu/kernels/fdt_pallas.py:
//   fdt_train_plane_kernel    <- the blocks' plane formation, one matrix-unit
//                                product of TB frames x Bk utterances (_form,
//                                called at :276 in fdt_forward_pallas's
//                                _fwd_kernel, :354 in fdt_backward_grad_
//                                pallas's _bwd_kernel, :930 in fdt_viterbi_
//                                pallas's _fdt_vit_fwd_kernel); a train step
//                                forms the planes once, in its forward, and
//                                the backward reads them again
//   fdt_train_contract_kernel <- the per-block contractions dWall += dplane
//                                @ xu^T and dxu = Wall^T @ dplane (:466-507)
//   fdt_train_sum_kernel      <- the sequential grid's carry of dWall from
//                                block to block
//
// The products.  N = B T frames, R plane rows, Du input dims, xu = [x; 1]:
//   plane (M = N, N = R, K = Du): planes[n, r] = x_n . Wall[r, :Du] +
//     Wall[r, Du], written (B, T, R4) with R4 = R rounded up to 4 (the pad
//     is zero) so every frame's row starts 16-byte aligned for the
//     recursions, which copy it whole with cp.async.bulk;
//   mode 0 (M = R, N = Du + 1, K = N frames): dWall = dplane^T xu, the
//     frames split into gridDim.z chunks summed afterwards in chunk order;
//   mode 1 (M = N, N = Du, K = R): dfeats[n, u0 + d] = dplane[n] . Wall[:, d].
//
// What bounds them on this card.  At the config-2 flagship (B=128, T=512,
// R=2736, Du=144) each product is 52 GFLOP and moves 0.76 GB (the 717 MB
// plane buffer once, written or read), so the tensor cores bind: 3xTF32
// issues three TF32 products per fp32 one, 0.31 ms at 495 / 3 TFLOP/s, where
// the CUDA cores' fp32 rate (67 TFLOP/s) would need 0.78 ms.  bf16x3 (three
// bf16 products, 989 / 3 TFLOP/s: 0.157 ms) and default (one TF32 product:
// 0.105 ms) fall below the 0.23 ms the bytes take at 3.35 TB/s, so the
// memory binds them.
//
// What this design does about it.  One template runs all three: a block
// owns a 128 x 160 output tile (8 warps, each 32 x 80: 2 x 10 m16n8k8 TF32
// mma.sync tiles), its operands staged 16-deep through a 4-stage cp.async
// ring in shared memory, so the copies of the next three stages overlap
// the products of this one.  Every fp32 operand is split as big =
// tf32(a) (cvt.rna), small = tf32(a - big) and the tile accumulates
// small.big + big.small + big.big in fp32.  wgmma would take the plane's
// K-major operands from shared memory, but not the contractions': with
// .tf32 it takes K-major operands only, and mode 0 contracts over the
// frames, along which both dplane and xu are M- or N-major; mma.sync reads
// its fragments from tiles staged in either layout (strides padded so a
// warp's fragment loads hit 32 different banks), so one code path serves
// all three; the precision is a template parameter that changes only how a
// staged tile is split and issued (gemm_tile).  The frames of mode 0 are
// split into chunks so that ~132 blocks (one an SM) each read their share
// of dplane once; the chunk sums are added by a second kernel in a fixed
// order: no atomics, dWall the same bits on every run.  The bias column of
// mode 0 (xu's ones) is a plain fp32 column sum of the staged dplane tile,
// in frame order.  Not done yet: wgmma for the plane, a persistent grid,
// TMA tiles.

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::cp_async16;
using fdtk::cp_async4;
using fdtk::mma;
using fdtk::mma_bf16;
using fdtk::split;
using fdtk::split_bf16;
using fdtk::tf32;

constexpr int kBM = 128, kBN = 160, kBK = 16, kStages = 4, kThreads = 256;
constexpr int kBlocksPerSM = 2;    // registers capped at 128 a thread
constexpr int kWM = 32, kWN = 80;               // one warp's output tile
constexpr int kMI = kWM / 16, kNI = kWN / 8;    // its m16n8 fragments
constexpr int kWarpsM = kBM / kWM;
static_assert(kWarpsM * (kBN / kWN) * 32 == kThreads, "8 warps a block");

// A row-major 2-D operand: element (o, i) at base[o * ld + i], read where
// o < O and i < I, zero elsewhere.
struct View {
  const float* base;
  long long ld;
  int O, I;
};

// A staged tile of EXT rows (of M or N) and kBK depths.  KMAJ: the depth
// is contiguous in memory, stored [EXT][kBK + 4]; else [kBK][EXT + 8].
// Either padding puts a fragment load's 32 lanes on 32 banks.
template <bool KMAJ, int EXT>
struct Tile {
  static constexpr int TO = KMAJ ? EXT : kBK;    // staged rows
  static constexpr int TI = KMAJ ? kBK : EXT;    // staged columns
  static constexpr int SS = KMAJ ? kBK + 4 : EXT + 8;
  static constexpr int FLOATS = TO * SS;
  __device__ static float at(const float* s, int row, int k) {
    return KMAJ ? s[row * SS + k] : s[k * SS + row];
  }
};

// Copy the view's [o0, o0 + TO) x [i0, i0 + TI) into the tile s (zeros
// outside the view), asynchronously.  VEC: 16-byte copies (the base 16-byte
// aligned, ld and i0 multiples of 4); else one float a copy.
template <class TL, bool VEC>
__device__ __forceinline__ void stage(float* s, const View& v, int o0,
                                      int i0) {
  if constexpr (VEC) {
    constexpr int CPR = TL::TI / 4, N = TL::TO * CPR;
    for (int c = threadIdx.x; c < N; c += kThreads) {
      const int o = c / CPR, i = (c - o * CPR) * 4;
      const int go = o0 + o, gi = i0 + i;
      const int n = go < v.O ? min(max(v.I - gi, 0), 4) : 0;
      cp_async16(s + o * TL::SS + i,
                 n ? v.base + go * v.ld + gi : v.base, 4 * n);
    }
  } else {
    constexpr int N = TL::TO * TL::TI;
    for (int c = threadIdx.x; c < N; c += kThreads) {
      const int o = c / TL::TI, i = c - o * TL::TI;
      const int go = o0 + o, gi = i0 + i;
      const bool ok = go < v.O && gi < v.I;
      cp_async4(s + o * TL::SS + i, ok ? v.base + go * v.ld + gi : v.base,
                ok ? 4 : 0);
    }
  }
}

using Acc = float[kMI][kNI][4];

// acc += A B^T over the depths [kb, ke) of the block's tile (rows m0.. of
// A, rows n0.. of B), in the precision PREC (fdt_common.cuh).  AK / BK: the
// operand's view is [row][depth] (depth contiguous) rather than [depth][row].
// colsum (mode 0): threads below kBM also add up column threadIdx.x of every
// staged A tile, in depth order, each value as it meets a 1 (operand<PREC>).
//
// kBf16x3 issues one m16n8k16 step per staged tile.  Its fragments hold
// depths in pairs (slots 2t, 2t+1 and 2t+8, 2t+9 of lane t); since a
// product sums over the depth in any order, slot 2t + j carries depth t +
// 4j and slot 2t + 8 + j depth t + 8 + 4j, in A and B alike: the elements a
// lane reads are those of TF32's two k8 steps, on the same 32 banks.
template <int PREC, bool AK, bool BK, bool VEC>
__device__ __forceinline__ void gemm_tile(float* smem, View a, View b, int m0,
                                          int n0, int kb, int ke, Acc& acc,
                                          bool want_colsum, float& colsum) {
  using TA = Tile<AK, kBM>;
  using TB = Tile<BK, kBN>;
  constexpr int STAGE = TA::FLOATS + TB::FLOATS;
  (AK ? a.I : a.O) = min(AK ? a.I : a.O, ke);
  (BK ? b.I : b.O) = min(BK ? b.I : b.O, ke);
  const int nk = max(ke - kb + kBK - 1, 0) / kBK;
  auto load = [&](int it) {
    float* s = smem + (it % kStages) * STAGE;
    const int k0 = kb + it * kBK;
    if constexpr (AK) stage<TA, VEC>(s, a, m0, k0);
    else stage<TA, VEC>(s, a, k0, m0);
    if constexpr (BK) stage<TB, VEC>(s + TA::FLOATS, b, n0, k0);
    else stage<TB, VEC>(s + TA::FLOATS, b, k0, n0);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    fdtk::cp_async_commit();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % kWarpsM) * kWM, wn = (warp / kWarpsM) * kWN;
  for (int it = 0; it < nk; ++it) {
    fdtk::cp_async_wait<kStages - 2>();   // this thread's copies of tile it
    __syncthreads();                      // everyone's; tile it-1 is free
    if (it + kStages - 1 < nk) load(it + kStages - 1);
    fdtk::cp_async_commit();
    const float* sa = smem + (it % kStages) * STAGE;
    const float* sb = sa + TA::FLOATS;
    if (want_colsum && threadIdx.x < kBM)
      for (int k = 0; k < kBK; ++k)
        colsum += fdtk::operand<PREC>(TA::at(sa, threadIdx.x, k));
    if constexpr (PREC == fdtk::kBf16x3) {
      static_assert(kBK == 16, "one m16n8k16 step a staged tile");
      uint32_t ah[kMI][4], al[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const int r = wm + mi * 16 + g;
#pragma unroll
        for (int q = 0; q < 4; ++q) {     // q: row r or r + 8, depth 0 or 8
          const int row = r + (q & 1) * 8, k = t + (q >> 1) * 8;
          split_bf16(TA::at(sa, row, k), TA::at(sa, row, k + 4), ah[mi][q],
                     al[mi][q]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int c = wn + ni * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_bf16(TB::at(sb, c, t), TB::at(sb, c, t + 4), bh0, bl0);
        split_bf16(TB::at(sb, c, t + 8), TB::at(sb, c, t + 12), bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          mma_bf16(acc[mi][ni], al[mi], bh0, bh1);
          mma_bf16(acc[mi][ni], ah[mi], bl0, bl1);
          mma_bf16(acc[mi][ni], ah[mi], bh0, bh1);
        }
      }
      continue;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      if constexpr (PREC == fdtk::kDefault) {
        uint32_t ab[kMI][4];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          const int r = wm + mi * 16 + g;
          ab[mi][0] = tf32(TA::at(sa, r, kk + t));
          ab[mi][1] = tf32(TA::at(sa, r + 8, kk + t));
          ab[mi][2] = tf32(TA::at(sa, r, kk + t + 4));
          ab[mi][3] = tf32(TA::at(sa, r + 8, kk + t + 4));
        }
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int c = wn + ni * 8 + g;
          const uint32_t bb0 = tf32(TB::at(sb, c, kk + t));
          const uint32_t bb1 = tf32(TB::at(sb, c, kk + t + 4));
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi) mma(acc[mi][ni], ab[mi], bb0, bb1);
        }
        continue;
      }
      uint32_t ab[kMI][4], as[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const int r = wm + mi * 16 + g;
        split(TA::at(sa, r, kk + t), ab[mi][0], as[mi][0]);
        split(TA::at(sa, r + 8, kk + t), ab[mi][1], as[mi][1]);
        split(TA::at(sa, r, kk + t + 4), ab[mi][2], as[mi][2]);
        split(TA::at(sa, r + 8, kk + t + 4), ab[mi][3], as[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int c = wn + ni * 8 + g;
        uint32_t bb0, bs0, bb1, bs1;
        split(TB::at(sb, c, kk + t), bb0, bs0);
        split(TB::at(sb, c, kk + t + 4), bb1, bs1);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          mma(acc[mi][ni], as[mi], bb0, bb1);
          mma(acc[mi][ni], ab[mi], bs0, bs1);
          mma(acc[mi][ni], ab[mi], bb0, bb1);
        }
      }
    }
  }
  fdtk::cp_async_wait<0>();
}

// out[m * ld + col0 + n] = acc (+ bias[n * bias_ld] for n < bias_n) for
// m < M, n < N of the block's tile
struct Out {
  float* p;
  long long ld;
  int col0, M, N;
  const float* bias;
  long long bias_ld;
  int bias_n;
};

// The bias meets xu's column of ones, so it enters as operand<PREC>.
template <int PREC>
__device__ __forceinline__ void store(const Out& o, const Acc& acc, int m0,
                                      int n0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % kWarpsM) * kWM, wn = (warp / kWarpsM) * kWN;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + ni * 8 + 2 * t + (e & 1);
        if (m >= o.M || n >= o.N) continue;
        float v = acc[mi][ni][e];
        if (o.bias && n < o.bias_n)
          v += fdtk::operand<PREC>(o.bias[n * o.bias_ld]);
        o.p[m * o.ld + o.col0 + n] = v;
      }
}

// planes (N, R4) = x (N, Du) Wall[:, :Du]^T + Wall[:, Du]; x_n = feats[n,
// u0:u0+Du], wall_k = Wall[:, :Du] with rows padded to Dk floats.
template <int PREC, bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fdt_train_plane_kernel(const float* __restrict__ feats,
                       const float* __restrict__ wall_k,
                       const float* __restrict__ wall,
                       float* __restrict__ planes, int N, int D, int u0,
                       int Du, int Dk, int R, int R4) {
  extern __shared__ float4 smem4[];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  Acc acc = {};
  float unused = 0.0f;
  gemm_tile<PREC, true, true, VEC>(reinterpret_cast<float*>(smem4),
                             View{feats + u0, D, N, Du},
                             View{wall_k, Dk, R, Du}, m0, n0, 0, Du, acc,
                             false, unused);
  // columns R..R4 have zero B rows and no bias: the pad is written 0
  store<PREC>(Out{planes, R4, 0, N, R4, wall + Du, Du + 1, R}, acc, m0,
              n0);
}

// MODE 0: out + z R (Du+1) = sum over frames [z k_split, (z+1) k_split) of
//   dplane[n]^T [x_n; 1], src = feats;
// MODE 1: out[n, u0:u0+Du] = dplane[n] Wall[:, :Du], src = wall_k (R, Dk).
template <int MODE, int PREC, bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fdt_train_contract_kernel(const float* __restrict__ dplane,
                          const float* __restrict__ src,
                          float* __restrict__ out, int N, int R, int D,
                          int u0, int Du, int Dk, int k_split) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  Acc acc = {};
  float colsum = 0.0f;
  if constexpr (MODE == 0) {
    // A (r, n) = dplane[n, r] and B (d, n) = x_n[d]: both depth-major
    const int kb = blockIdx.z * k_split, ke = min(N, kb + k_split);
    const bool ones = n0 <= Du && Du < n0 + kBN;   // xu's bias column here
    gemm_tile<PREC, false, false, VEC>(smem, View{dplane, R, N, R},
                                 View{src + u0, D, N, Du}, m0, n0, kb, ke,
                                 acc, ones, colsum);
    float* o = out + (size_t)blockIdx.z * R * (Du + 1);
    store<PREC>(Out{o, Du + 1, 0, R, Du, nullptr, 0, 0}, acc, m0, n0);
    const int r = m0 + threadIdx.x;
    if (ones && threadIdx.x < kBM && r < R)
      o[(size_t)r * (Du + 1) + Du] = colsum;
  } else {
    // A (n, r) = dplane[n, r] depth-contiguous, B (d, r) = Wall[r, d]
    gemm_tile<PREC, true, false, VEC>(smem, View{dplane, R, N, R},
                                View{src, Dk, R, Du}, m0, n0, 0, R, acc,
                                false, colsum);
    store<PREC>(Out{out, D, u0, N, Du, nullptr, 0, 0}, acc, m0, n0);
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

template <bool AK, bool BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * kStages *
         (Tile<AK, kBM>::FLOATS + Tile<BK, kBN>::FLOATS);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
           Args... args) {
  const cudaError_t err = fdtk::opt_in(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int cdiv(long long a, int b) { return static_cast<int>((a + b - 1) / b); }


// kernel<PREC>(...) for the runtime precision: fn is called with a tag
// whose ::value is the precision (fdtk::Precision)
template <typename Fn>
int by_precision(int precision, Fn fn) {
  switch (precision) {
    case fdtk::kHighest:
      return fn(std::integral_constant<int, fdtk::kHighest>{});
    case fdtk::kBf16x3:
      return fn(std::integral_constant<int, fdtk::kBf16x3>{});
    case fdtk::kDefault:
      return fn(std::integral_constant<int, fdtk::kDefault>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The tile geometry the callers plan dWall's split of the frames with: the
// rows of dWall a block computes, and the blocks an SM holds.
int fdt_mma_tile_rows() { return kBM; }
int fdt_mma_blocks_per_sm() { return kBlocksPerSM; }

// wall_k (R, Dk): Wall[:, :Du] in rows of Dk >= Du floats (Dk % 4 == 0);
// wall: the packed Wall (R, Du+1), read for its bias column; precision:
// fdtk::Precision (0 highest, 1 bf16x3, 2 default).
int fdt_train_plane(const float* feats, const float* wall_k,
                    const float* wall, float* planes, int N, int D, int u0,
                    int Du, int Dk, int R, int R4, int precision,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(cdiv(R4, kBN), cdiv(N, kBM));
  const size_t smem = smem_bytes<true, true>();
  const bool vec = aligned16(feats) && D % 4 == 0 && u0 % 4 == 0 &&
                   aligned16(wall_k) && Dk % 4 == 0;
  auto args = [&](auto kernel) {
    return launch(kernel, grid, smem, s, feats, wall_k, wall, planes, N, D,
                  u0, Du, Dk, R, R4);
  };
  return by_precision(precision, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return vec ? args(&fdt_train_plane_kernel<P, true>)
               : args(&fdt_train_plane_kernel<P, false>);
  });
}

// mode 0: out (R, Du+1) = dplane^T [x; 1] from src = feats (B T, D), the
// frames in `splits` chunks of whole kBK steps summed into part (splits,
// R, Du+1) and then into out in chunk order (splits <= 1: one chunk, no
// part).  mode 1: out (N, D) columns u0..u0+Du = dplane Wall[:, :Du] from
// src = wall_k (R, Dk).  precision: as fdt_train_plane's.
int fdt_train_contract(const float* dplane, const float* src, float* out,
                       float* part, int mode, int N, int R, int D, int u0,
                       int Du, int Dk, int splits, int precision,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dvec = aligned16(dplane) && R % 4 == 0 && aligned16(src);
  if (mode == 1) {
    const dim3 grid(cdiv(Du, kBN), cdiv(N, kBM));
    const size_t smem = smem_bytes<true, false>();
    auto args = [&](auto kernel) {
      return launch(kernel, grid, smem, s, dplane, src, out, N, R, D, u0, Du,
                    Dk, 0);
    };
    return by_precision(precision, [&](auto p) {
      constexpr int P = decltype(p)::value;
      return dvec && Dk % 4 == 0
                 ? args(&fdt_train_contract_kernel<1, P, true>)
                 : args(&fdt_train_contract_kernel<1, P, false>);
    });
  }
  if (splits < 1 || part == nullptr) splits = 1;
  const int k_split = cdiv(cdiv(N, splits), kBK) * kBK;
  const int used = cdiv(N, k_split);
  const dim3 grid(cdiv(Du + 1, kBN), cdiv(R, kBM), used);
  const size_t smem = smem_bytes<false, false>();
  float* dst = used > 1 ? part : out;
  auto args = [&](auto kernel) {
    return launch(kernel, grid, smem, s, dplane, src, dst, N, R, D, u0, Du,
                  Dk, k_split);
  };
  const bool vec = dvec && D % 4 == 0 && u0 % 4 == 0;
  const int err = by_precision(precision, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return vec ? args(&fdt_train_contract_kernel<0, P, true>)
               : args(&fdt_train_contract_kernel<0, P, false>);
  });
  if (err != 0 || used <= 1) return err;
  const size_t n = (size_t)R * (Du + 1);
  fdt_train_sum_kernel<<<cdiv((long long)n, 256), 256, 0, s>>>(part, out, n,
                                                               used);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
