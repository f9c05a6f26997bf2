// The matrix products of the frame-dependent-transition CRF on Hopper's
// tensor cores (sm_90a): the planes of every frame, which K1's, K2's and
// K3's recursions read, and K2's contractions, in the model's precision
// (CrfConfig.precision; the recursions stay IEEE fp32 in every mode):
//   highest: fp32 accuracy by 3xTF32 (TF32 mma.sync m16n8k8; in the plane
//            wgmma k8);
//   bf16x3:  the reference's split (fdt_pallas.py _mm, :67-100): hi =
//            bf16(x), lo = bf16(x - hi), hi.hi + hi.lo + lo.hi in fp32, on
//            the bf16 tensor cores (mma.sync m16n8k16; in the plane wgmma
//            k16);
//   default: one TF32 pass (cvt.rna on each operand, one TF32 product
//            where highest issues three).  JAX's Precision.DEFAULT on an fp32 dot
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
// plane buffer once, written or read).  3xTF32 issues three TF32 products
// per fp32 one, 0.31 ms at 495 / 3 TFLOP/s, where the CUDA cores' fp32 rate
// (67 TFLOP/s) would need 0.78 ms: the tensor cores bind highest.  bf16x3
// (three bf16 products, 989 / 3 TFLOP/s: 0.157 ms) and default (one TF32
// product: 0.105 ms) fall below the 0.23 ms the bytes take at 3.35 TB/s,
// so the memory binds them, and the plane, whose depth is short (Du = 144)
// and whose output is wide (R4 = 2736 floats a frame), is a stream of
// writes.
//
// What the plane's design does about it (PATH kPathWgmma, below).  One
// persistent block an SM: a producer thread brings each tile of 64 frames
// a consumer warpgroup into shared memory by TMA; the consumer splits its
// frames once in registers and issues wgmma (A in registers, B the block's
// slab of Wall, split once into hi/lo or big/small in shared memory), adds
// the bias, stages the 64 x NS tile and sends it back by one TMA store,
// which overlaps the next tile's loads and products.  The tiles go frame
// tile by frame tile with every block on its own slab, so the frames each
// slab reads again are still in L2 while the planes stream out.  On an
// H100 SXM at 700 W: bf16x3 B=128 T=512 0.31 ms against the bytes' 0.23
// (2.3 TB/s; the mma.sync tiles take 1.19), default 0.34 (1.06), highest
// B=64 0.27 against its products' 0.16 (0.74).  What is left: the stage's
// 4-way bank conflicts at 128 columns, the consumers' own split of the
// frames, and highest's tensor cores.
//
// The contractions' design (and the plane's where the wgmma path does not
// take its inputs: rows of frames not 16-byte aligned, or Du > 144).  One
// template runs all three precisions: a block
// owns a 128 x 160 output tile (8 warps, each 32 x 80: 2 x 10 m16n8k8 TF32
// mma.sync tiles), its operands staged 16-deep through a 4-stage cp.async
// ring in shared memory, so the copies of the next three stages overlap
// the products of this one.  Every fp32 operand is split as big =
// tf32(a) (cvt.rna), small = tf32(a - big) and the tile accumulates
// small.big + big.small + big.big in fp32.  wgmma takes the plane's
// K-major operands, but not the contractions': with
// .tf32 it takes K-major operands only, and mode 0 contracts over the
// frames, along which both dplane and xu are M- or N-major; mma.sync reads
// its fragments from tiles staged in either layout (strides padded so a
// warp's fragment loads hit 32 different banks), so one code path serves
// them; the precision is a template parameter that changes only how a
// staged tile is split and issued (gemm_tile).  The frames of mode 0 are
// split into chunks so that ~132 blocks (one an SM) each read their share
// of dplane once; the chunk sums are added by a second kernel in a fixed
// order: no atomics, dWall the same bits on every run.  The bias column of
// mode 0 (xu's ones) is a plain fp32 column sum of the staged dplane tile,
// in frame order.

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::cp_async16;
using fdtk::cp_async4;
using fdtk::mma;
using fdtk::mma_bf16;
using fdtk::named_sync;
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

// ---------------------------------------------------------------------------
// The plane on the warpgroup products (PATH kPathWgmma): a persistent block
// on each SM, a producer thread streaming tiles of frames into shared memory
// by TMA, two consumer warpgroups issuing wgmma with the frames' tile in
// registers and the block's slab of Wall, split once, in shared memory, and
// each output tile sent back by a TMA store.
// ---------------------------------------------------------------------------

constexpr int kPathScalar = 0, kPathVec = 1, kPathWgmma = 2;
constexpr int kPlaneKP = 144;           // the depth a slab holds (Du <= 144)
constexpr int kPlaneQ = kPlaneKP / 4;   // the depths of a row a lane reads
constexpr int kPlaneWgRows = 64;        // frames of a warpgroup's tile
constexpr int kPlaneWgs = 2;            // consumer warpgroups
constexpr int kPlaneTileRows = kPlaneWgRows * kPlaneWgs;
constexpr int kPlaneWgThreads = 128 * kPlaneWgs;
constexpr int kPlaneThreads = kPlaneWgThreads + 32;   // + the producer warp

template <int PATH>
constexpr int kPlaneBlockThreads = PATH == kPathWgmma ? kPlaneThreads
                                                      : kThreads;
template <int PATH>
constexpr int kPlaneBlocksPerSM = PATH == kPathWgmma ? 1 : kBlocksPerSM;

// The geometry of the wgmma path at one precision.  A slab is NS columns of
// the plane (NS rows of Wall) at the full depth kPlaneKP, held as kCopies
// split copies (bf16x3: hi, lo in bf16; highest: big, small in TF32;
// default: one TF32 copy), each of NS x kPlaneKP elements of kEsize bytes in
// wgmma's no-swizzle K-major layout: 8 x 16-byte core matrices, core (n / 8,
// kc) at byte (n / 8 * kChunks + kc) * 128, so chunk c of a copy sits at
// byte 16 c.  NS divides the SMs' 132 by slabs (2736 columns: 22 of 128,
// 32 of 88), and highest's copies take twice the bytes, so its slab is
// narrower; its frames' split goes in two parts of the depth, to hold each
// part's big and small in registers.
template <int PREC>
struct PlaneCfg {
  static constexpr bool kBf16 = PREC == fdtk::kBf16x3;
  static constexpr int NS = PREC == fdtk::kHighest ? 88 : 128;
  static constexpr int kParts = PREC == fdtk::kHighest ? 2 : 1;
  static constexpr int kCopies = PREC == fdtk::kDefault ? 1 : 2;
  static constexpr int kEsize = kBf16 ? 2 : 4;
  static constexpr int kChunks = kPlaneKP * kEsize / 16;   // a row's chunks
  static constexpr int kPer = kBf16 ? 1 : 2;     // wgmma steps a float4 holds
  static constexpr int kCopyBytes = NS * kPlaneKP * kEsize;
  static constexpr int kRawFloats = kPlaneWgRows * kPlaneKP;   // a WG's
  static constexpr int kOutFloats = kPlaneWgRows * NS;         // a WG's
  static constexpr int kRaw = kCopies * kCopyBytes;            // offsets
  static constexpr int kOut = kRaw + kPlaneWgs * kRawFloats * 4;
  static constexpr int kBias = kOut + kPlaneWgs * kOutFloats * 4;
  static constexpr int kBars = kBias + NS * 4;
  static constexpr int kSmem = kBars + 2 * kPlaneWgs * 8 + 128;   // + align
  static_assert(kSmem <= 232448, "one block an SM");
  static_assert(NS % 8 == 0 && kBias % 16 == 0 && kBars % 8 == 0, "layout");
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival on `bar` that also expects `bytes` of copies on it
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(fdtk::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// The box of `map` at (column c0, row c1) from global memory into shared
// memory (128-byte aligned), completing on `bar`; boxes past the tensor's
// edges read zeros (and count their bytes)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(fdtk::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(fdtk::smem_addr(bar))
      : "memory");
}

// The box of `map` at (column c0, row c1) from shared memory to global
// memory, in this thread's bulk group; what lies past the tensor's edges is
// not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0,
                                          int c1, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(fdtk::smem_addr(src))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory (READ) or are done
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A shared-memory matrix descriptor of wgmma, no swizzle: lbo the bytes
// between the two core matrices of a step's depth, sbo between 8-row groups
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((fdtk::smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The compiler must neither move an accumulator's or an operand's register
// across the asynchronous products nor reuse it while they run.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int S>
__device__ __forceinline__ void hold(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}

#define FDT_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FDT_D16(i) FDT_D4(i), FDT_D4(i + 4), FDT_D4(i + 8), FDT_D4(i + 12)
#define FDT_D44 FDT_D16(0), FDT_D16(16), FDT_D4(32), FDT_D4(36), FDT_D4(40)
#define FDT_D64 FDT_D16(0), FDT_D16(16), FDT_D16(32), FDT_D16(48)
#define FDT_R44                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43"
#define FDT_R64                                                            \
  FDT_R44 ", %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// d (the warpgroup's 64 x N fp32 tile, N / 2 values a thread) += a b^T: a
// the 64 x k operand in registers (mma.sync's A fragment, a warp's 16
// rows), b the N x k operand in shared memory (a descriptor), K-major both;
// bf16 (k = 16) or TF32 (k = 8) operands.  N = 128 (bf16x3, default) or 88
// (highest).
template <bool BF16>
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t b) {
  if constexpr (BF16)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 "{" FDT_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
                 : FDT_D64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
                 "{" FDT_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : FDT_D64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
}

template <bool BF16>
__device__ __forceinline__ void wgmma(float (&d)[44], const uint32_t (&a)[4],
                                      uint64_t b) {
  static_assert(!BF16, "the 88-column slab is highest's");
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n88k8.f32.tf32.tf32 "
               "{" FDT_R44 "}, {%44, %45, %46, %47}, %48, p, 1, 1;\n}\n"
               : FDT_D44
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(1));
}

#undef FDT_R64
#undef FDT_R44
#undef FDT_D64
#undef FDT_D44
#undef FDT_D16
#undef FDT_D4


#undef FDT_R64
#undef FDT_D64

#undef FDT_D4


#undef FDT_R60
#undef FDT_D60

#undef FDT_R64
#undef FDT_D64

#undef FDT_R72
#undef FDT_D72

#undef FDT_D4

// The slab of Wall's rows [c0, c0 + NS) at every depth, split into its
// copies (rows past R and depths past Du zero), and the bias of its columns
// as operand<PREC> (zero past R), by the consumer warpgroups.  The depths
// are permuted so that a lane's share of a frame is one contiguous run of
// its row (plane_split): with Q = kPlaneQ, lane quarter t = lane % 4, step
// s and half h, a step's depth k is the row's depth
//   bf16 (k16): 16 s + 8 h + 2 t + j  ->  Q t + 4 s + 2 h + j  (j = 0, 1)
//   TF32 (k8):   8 s + 4 h + t        ->  Q t + 2 s + h
// A product sums over the depth in any order, and both operands take the
// same permutation.
template <int PREC>
__device__ __forceinline__ void plane_slab(unsigned char* smem,
                                           const float* __restrict__ wall_k,
                                           const float* __restrict__ wall,
                                           int c0, int Du, int Dk, int R) {
  using C = PlaneCfg<PREC>;
  for (int c = threadIdx.x; c < C::NS * C::kChunks; c += kPlaneWgThreads) {
    const int kc = (c >> 3) % C::kChunks, s = kc >> 1, h = kc & 1;
    const int r = c0 + (c >> 3) / C::kChunks * 8 + (c & 7);
    const float* w = wall_k + (size_t)r * Dk;
    auto at = [&](int d) { return r < R && d < Du ? w[d] : 0.0f; };
    uint32_t x[4], y[4] = {};          // chunk c of copies 0 and 1
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if constexpr (C::kBf16) {
        const int d = kPlaneQ * t + 4 * s + 2 * h;
        fdtk::split_bf16(at(d), at(d + 1), x[t], y[t]);
      } else if constexpr (PREC == fdtk::kHighest) {
        fdtk::split(at(kPlaneQ * t + 2 * s + h), x[t], y[t]);
      } else {
        x[t] = fdtk::tf32(at(kPlaneQ * t + 2 * s + h));
      }
    }
    *reinterpret_cast<uint4*>(smem + 16 * c) = make_uint4(x[0], x[1], x[2],
                                                          x[3]);
    if constexpr (C::kCopies == 2)
      *reinterpret_cast<uint4*>(smem + C::kCopyBytes + 16 * c) =
          make_uint4(y[0], y[1], y[2], y[3]);
  }
  float* bias = reinterpret_cast<float*>(smem + C::kBias);
  for (int n = threadIdx.x; n < C::NS; n += kPlaneWgThreads)
    bias[n] = c0 + n < R
                  ? fdtk::operand<PREC>(wall[(size_t)(c0 + n) * (Du + 1) + Du])
                  : 0.0f;
}

// A warpgroup's frame operand at the depths of float4s [Q0, Q1) of the
// lane's run (plane_slab) in its rows of the tile (p0, and p1 8 rows
// below), split as the precision splits: bf16 hi / lo (one k16 step a
// float4), TF32 big / small (highest) or one rounding (default), two k8
// steps a float4; copy 0 (hi, big) into a0, copy 1 (lo, small) into a1.
template <int PREC, int Q0, int Q1, int S>
__device__ __forceinline__ void plane_split(const float* p0, const float* p1,
                                            uint32_t (&a0)[S][4],
                                            uint32_t (&a1)[S][4]) {
  constexpr int PER = PlaneCfg<PREC>::kPer;
  static_assert(S == (Q1 - Q0) * PER, "the part's steps");
#pragma unroll
  for (int q = Q0; q < Q1; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(p0 + 4 * q);
    const float4 y = *reinterpret_cast<const float4*>(p1 + 4 * q);
    const int j = (q - Q0) * PER;
    if constexpr (PER == 1) {
      fdtk::split_bf16(x.x, x.y, a0[j][0], a1[j][0]);
      fdtk::split_bf16(y.x, y.y, a0[j][1], a1[j][1]);
      fdtk::split_bf16(x.z, x.w, a0[j][2], a1[j][2]);
      fdtk::split_bf16(y.z, y.w, a0[j][3], a1[j][3]);
    } else {
      const float v[2][4] = {{x.x, y.x, x.y, y.y}, {x.z, y.z, x.w, y.w}};
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (PREC == fdtk::kHighest)
            fdtk::split(v[e][i], a0[j + e][i], a1[j + e][i]);
          else
            a0[j + e][i] = fdtk::tf32(v[e][i]);
        }
    }
  }
}

// acc += the products of steps [J0, J0 + S): lo.hi + hi.lo + hi.hi
// (small.big + big.small + big.big) or one TF32 pass; b0 and b1 describe
// copies 0 and 1 of the slab.  Returns once they are done.
template <int PREC, int J0, int S>
__device__ __forceinline__ void plane_mma(
    float (&acc)[PlaneCfg<PREC>::NS / 2], uint32_t (&a0)[S][4],
    uint32_t (&a1)[S][4], uint64_t b0, uint64_t b1) {
  using C = PlaneCfg<PREC>;
  hold(acc);
  hold(a0);
  if constexpr (C::kCopies == 2) hold(a1);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const uint64_t step = 16 * (J0 + j);         // 256 bytes a step
    if constexpr (C::kCopies == 2) {
      wgmma<C::kBf16>(acc, a1[j], b0 + step);
      wgmma<C::kBf16>(acc, a0[j], b1 + step);
    }
    wgmma<C::kBf16>(acc, a0[j], b0 + step);
  }
  wgmma_commit_and_wait();
  hold(acc);
  hold(a0);
  if constexpr (C::kCopies == 2) hold(a1);
}

// The part [Q0, Q1) of a warpgroup's tile: split, then (LAST) release the
// rows (empty) once they are in registers, then the products.
template <int PREC, int Q0, int Q1, bool LAST>
__device__ __forceinline__ void plane_part(
    float (&acc)[PlaneCfg<PREC>::NS / 2], const float* p0, const float* p1,
    uint64_t b0, uint64_t b1, unsigned long long* empty) {
  constexpr int S = (Q1 - Q0) * PlaneCfg<PREC>::kPer;
  uint32_t a0[S][4], a1[S][4];
  plane_split<PREC, Q0, Q1>(p0, p1, a0, a1);
  if constexpr (LAST) fdtk::mbar_arrive(empty);
  plane_mma<PREC, Q0 * PlaneCfg<PREC>::kPer>(acc, a0, a1, b0, b1);
}

// The tensor maps of the wgmma path: feats (N rows of u0 + Du floats, D
// apart; boxes of 64 rows x kPlaneKP, read from column u0, so depths past
// Du read zeros) and planes (N rows of R4 floats; boxes of 64 rows x NS).
struct PlaneMaps {
  CUtensorMap feats, planes;
};

// The plane kernel's wgmma path (feats 16-byte aligned, D, u0, Du multiples
// of 4, 0 < Du <= kPlaneKP).  Tile t is frame tile t / n_s (kPlaneTileRows
// frames) by slab t % n_s (NS columns); block b takes t = b, b + grid, ...
// With the grid a multiple of n_s (plane_grid) a block keeps one slab,
// split once, and every block is on the same frame tiles as the others, so
// the 22 or 32 reads of a frame tile fall together and all but the first
// find it in L2, which the planes stream through.  Lane 0 of warp 8 (the
// producer) loads each tile's frames, a warpgroup's 64 at a time, into that
// warpgroup's slot by TMA (full[g] when they land, empty[g] when the
// warpgroup has them in registers); warpgroup g splits them, issues its
// products, adds the bias, writes its 64 x NS tile to its stage and sends
// it to planes by one TMA store, which runs while it takes the next tile.
template <int PREC>
__device__ __forceinline__ void plane_wgmma(
    unsigned char* base, const PlaneMaps& maps,
    const float* __restrict__ wall_k, const float* __restrict__ wall, int N,
    int u0, int Du, int Dk, int R, int R4) {
  using C = PlaneCfg<PREC>;
  unsigned char* smem = base + ((128 - (fdtk::smem_addr(base) & 127)) & 127);
  float* raw = reinterpret_cast<float*>(smem + C::kRaw);
  const float* bias = reinterpret_cast<const float*>(smem + C::kBias);
  auto* full = reinterpret_cast<unsigned long long*>(smem + C::kBars);
  unsigned long long* empty = full + kPlaneWgs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_s = (R4 + C::NS - 1) / C::NS;
  const int tiles = (N + kPlaneTileRows - 1) / kPlaneTileRows * n_s;
  if (threadIdx.x == 0)
    for (int g = 0; g < kPlaneWgs; ++g) {
      fdtk::mbar_init(&full[g], 1);
      fdtk::mbar_init(&empty[g], 128);
    }
  __syncthreads();

  if (warp == kPlaneWgThreads / 32) {            // the producer
    if (lane != 0) return;
    for (int it = 0, t = blockIdx.x; t < tiles; ++it, t += gridDim.x)
      for (int g = 0; g < kPlaneWgs; ++g) {
        fdtk::mbar_wait(&empty[g], (it & 1) ^ 1);
        mbar_expect(&full[g], C::kRawFloats * 4);
        fence_proxy_async();
        tma_load(raw + g * C::kRawFloats, &maps.feats, u0,
                 t / n_s * kPlaneTileRows + g * kPlaneWgRows, &full[g]);
      }
    return;
  }

  const int g = warp >> 2, wq = warp & 3;        // warpgroup, its warp
  const int row = wq * 16 + (lane >> 2);         // the lane's rows: row, +8
  const float* p0 =
      raw + g * C::kRawFloats + row * kPlaneKP + kPlaneQ * (lane & 3);
  const float* p1 = p0 + 8 * kPlaneKP;
  float* stage = reinterpret_cast<float*>(smem + C::kOut) + g * C::kOutFloats;
  const uint64_t b0 = smem_desc(smem, 128, C::kChunks * 128);
  const uint64_t b1 = smem_desc(smem + C::kCopyBytes, 128, C::kChunks * 128);
  const bool leader = wq == 0 && lane == 0;      // issues the stores
  int slab = -1;
  for (int it = 0, t = blockIdx.x; t < tiles; ++it, t += gridDim.x) {
    const int s = t % n_s, m0 = t / n_s * kPlaneTileRows + g * kPlaneWgRows;
    if (s != slab) {
      named_sync(1, kPlaneWgThreads);            // no product reads the old
      plane_slab<PREC>(smem, wall_k, wall, s * C::NS, Du, Dk, R);
      fence_proxy_async();                       // visible to the products
      named_sync(1, kPlaneWgThreads);
      slab = s;
    }
    float acc[C::NS / 2];
#pragma unroll
    for (int i = 0; i < C::NS / 2; ++i) acc[i] = 0.0f;
    fdtk::mbar_wait(&full[g], it & 1);
    if constexpr (C::kParts == 1) {
      plane_part<PREC, 0, kPlaneQ / 4, true>(acc, p0, p1, b0, b1, &empty[g]);
    } else {
      plane_part<PREC, 0, kPlaneQ / 8, false>(acc, p0, p1, b0, b1, nullptr);
      plane_part<PREC, kPlaneQ / 8, kPlaneQ / 4, true>(acc, p0, p1, b0, b1,
                                                       &empty[g]);
    }
    if (leader) bulk_wait<true>();               // the last tile's store
    named_sync(2 + g, 128);                      // has read the stage
#pragma unroll
    for (int j = 0; j < C::NS / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float2 bb = *reinterpret_cast<const float2*>(bias + col);
      *reinterpret_cast<float2*>(stage + row * C::NS + col) =
          make_float2(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
      *reinterpret_cast<float2*>(stage + (row + 8) * C::NS + col) =
          make_float2(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
    }
    fence_proxy_async();                         // visible to the store
    named_sync(2 + g, 128);
    if (leader) {
      tma_store(&maps.planes, s * C::NS, m0, stage);
      bulk_commit();
    }
  }
  if (leader) bulk_wait<false>();
}

// planes (N, R4) = x (N, Du) Wall[:, :Du]^T + Wall[:, Du]; x_n = feats[n,
// u0:u0+Du], wall_k = Wall[:, :Du] with rows padded to Dk floats.  PATH
// kPathWgmma: plane_wgmma, one block an SM; kPathVec / kPathScalar: a
// 128 x 160 tile a block on gemm_tile (16- or 4-byte copies).
template <int PREC, int PATH>
__global__ void __launch_bounds__(kPlaneBlockThreads<PATH>,
                                  kPlaneBlocksPerSM<PATH>)
fdt_train_plane_kernel(const float* __restrict__ feats,
                       const float* __restrict__ wall_k,
                       const float* __restrict__ wall,
                       float* __restrict__ planes, int N, int D, int u0,
                       int Du, int Dk, int R, int R4,
                       const __grid_constant__ PlaneMaps maps) {
  if constexpr (PATH == kPathWgmma) {
    extern __shared__ unsigned char plane_smem[];
    plane_wgmma<PREC>(plane_smem, maps, wall_k, wall, N, u0, Du, Dk, R, R4);
  } else {
    extern __shared__ float4 smem4[];
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
    Acc acc = {};
    float unused = 0.0f;
    gemm_tile<PREC, true, true, PATH == kPathVec>(
        reinterpret_cast<float*>(smem4), View{feats + u0, D, N, Du},
        View{wall_k, Dk, R, Du}, m0, n0, 0, Du, acc, false, unused);
    // columns R..R4 have zero B rows and no bias: the pad is written 0
    store<PREC>(Out{planes, R4, 0, N, R4, wall + Du, Du + 1, R}, acc, m0,
                n0);
  }
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

// The wgmma path's blocks: a multiple of the n_s slabs (where the SMs hold
// that many), so that each block keeps one slab, and all blocks take the
// same frame tiles at the same time (t = b, b + grid, ...: frame tile
// t / n_s, slab t % n_s), which the later readers of a tile's frames find
// in L2; at most one a tile.
int plane_grid(long long tiles, int n_s, int sms) {
  const long long g = sms >= n_s ? sms / n_s * n_s : sms;
  return static_cast<int>(tiles < g ? tiles : g);
}

// cuTensorMapEncodeTiled, from the driver by way of the runtime (the
// library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// m := the fp32 matrix of `rows` rows of `cols` floats, `ld` floats apart,
// from `base`, in boxes of box_rows x box_cols (zeros read past its edges)
bool tile_map(CUtensorMap* m, const float* base, int rows, int cols, int ld,
              int box_rows, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn != nullptr &&
         fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


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
// fdtk::Precision (0 highest, 1 bf16x3, 2 default); path: 1 the wgmma path
// (kernels/fdt_train.py plane_path chooses it; refused with
// cudaErrorInvalidValue where its inputs do not allow it), 0 the mma.sync
// tiles.
int fdt_train_plane(const float* feats, const float* wall_k,
                    const float* wall, float* planes, int N, int D, int u0,
                    int Du, int Dk, int R, int R4, int precision, int path,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (!aligned16(feats) || D % 4 != 0 || u0 % 4 != 0 || Du % 4 != 0 ||
        Du <= 0 || Du > kPlaneKP || Dk < Du || !aligned16(planes) ||
        R4 % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    return by_precision(precision, [&](auto p) {
      constexpr int P = decltype(p)::value;
      using C = PlaneCfg<P>;
      const long long tiles =
          (long long)cdiv(N, kPlaneTileRows) * cdiv(R4, C::NS);
      if (tiles == 0) return 0;
      PlaneMaps maps;
      if (!tile_map(&maps.feats, feats, N, u0 + Du, D, kPlaneWgRows,
                    kPlaneKP) ||
          !tile_map(&maps.planes, planes, N, R4, R4, kPlaneWgRows, C::NS))
        return static_cast<int>(cudaErrorInvalidValue);
      auto kernel = &fdt_train_plane_kernel<P, kPathWgmma>;
      const cudaError_t e = fdtk::opt_in(kernel, C::kSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      kernel<<<plane_grid(tiles, cdiv(R4, C::NS), sms), kPlaneThreads,
               C::kSmem, s>>>(feats, wall_k, wall, planes, N, D, u0, Du, Dk,
                              R, R4, maps);
      return static_cast<int>(cudaGetLastError());
    });
  }
  const dim3 grid(cdiv(R4, kBN), cdiv(N, kBM));
  const size_t smem = smem_bytes<true, true>();
  const bool vec = aligned16(feats) && D % 4 == 0 && u0 % 4 == 0 &&
                   aligned16(wall_k) && Dk % 4 == 0;
  auto args = [&](auto kernel) {
    return launch(kernel, grid, smem, s, feats, wall_k, wall, planes, N, D,
                  u0, Du, Dk, R, R4, PlaneMaps{});
  };
  return by_precision(precision, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return vec ? args(&fdt_train_plane_kernel<P, kPathVec>)
               : args(&fdt_train_plane_kernel<P, kPathScalar>);
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
