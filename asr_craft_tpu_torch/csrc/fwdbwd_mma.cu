// K5's transition-gradient contraction on Hopper's tensor cores (sm_90a), in
// fp32 accuracy by 3xTF32.  Plain C interface, loaded with ctypes by
// asr_craft_tpu_torch/kernels/fwdbwd.py, whose backward_dual_contract_plain
// is the plain version.
//
// Replaces, in asr_craft_tpu/kernels/dual_pallas.py _dual_bwd_grad_kernel:
//   fb_contract_kernel <- uv_acc += U^T V a frame (:226), two matrix-unit
//                         products of (L, B) x (B, L) per frame carried
//                         through the sequential grid
//   sum_partials_kernel (fdt_common.cuh) <- that carry from block to block
//
// The product.  K = 2 B T rows (frame t of utterance b, lattice i at row
// (b T + t) 2 + i) of U and V, each row ld >= L floats (ld % 4 == 0, the
// 16-byte rows fwdbwd.cu's K5 recursion writes; columns past L are never
// read):  UV (L, L) = sum_k U[k]^T V[k].
//
// What bounds it on this card.  At config 5 (B=128, T=512, L=138) it reads
// 144 MB of rows for 5.0 GFLOP: 0.043 ms of memory traffic against 0.030
// ms of 3xTF32 (495 / 3 TFLOP/s), where the CUDA cores' fp32 rate would
// need 0.074 ms.  So the tensor cores, fed at the memory's rate.
//
// What this design does about it.  The frames are split into chunks, about
// two blocks an SM (one for the widest tile), each of which computes the
// whole (L, L) tile (or a 144 x 144 tile of it, for L > 144) over its
// chunk; a second kernel adds the chunks' partials in chunk order: no
// atomics, UV the same bits on every run.  A block is 9 warps (3 x 3),
// each MI m16 x NI n8 mma.sync m16n8k8 TF32 fragments; the square tile is
// 48, 96 or 144 wide (MI, NI = 1, 2; 2, 4; 3, 6), the smallest that holds L
// (kernels/fwdbwd.contract_tile picks it), so L = 48 and L = 138 waste no
// fragment and 4% of one.  Both
// operands are frame-major, staged 16 frames deep through a 4-stage
// cp.async ring of 16-byte copies, rows padded to 8 mod 32 floats so a
// warp's fragment loads hit 32 banks.  The 3xTF32 split is fdt_mma.cu's.
// Not done yet: wgmma (its .tf32 form takes K-major operands only, and both
// operands here are M- and N-major).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::cp_async16;
using fdtk::mma;
using fdtk::split;

constexpr int kBK = 16, kStages = 4, kWarpsM = 3, kWarpsN = 3;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;      // 288

// A block's output tile: BM x BN of UV, staged rows of SA / SB floats; two
// blocks an SM where their registers fit (the 144-wide tile's 72
// accumulators a thread do not leave room for two)
template <int MI, int NI>
struct Geo {
  static constexpr int BM = kWarpsM * 16 * MI, BN = kWarpsN * 8 * NI;
  static constexpr int BLOCKS_PER_SM = MI * NI > 8 ? 1 : 2;
  static constexpr int SA = BM + ((8 - BM % 32) + 32) % 32;
  static constexpr int SB = BN + ((8 - BN % 32) + 32) % 32;
  static constexpr int STAGE = kBK * (SA + SB);
  static constexpr size_t BYTES = sizeof(float) * kStages * STAGE;
};

// Copy rows [k0, k0 + kBK) (zeros at ke and past), columns [c0, c0 + EXT)
// (zeros past L) of src into the tile s[k * S + c], asynchronously.
template <int EXT, int S>
__device__ __forceinline__ void stage_rows(float* s,
                                           const float* __restrict__ src,
                                           int ld, int k0, int ke, int c0,
                                           int L) {
  constexpr int CPR = EXT / 4, N = kBK * CPR;
  for (int c = threadIdx.x; c < N; c += kThreads) {
    const int k = c / CPR, i = (c - k * CPR) * 4;
    const int gk = k0 + k, gi = c0 + i;
    const int n = gk < ke ? min(max(L - gi, 0), 4) : 0;
    cp_async16(s + k * S + i, n ? src + (size_t)gk * ld + gi : src, 4 * n);
  }
}

// out + z L L = the sum over rows [z k_split, (z + 1) k_split) of U^T V, on
// the output tile (blockIdx.y, blockIdx.x)
template <int MI, int NI>
__global__ void __launch_bounds__(kThreads, Geo<MI, NI>::BLOCKS_PER_SM)
fb_contract_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   float* __restrict__ out, int K, int L, int ld,
                   int k_split) {
  using G = Geo<MI, NI>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM;
  const int kb = blockIdx.z * k_split, ke = min(K, kb + k_split);
  const int nk = max(ke - kb + kBK - 1, 0) / kBK;
  float acc[MI][NI][4] = {};
  auto load = [&](int it) {
    float* s = smem + (it % kStages) * G::STAGE;
    const int k0 = kb + it * kBK;
    stage_rows<G::BM, G::SA>(s, U, ld, k0, ke, m0, L);
    stage_rows<G::BN, G::SB>(s + kBK * G::SA, V, ld, k0, ke, n0, L);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    fdtk::cp_async_commit();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kWarpsN) * 16 * MI, wn = (warp % kWarpsN) * 8 * NI;
  for (int it = 0; it < nk; ++it) {
    fdtk::cp_async_wait<kStages - 2>();   // this thread's copies of tile it
    __syncthreads();                      // everyone's; tile it-1 is free
    if (it + kStages - 1 < nk) load(it + kStages - 1);
    fdtk::cp_async_commit();
    const float* sa = smem + (it % kStages) * G::STAGE;
    const float* sb = sa + kBK * G::SA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const float* a0 = sa + (kk + t) * G::SA + wm + g;
      const float* a1 = a0 + 4 * G::SA;
      unsigned ab[MI][4], as[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        split(a0[mi * 16], ab[mi][0], as[mi][0]);
        split(a0[mi * 16 + 8], ab[mi][1], as[mi][1]);
        split(a1[mi * 16], ab[mi][2], as[mi][2]);
        split(a1[mi * 16 + 8], ab[mi][3], as[mi][3]);
      }
      const float* b0 = sb + (kk + t) * G::SB + wn + g;
      const float* b1 = b0 + 4 * G::SB;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        unsigned bb0, bs0, bb1, bs1;
        split(b0[ni * 8], bb0, bs0);
        split(b1[ni * 8], bb1, bs1);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma(acc[mi][ni], as[mi], bb0, bb1);
          mma(acc[mi][ni], ab[mi], bs0, bs1);
          mma(acc[mi][ni], ab[mi], bb0, bb1);
        }
      }
    }
  }
  fdtk::cp_async_wait<0>();
  float* o = out + (size_t)blockIdx.z * L * L;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + ni * 8 + 2 * t + (e & 1);
        if (m < L && n < L) o[(size_t)m * L + n] = acc[mi][ni][e];
      }
}

int cdiv(long long a, int b) { return static_cast<int>((a + b - 1) / b); }

template <int MI, int NI>
int launch(const float* U, const float* V, float* dst, int K, int L, int ld,
           int k_split, int used, cudaStream_t s) {
  using G = Geo<MI, NI>;
  auto kernel = fb_contract_kernel<MI, NI>;
  const cudaError_t err = fdtk::opt_in(kernel, G::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(L, G::BN), cdiv(L, G::BM), used);
  kernel<<<grid, kThreads, G::BYTES, s>>>(U, V, dst, K, L, ld, k_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The blocks of the square tile `tile` an SM holds: what the wrapper plans
// the split of the rows with; 0: no such tile.
int fb_contract_blocks_per_sm(int tile) {
  switch (tile) {
    case 48: return Geo<1, 2>::BLOCKS_PER_SM;
    case 96: return Geo<2, 4>::BLOCKS_PER_SM;
    case 144: return Geo<3, 6>::BLOCKS_PER_SM;
  }
  return 0;
}

// UV (L, L) = U^T V over K rows of ld floats (U, V 16-byte aligned, ld % 4
// == 0); tile: the square output tile, 48, 96 or 144; the rows in `splits`
// chunks of whole kBK steps summed into part (splits, L, L) and then into
// UV in chunk order (splits <= 1: one chunk, no part).
int fb_contract(const float* U, const float* V, float* part, float* UV,
                int K, int L, int ld, int tile, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(U) |
                         reinterpret_cast<uintptr_t>(V)) & 15) == 0;
  if (!aligned || ld % 4 != 0 || L < 1 || ld < L || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || part == nullptr) splits = 1;
  const int k_split = max(cdiv(cdiv(K, splits), kBK) * kBK, kBK);
  const int used = max(cdiv(K, k_split), 1);
  float* dst = used > 1 ? part : UV;
  int err;
  switch (tile) {
    case 48: err = launch<1, 2>(U, V, dst, K, L, ld, k_split, used, s); break;
    case 96: err = launch<2, 4>(U, V, dst, K, L, ld, k_split, used, s); break;
    case 144: err = launch<3, 6>(U, V, dst, K, L, ld, k_split, used, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0 || used <= 1) return err;
  const int n = L * L;
  fdtk::sum_partials_kernel<<<cdiv(n, 32), fdtk::kSumThreads, 0, s>>>(
      part, UV, used, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
