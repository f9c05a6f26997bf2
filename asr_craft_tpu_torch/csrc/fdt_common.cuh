// Pieces shared by the port's kernels (fdt_viterbi.cu: K3; fdt_train.cu:
// K1's and K2's recursions; fdt_mma.cu: the plane kernel and K2's
// contraction; viterbi.cu: K7, K8; fwdbwd.cu: K4's, K5's, K6's and K14's
// recursions; fwdbwd_mma.cu: K5's contraction; segmental.cu: K9-K13;
// calibrate.cu: K15):
// the semiring zero, the block-wide first argmax of the max-plus decodes,
// the asynchronous copies (the planes' rows reach the fdt recursions by
// cp.async.bulk on an mbarrier: K1's one frame ahead, K2's and K3's
// through a ring of stages), the 3xTF32 pieces of the
// tensor-core products, the guarded three-way log-sum-exp of the reference
// and, at the end, the pieces of the recursions over one (L, L) transition
// factor: held in shared memory and read a strided column a lane (K10, K12),
// or held a contiguous quarter a lane, in registers or in shared memory (the
// forward-backward kernels and K9); and the tracebacks' stream of rows
// through a ring of shared-memory slots (K3's traceback, which K7 and K8
// share, and K13).
//
// No kernel forms a plane of the fdt lattice inside its recursion: the
// planes Wall @ [x_t; 1] of every frame come from fdt_mma.cu's plane
// kernel on the tensor cores, before the recursion that reads them.
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

// ---------------------------------------------------------------------------
// Asynchronous copies (fdt_train.cu: K1's and K2's recursions;
// fdt_viterbi.cu: K3's; fdt_mma.cu: the staged tiles of the tensor-core
// products).  cp.async copies 4 or 16 bytes a thread and is tracked by
// commit groups; cp.async.bulk copies a whole contiguous row (16-byte
// aligned, a multiple of 16 bytes) issued by one thread and completes on an
// mbarrier in shared memory.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// dst[0:4) = src[0:4) floats; only the first `bytes` are read, the rest of
// the 16 are zero-filled (bytes = 0: no read, all zero)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// dst[0] = src[0] (bytes = 4) or 0 (bytes = 0)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: expect `bytes` on `bar`, then copy them from global memory
// into shared memory; the barrier's phase completes when they have landed.
// The fence orders the block's earlier accesses of dst (behind a barrier)
// before the copy's writes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// spin until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// one arrival of this thread on `bar`; it releases the thread's earlier
// reads of what the barrier guards
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// whether the phase of parity `parity` of `bar` has completed, without
// waiting
__device__ __forceinline__ bool mbar_test(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// `count` threads (whole warps) meet at the named barrier `id`
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// one arrival of this thread on `bar` once every cp.async it has issued so
// far has landed (.noinc: the arrival is one of those the barrier was
// initialised to expect)
__device__ __forceinline__ void cp_async_mbar_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores (fdt_mma.cu, fwdbwd_mma.cu): each fp32 operand
// is split as big = tf32(a) (cvt.rna), small = tf32(a - big), and a product
// accumulates small.big + big.small + big.big in fp32 (mma.sync m16n8k8).
// ---------------------------------------------------------------------------

// x = big + small: big = x rounded to TF32, small = the rest rounded to TF32
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// c += a b on one m16n8k8 TF32 tile (a: row-major fragment, b: col-major)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The two other precisions of the fdt products (fdt_mma.cu), the JAX
// package's CrfConfig.precision:
//   kDefault: one TF32 pass, each operand rounded by cvt.rna (tf32 below);
//   kBf16x3:  each operand split as hi = bf16(x) (round to nearest even),
//             lo = bf16(x - hi), and hi.hi + hi.lo + lo.hi accumulated in
//             fp32 on the bf16 tensor cores (mma.sync m16n8k16); every
//             product of two bf16 values is exact in fp32.
// ---------------------------------------------------------------------------

enum Precision : int { kHighest = 0, kBf16x3 = 1, kDefault = 2 };

// x rounded to TF32 (round to nearest, ties away from zero), as a .b32
__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// two bf16 in one register: x0 in the low half (the lower depth of an mma
// fragment's pair), x1 in the high half; round to nearest even
__device__ __forceinline__ unsigned pack_bf16(float x0, float x1) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(x1), "f"(x0));
  return d;
}

// the hi / lo bf16 pairs of (x0, x1); lo of an infinite or NaN x is NaN,
// as x - hi is
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xffff0000u));
}

// The value one operand x contributes when it meets an exact 1 (a bias
// column, the column of ones): x itself (kHighest), tf32(x) (kDefault),
// hi + lo (kBf16x3).
template <int PREC>
__device__ __forceinline__ float operand(float x) {
  if constexpr (PREC == kDefault) {
    return __uint_as_float(tf32(x));
  } else if constexpr (PREC == kBf16x3) {
    const float hi = __uint_as_float(pack_bf16(x, 0.0f) << 16);
    return hi + __uint_as_float(pack_bf16(x - hi, 0.0f) << 16);
  } else {
    return x;
  }
}

// c += a b on one m16n8k16 bf16 tile, fp32 accumulate (a: row-major
// fragment, four registers of two bf16; b: col-major, two registers)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// out[i] = sum_b part[b, i] in a fixed order: a block of kSumThreads takes
// 32 consecutive entries, its warp w adds rows w, w + kSumWarps, ... in
// order (32 entries a coalesced row segment, 8 rows in flight), then the
// warps' sums are added in warp order.  Launch with (n + 31) / 32 blocks.
constexpr int kSumWarps = 16;
constexpr int kSumThreads = 32 * kSumWarps;

static __global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int B, int n) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (i < n) {
#pragma unroll 8
    for (int b = w; b < B; b += kSumWarps) acc += part[(size_t)b * n + i];
  }
  red[w][lane] = acc;
  __syncthreads();
  if (w == 0 && i < n) {
    float sum = 0.0f;
    for (int k = 0; k < kSumWarps; ++k) sum += red[k][lane];
    out[i] = sum;
  }
}

// ---------------------------------------------------------------------------
// The factor held a contiguous quarter a lane (fwdbwd.cu).  A group of
// kGroup lanes owns D destinations l_d and splits the predecessors p into
// quarters of 4 QV each (lane g takes p in [4 QV g, 4 QV (g + 1))), read as
// QV float4 chunks: the factor's rows F[l_d, :] (destination-major) from
// registers or from shared memory, the exponentials e[p] of each lattice
// from a vector padded with zeros to Lq = 16 QV, each chunk once for all D
// destinations.  QV is odd, so the four quarters of a quarter-warp's
// 16-byte loads start on four different bank quads, and the shared factor's
// rows (stride Lq) shift the next destination by four.
// ---------------------------------------------------------------------------

// F[l_d, 4 QV g + j], j < 4 QV (0 past L or for l_d >= L): in registers
// (SHARED false), or the addresses of the quarters in shared memory, where
// the caller staged F with row stride 16 QV (stage_rows_padded).
template <int D, int QV, bool SHARED>
struct FactorRows {
  float4 r[SHARED ? 1 : D][SHARED ? 1 : QV];
  const float4* s[D];

  __device__ __forceinline__ void load(const float* __restrict__ Fg,
                                       const float* Fs, int L,
                                       const int (&l)[D], int g) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const bool ok = l[d] < L;
      if constexpr (SHARED) {
        s[d] = reinterpret_cast<const float4*>(
                   Fs + (size_t)(ok ? l[d] : 0) * 16 * QV) + g * QV;
      } else {
        const float* row = Fg + (size_t)(ok ? l[d] : 0) * L;
#pragma unroll
        for (int k = 0; k < QV; ++k) {
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = 4 * (QV * g + k) + j;
            v[j] = ok && p < L ? row[p] : 0.0f;
          }
          r[d][k] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
  __device__ __forceinline__ float4 at(int d, int k) const {
    if constexpr (SHARED) return s[d][k];
    else return r[d][k];
  }
};

// m[i] = max(max_l v[i * L + l], NEG_INF) for every warp, as row_max gives
// it, with l < 32 NV: one redux.sync a lattice on the floats' order-keeping
// integer keys in place of five rounds of shuffles, the lattices' loads
// interleaved.  No barrier is needed before its use.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float from_order_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

template <int NLAT, int NV>
__device__ __forceinline__ void row_max_redux(const float* v, int L,
                                              float (&m)[NLAT]) {
  const int lane = threadIdx.x & 31;
  float x[NLAT];
#pragma unroll
  for (int i = 0; i < NLAT; ++i) x[i] = kNegInf;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int l = lane + 32 * k;
#pragma unroll
    for (int i = 0; i < NLAT; ++i)
      if (l < L) x[i] = fmaxf(x[i], v[i * L + l]);
  }
#pragma unroll
  for (int i = 0; i < NLAT; ++i)
    m[i] = from_order_key(__reduce_max_sync(0xffffffffu, order_key(x[i])));
}

// Copies the (L, L) factor into rows of Lq floats, zeros past column L.
__device__ __forceinline__ void stage_rows_padded(const float* __restrict__ Fg,
                                                  float* Fs, int L, int Lq) {
  for (int i = threadIdx.x; i < L * Lq; i += blockDim.x) {
    const int r = i / Lq, c = i - r * Lq;
    Fs[i] = c < L ? Fg[(size_t)r * L + c] : 0.0f;
  }
}

// The group's D NLAT sums sum_p e[i 16 QV + p] F[l_d, p] (pair q = d NLAT +
// i), each finished by lane q % kGroup: out[j] = the sum of pair kGroup j +
// g (pairs past D NLAT: unspecified).  A lane adds its quarter in two
// partial sums a pair, then the group reduces and scatters the D NLAT
// partials by shuffles (xor 2, then xor 1; for one or two pairs every lane
// gets every sum), in one fixed order.  All lanes of the warp must call it;
// e is 16-byte aligned.  EXP (one lattice): e holds a row x and the sums
// take exp(x[p] - em) in its place, each lane exponentiating its own quarter
// (segmental.cu's K9: no separate exp pass and barrier on the frame chain).
template <int NLAT, int D, int QV, bool SHARED, bool EXP = false>
__device__ __forceinline__ void quarter_dot(
    const float* e, const FactorRows<D, QV, SHARED>& f, int g,
    float (&out)[(D * NLAT + 3) / 4], float em = 0.0f) {
  static_assert(!EXP || NLAT == 1, "EXP takes one lattice");
  constexpr int NP = D * NLAT;
  static_assert(NP == 1 || NP == 2 || NP == 4 || NP == 8, "pairs a group");
  const float4* ev = reinterpret_cast<const float4*>(e) + g * QV;
  float a[NP][2];
#pragma unroll
  for (int q = 0; q < NP; ++q) a[q][0] = a[q][1] = 0.0f;
#pragma unroll
  for (int k = 0; k < QV; ++k) {
    float4 x[NLAT], w[D];
#pragma unroll
    for (int i = 0; i < NLAT; ++i) x[i] = ev[i * 4 * QV + k];
    if constexpr (EXP) {                // ex2.approx: on the frame chain
      x[0].x = __expf(x[0].x - em);
      x[0].y = __expf(x[0].y - em);
      x[0].z = __expf(x[0].z - em);
      x[0].w = __expf(x[0].w - em);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) w[d] = f.at(d, k);
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int i = 0; i < NLAT; ++i) {
        float* s = a[d * NLAT + i];
        s[0] = fmaf(x[i].x, w[d].x, s[0]);
        s[1] = fmaf(x[i].y, w[d].y, s[1]);
        s[0] = fmaf(x[i].z, w[d].z, s[0]);
        s[1] = fmaf(x[i].w, w[d].w, s[1]);
      }
  }
  float v[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) v[q] = a[q][0] + a[q][1];
  constexpr unsigned kAll = 0xffffffffu;
  if constexpr (NP <= 2) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      v[q] += __shfl_xor_sync(kAll, v[q], 1);
      v[q] += __shfl_xor_sync(kAll, v[q], 2);
    }
    out[0] = NP == 2 && g == 1 ? v[NP - 1] : v[0];
  } else {
    constexpr int J = NP / 4;
    const bool hi2 = g & 2, hi1 = g & 1;
    float w[J][2];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lo = v[4 * j + c], hi = v[4 * j + c + 2];
        w[j][c] = (hi2 ? hi : lo) + __shfl_xor_sync(kAll, hi2 ? lo : hi, 2);
      }
#pragma unroll
    for (int j = 0; j < J; ++j)
      out[j] = (hi1 ? w[j][1] : w[j][0]) +
               __shfl_xor_sync(kAll, hi1 ? w[j][0] : w[j][1], 1);
  }
}

// ---------------------------------------------------------------------------
// The tracebacks' stream (fdt_viterbi.cu: the traceback of K3, K7 and K8;
// segmental.cu: K13).  A block walks one utterance: warp 0 follows the path
// in shared memory while warps 1-3 copy the utterance's rows there, blocks
// of C frames in descending frame order, into a ring of kTbRing slots.
// Stream block i goes to slot i % kTbRing; full[s] completes a phase when a
// block has landed in slot s (one arrival a producer thread, by
// cp_async_mbar_arrive), empty[s] when the walker is done with it (one
// arrival), so the copies run up to kTbRing - 1 blocks ahead of the walk.
// A block of rows starts anywhere in memory: it is copied in 16-byte pieces
// from the 16-byte boundary at or below its first element (0-3 elements of
// the row before it, never before the tensor's own aligned allocation), the
// last piece cut to the bytes that belong to the block (cp.async reads no
// further and zero-fills the rest), and its rows sit tb_align(src) elements
// into the slot.
// ---------------------------------------------------------------------------

constexpr int kTbRing = 3;
constexpr int kTbProducers = 96;           // warps 1-3 copy
constexpr int kTbThreads = 32 + kTbProducers;
constexpr int kTbMaxFrames = 128;          // frames a block, at most
constexpr int kTbSlotBytes = 32768;        // what a slot aims at

// 4-byte elements between the 16-byte boundary at or below p and p
template <typename E>
__device__ __forceinline__ int tb_align(const E* p) {
  return static_cast<int>((reinterpret_cast<size_t>(p) & 15) >> 2);
}

// Producer p (0 <= p < kTbProducers): its share of the copy of n 4-byte
// elements from src into slot (16-byte aligned), the rows landing at
// slot + tb_align(src).
template <typename E>
__device__ __forceinline__ void tb_stream(E* slot, const E* src, int n,
                                          int p) {
  const int off = tb_align(src);
  const float* s = reinterpret_cast<const float*>(src - off);
  float* d = reinterpret_cast<float*>(slot);
  const int nel = off + n;
  for (int c = 4 * p; c < nel; c += 4 * kTbProducers)
    cp_async16(d + c, s + c, 4 * min(4, nel - c));
}

// The elements of a slot of C frames of `row` elements: room for the
// alignment offset, a whole number of 16-byte pieces.
__host__ __device__ inline size_t tb_slot(int C, int row) {
  return ((size_t)C * row + 3 + 3) & ~(size_t)3;
}

// The shared memory of a traceback block: the ring (`streams` arrays of
// `row` elements a frame, C frames a slot), `extra` bytes (a multiple of
// 16) and the 2 kTbRing barriers.
inline size_t tb_bytes(int C, int row, int streams, size_t extra) {
  return 4 * (size_t)kTbRing * streams * tb_slot(C, row) + extra +
         16 * kTbRing;
}

// The frames of a stream block: as many as fill kTbSlotBytes, 1 to
// kTbMaxFrames, fewer where the block would pass the shared memory a block
// can use; 0 where one frame does not fit.
inline int tb_frames(int row, int streams, size_t extra) {
  const long fill = kTbSlotBytes / (4L * row * streams);
  int C = fill < 1 ? 1 : (fill > kTbMaxFrames ? kTbMaxFrames : (int)fill);
  for (; C >= 1; --C)
    if (tb_bytes(C, row, streams, extra) <= kSmemLimit) return C;
  return 0;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace fdtk
