// Segmental CRF recursions over a (time x duration x label) lattice that is
// never materialized, for Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by asr_craft_tpu_torch/kernels/segmental.py, which holds the plain
// PyTorch version of every kernel here.
//
// Replaces the five TPU kernels of asr_craft_tpu/kernels/segmental_pallas.py:
//   seg_alpha_kernel          <- _seg_fwd_kernel (K9,
//                                segmental_forward_pallas): alpha and logZ
//                                (seg_forward_kernel<false> at the few
//                                widths whose windows only its smaller
//                                footprint fits)
//   seg_beta_kernel           <- _seg_bwd_kernel (K10,
//                                segmental_backward_pallas): beta
//                                (seg_backward_kernel at those widths)
//   seg_message_kernel,       <- _seg_grad_kernel and the drain after it (K11,
//   seg_xi16_kernel /            segmental_grad_pallas): the xi pass, giving
//   seg_xi_kernel,               the end and start contributions A and S, the
//   sum_partials_kernel          bias gradient gd and the transition partial
//   (fdt_common.cuh)             gt.  The message pass writes E = exp(alpha -
//                                m), the messages q and the running sums CS;
//                                the xi pass A, S, the rows F and the gd
//                                partials, which sum_partials_kernel adds; gt =
//                                sum_u E[u]^T F[u] is fwdbwd_mma.cu's
//                                fb_contract_kernel on the tensor cores
//   seg_delta_kernel          <- _seg_vit_kernel (K12,
//                                segmental_viterbi_pallas): max-plus deltas,
//                                duration argmaxes, final score and label
//                                (seg_forward_kernel<true> at those widths)
//   seg_traceback_kernel      <- _seg_vit_tb_kernel (K13,
//                                segmental_viterbi_traceback_pallas): the
//                                segment-end markers of the best path
//
// Layouts (batch-major).  frame (B, T, L) f32: per-frame label scores.  bias
// (Dmax, L): the duration and label bias of a segment.  invd (Dmax,): 1 /
// (d + 1) for mean pooling, else 1 (formed from the pooling inside every
// kernel but the three-barrier frame's, which take it from the wrapper).
// lengths (B,) i32.  The transition factor: P (L, L) = exp(trans -
// tmax[None, :]) with tmax the column maxima clamped at NEG_INF, formed from
// trans inside K9 (destination-major, P^T) and K11's message pass (rows
// padded to L4 = L rounded up to 4); Pt = exp(trans^T - tmax_r[None, :])
// with tmax_r the row maxima, formed inside K10 (destination-major: the rows
// of exp(trans - tmax_r[:, None])); trans itself for K12 (destination-major:
// its columns) and K13.  The three-barrier frame takes P, Pt, tmax and
// tmax_r from the wrapper.  A segment labelled l over frames [t - d, t]
// scores
//   seg[t, d, l] = invd[d] * (CS[t + 1, l] - CS[t - d, l]) + bias[d, l],
// CS[k] the sum of the first k frames' scores, a running sum in frame order
// (K10 walks down and keeps the sum of the frames above, whose differences
// are the same).
//
// The recursions.  The duration message depends on its source frame u alone
// and is formed once per frame:
//   q[u, l] = m_u + tmax[l] + log(max(sum_p exp(alpha[u, p] - m_u) P[p, l],
//             1e-38)),  m_u = max(max_p alpha[u, p], NEG_INF),  q[-1] = 0
//   alpha[t, l] = lse_{d <= min(t, Dmax - 1)} (q[t - 1 - d, l] + seg[t, d, l])
//   logZ = lse_l alpha[length - 1, l]
// K12 is its max-plus twin, M[u, l] = max_p (delta[u, p] + trans[p, l]),
// delta[t, l] = max_d (M[t - 1 - d, l] + seg[t, d, l]), with arg_d the
// shortest duration among equal maxima; beam_threshold prunes delta[t] after
// arg_d is taken and before M[t] is formed.  K12's sums are single IEEE
// operations in the plain version's order (no fused multiply-add), so deltas
// and arg_d equal the plain version's bit for bit and ties fall the same way.
// K10: beta[length - 1] = 0 and, below it,
//   z[t, l'] = lse_{d: t + d + 1 < length} (seg[t + d + 1, d, l'] +
//              beta[t + d + 1, l'])
//   beta[t, l] = zm + tmax_r[l] + log(max(sum_l' exp(z[l'] - zm) Pt[l', l],
//                1e-38))
// K11, over the segments [k, t] (t = k + d < length, d < Dmax) with source
// u = k - 1 and x = seg[t, d, l] + beta[t, l] - logZ:
//   xi[t, d, l] = g * exp(q[u, l] + x)          (q[-1] = 0, CS[0] = 0)
//   A[t, l] = sum_d invd[d] xi[t, d, l];   S[k, l] = sum_d invd[d] xi[k + d,
//   d, l];   gd[d, l] = sum xi[., d, l];   F[u, l] = g sum_d exp(x + m_u)
//   (u >= 0);   gt[p, l] = sum_u E[u, p] F[u, l],  E[u] = exp(alpha[u] - m_u)
// with g_trans = sign(gt) * exp(trans + log|gt|) and the frame gradient
// (reverse cumulative sums of A and S) left to the caller.  Rows at and past
// the length hold NEG_INF (alphas, betas, deltas) or 0 (A, S, F, E, arg_d).
// NEG_INF is the finite -1e30 and every max is clamped at it.
//
// What bounds them on this card.  K9, K10 and K12 walk an utterance's frames
// in order, one block each; a frame is Dmax * L window terms and one (L) x
// (L, L) product, far too little to fill an SM, so the time is the latency
// of the frame chain.  K11 has no chain of its own (alpha and beta are its
// inputs): it runs frame-parallel, bound by its exponentials (two a window
// term) and the instructions around them.  Measured on an NVIDIA H100 80GB
// HBM3 at 700 W, config 4 (B=128, T=512, L=48, Dmax=16; PERF.md has the
// table):
// - K9, K10 and K12 take fwdbwd.cu's recursion frame (K4 / K6a's): a group of
//   kGroup = 4 lanes owns D destinations and holds a contiguous quarter of
//   each one's factor row (fdt_common.cuh FactorRows), formed in the kernel
//   from trans, in registers up to L = 144 (D = 1) and in shared memory beyond
//   (D = 4); the frame's one shared row (K9 alpha[t], K10 z[t], K12 the raw
//   delta[t]) is double-buffered by frame parity, so one barrier a frame
//   suffices; the row max is one redux.sync; the product reads the row a
//   quarter a lane and folds into the read what the three-barrier frame did in
//   a pass of its own behind a barrier (K9 and K10 exponentiate their quarter,
//   quarter_dot<..., EXP>; K12 applies the beam to its quarter, quarter_max);
//   the frame's scores arrive a frame ahead in registers; a lane's window
//   terms (durations g, g + 4, ...) sit in registers and are taken in one pass
//   (K9, K10: the max, then the exp-sum of the held terms, deeper windows
//   merging 16 durations a pass online; K12: the lane's first argmax over
//   ascending d, merged across the group by take_better), with the bias and
//   invd of the first 16 durations in registers; K9's and K10's exponentials
//   and logarithms on the chain are ex2/lg2.approx, K12 has none.  The slots
//   of a label are written and read by its own group alone, so a __syncwarp
//   orders them.  K9 0.46 ms against the three-barrier frame's 0.93, K10 0.46
//   against 0.88, K12 0.37 against 0.80.  Tried and dropped: for K9, two
//   destinations a group (K4's choice): the window's terms and merges, not the
//   product, fill a frame here, and D = 2 halved the warps that run them (1.02
//   ms, slower than the three-barrier frame); accurate expf / logf on the
//   chain; for all three, the frame's pieces as shared helpers (a lambda for
//   the window term): 4-8% slower than each kernel written out.
// - K10 mirrors K9 in time: the window holds beta[v] and the suffix sum R[v +
//   1] of the frames above (v = t + d + 1), and destination l's factor row is
//   row l of trans.  K12 is K9 in the max-plus semiring: its factor row is
//   column l of trans, padded with -INFINITY (a pad never wins or ties), and
//   its sums stay single IEEE operations (__fadd_rn, __fmul_rn, __fsub_rn; max
//   in any order is exact), so it keeps the plain version's bits.
// - The three-barrier frame (seg_forward_kernel, seg_backward_kernel), the
//   port's first, kept for the few widths only its smaller footprint fits: the
//   Dmax circular slots in shared memory keyed by the source frame modulo
//   Dmax, a label's window terms and its product split over kGroup lanes and
//   merged with shuffles, the factor in shared memory with its row stride
//   padded to 8 mod 32, a shuffle row max and three block barriers a frame.
// - K11 in three parts (five launches), none of which walks an utterance's
//   frames in order but for the running sum CS:
//   * the message pass, a block of TC = 64 frames: m_u, E[u] as 16-byte
//     rows, q[u] by 4 x 4 register tiles over the factor, formed in shared
//     memory from trans; one more block an utterance adds CS in frame order,
//     a thread a label; every input is staged by cp.async with all copies in
//     flight (a loop of global loads into shared memory waited ~1 us a
//     round: one block an utterance walking its chunks took 0.108 ms in a
//     trace, this 0.048);
//   * the xi pass, a block of TX = 64 start frames with a halo of Dmax - 1
//     start frames before the chunk (their segments that end in it feed A)
//     and Dmax - 1 end frames after it (for S and F).  Up to Dmax = 16
//     (seg_xi16_kernel) a thread owns a label and 4 consecutive start
//     frames, the durations are unrolled, and S, F, gd and the thread's A
//     over the 19 end frames it reaches sit in registers: no barrier and no
//     shared-memory update per term; the threads' A and gd partials are
//     summed at the end, each entry in a fixed order.  Deeper windows, and
//     widths whose threads would not fit a block (seg_xi_kernel), step d
//     over the window with one barrier a duration, A in shared memory.
//     0.147 ms in a trace (the d-stepping form at Dmax = 16: 0.170);
//     knockouts of that form on the card: F's exponential 15%, A's
//     shared-memory update 8%, the barriers 7%, blocks of 32 or 16 start
//     frames 2.2x and 1.6x slower;
//   * gt = E^T F on the tensor cores (3xTF32) over the B T rows, in 256
//     chunks summed in order: 0.031 ms against cuBLAS fp32 E.T @ F's 0.025.
//   Every output is written once; nothing is scattered, nothing atomic; gd
//   and gt are the same bits on every run.  Each exponential of the xi pass
//   is one ex2.approx of its (small, non-positive) exponent; g multiplies
//   each sum once.
// K13 walks a chain of segments, one (L) argmax each (~242 an utterance at
// config 4), each a few dependent reads that would wait on device memory:
// as the TPU kernel streams descending blocks of frames into VMEM and
// resolves a segment's predecessor once frame start - 1 is resident, one
// block an utterance streams its deltas and arg_d rows into a ring of
// shared-memory slots (fdt_common.cuh's stream, shared with the fdt
// traceback) and warp 0 walks them there, trans^T beside them in shared
// memory where it fits (L <= 237).  A segment costs ~0.17 us on an H100:
// two dependent shared loads, the lanes' selects and two redux.sync.
// Widths.  K9, K10 and K12 take the (L, Dmax) at which the three-barrier
// frame fits a block's shared memory (227 KB; L <= 205 at Dmax = 16): their
// own frame where its rows and windows fit, the three-barrier frame at the
// few where only that does
// (L 229-232 at Dmax 5-6); seg_frame says which.  K11 takes what K9 takes
// and its parts fit; at Dmax = 16 that is L <= 205, every width it took
// before.  seg_smem_bytes says which (L, Dmax) a kernel takes and the
// wrapper raises beyond.  Config 4 runs L = 48, Dmax = 16.
// Not done yet: several utterances per block at small L for K9, K10 and
// K12; the xi pass at its bound (0.023 ms by bytes): knockouts put ~0.095
// of its 0.15 ms in the terms (~0.025 their exponentials, the rest guards,
// loads and spills) and ~0.06 in a block's fixed work; an unguarded path
// for interior threads and the end frames' values in registers are
// untried.

#include <climits>
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "fdt_common.cuh"

namespace {

using fdtk::FactorRows;
using fdtk::group_dot;
using fdtk::kGroup;
using fdtk::kMaxThreads;
using fdtk::kNegInf;
using fdtk::kProdFloor;
using fdtk::kSmemLimit;
using fdtk::opt_in;
using fdtk::padded_stride;
using fdtk::quarter_dot;
using fdtk::round_up4;
using fdtk::row_max;
using fdtk::row_max_redux;
using fdtk::stage_matrix;
using fdtk::stage_rows_padded;
using fdtk::take_better;
using fdtk::threads_for;

enum Kind { kForward = 0, kViterbi = 1, kBackward = 2, kGrad = 3 };
using fdtk::kTbProducers;
using fdtk::kTbRing;
using fdtk::kTbThreads;

// K13's staged trans^T: L^2 floats, a whole number of 16-byte pieces
__host__ __device__ inline size_t seg_tb_trans_floats(int L) {
  return ((size_t)L * L + 3) & ~(size_t)3;
}

// A launch's shared memory.  ps: the row stride of the transition factor;
// ok false: the kernel does not take this (L, Dmax).
struct Plan {
  int ps;
  size_t bytes;
  bool ok;
};

// The three-barrier frame (K9's, K10's and K12's at the widths only it
// fits): the factor, the two (Dmax, L) windows and bias, invd and three (L)
// vectors.
Plan make_plan(int L, int Dmax) {
  const int ps = padded_stride(L);
  const size_t floats = (size_t)L * ps + 3 * (size_t)Dmax * L + Dmax +
                        3 * (size_t)L;
  const size_t bytes = sizeof(float) * floats;
  const bool ok = L >= 1 && Dmax >= 1 && bytes <= kSmemLimit &&
                  (long)L * kGroup <= kMaxThreads;
  return {ps, bytes, ok};
}

// ---------------------------------------------------------------------------
// K9's frame, which K10 and K12 share.  Layouts (frame_layout picks one by
// L, as kernels/fwdbwd.factor_layout does): QV float4 chunks of each of a
// group's D factor rows a lane, in registers (QV = 3, 5, 9 with D = 1: L <=
// 48, 80, 144) or in shared memory (D = 4, QV = ceil(L / 16): L <= 240).
// One destination a group where the factor fits registers: the window's
// terms and merges sit on the frame chain, and one destination a lane group
// halves them against two (the product's reads, which D > 1 shares in
// fwdbwd.cu, are the smaller part here).
// ---------------------------------------------------------------------------

constexpr int kWin = 4;                  // window terms a lane holds a pass
constexpr int kWinPass = kGroup * kWin;  // durations a pass: 16
constexpr int kFrameThreads = 640;       // every layout's block, at most

int frame_threads(int L, int D) {
  const int n = (kGroup * ((L + D - 1) / D) + 31) / 32 * 32;
  return n < 64 ? 64 : n;
}

bool frame_layout_ok(int L, int qv, int D, int shared) {
  const bool known = shared ? D == 4 && qv >= 10 && qv <= 15 &&
                                qv == (L + 15) / 16
                            : (qv == 3 || qv == 5 || qv == 9) && D == 1;
  return L >= 1 && known && 16 * qv >= L &&
         frame_threads(L, D) <= kFrameThreads;
}

// The frame's shared memory in this layout, 0 where it does not fit: [the
// factor (L, Lq) if shared][the shared row by frame parity (2, Lq)][two
// slots (Dmax, ws): K9 q and CS, K10 beta and R, K12 M and CS][the factor
// rows' maxima (L) if shared, K9's and K10's], ws the padded row stride
// where it fits, else L.  *ws_out: the slot stride.
size_t frame_bytes(int L, int Dmax, int qv, int D, int shared, int* ws_out) {
  if (!frame_layout_ok(L, qv, D, shared) || Dmax < 1) return 0;
  const size_t Lq = 16 * (size_t)qv;
  const size_t fixed = (shared ? (size_t)L * (Lq + 1) : 0) + 2 * Lq;
  for (int ws : {padded_stride(L), L}) {
    const size_t bytes = sizeof(float) * (fixed + 2 * (size_t)Dmax * ws);
    if (bytes <= kSmemLimit) {
      if (ws_out) *ws_out = ws;
      return bytes;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// K11's parts.
// ---------------------------------------------------------------------------

constexpr int kMsgThreads = 256;

// The xi pass's threads at most, by start frames a thread: NSRC = 4 (config
// 4: 960 threads, 30 warps an SM, at 64 registers; the windowed kernel
// spills ~170 bytes there), 8 (128 registers), 16 (for deep windows: 64
// registers, with spills).
constexpr int xi_threads(int nsrc) { return nsrc == 8 ? 512 : 1024; }
constexpr int kGdPass = 16;             // durations a gd reduction sums

// The message pass: the factor (L, L4), tmax, a chunk's alpha rows (TC, L),
// its E tile (TC, L4) and maxima (TC).  *tc: the frames a
// chunk, the most of 64, 32, ..., 4 that fits.
size_t msg_bytes(int L, int* tc) {
  const size_t L4 = round_up4(L);
  for (int TC = 64; TC >= 4; TC /= 2) {
    const size_t bytes = sizeof(float) * ((size_t)L * L4 + L +
                                          (size_t)TC * L + TC * L4 + TC);
    if (bytes <= kSmemLimit) {
      if (tc) *tc = TC;
      return bytes;
    }
  }
  return 0;
}

// The xi pass: TX start frames a block, NJ threads a label, each owning up
// to NSRC of the block's NS = TX + Dmax - 1 start frames (the chunk and its
// halo); shared memory holds CS and beta - logZ of the NS end frames from
// the chunk's first and their offsets (NS), A of the chunk (TX, L), the
// bias (Dmax, L), invd and the threads' gd partials of kGdPass durations
// (kGdPass, NJ, L), summed once a pass, off the barrier of every duration.
struct XiPlan {
  int tx, nj, nsrc, threads;
  size_t bytes;
  bool windowed;                  // seg_xi16_kernel (Dmax <= 16)
};

XiPlan xi_plan(int L, int Dmax) {
  // windows of at most 16 durations: NSRC = 4 consecutive start frames a
  // thread, the threads' A partials over W = NSRC + 15 end frames and gd
  // partials of every duration in shared memory; while TX >= 16 fits
  constexpr int nsrc = 4, W = nsrc + kWinPass - 1;
  for (int TX = 64; Dmax <= kWinPass && TX >= 16; TX /= 2) {
    const long NS = (long)TX + Dmax - 1;
    const long nj = (NS + nsrc - 1) / nsrc;
    const long threads = (nj * L + 31) / 32 * 32;
    const size_t bytes =
        sizeof(float) * (2 * (size_t)NS * L + NS + (size_t)Dmax * L + Dmax +
                         (size_t)Dmax * nj * L + (size_t)nj * W * L);
    if (threads <= xi_threads(nsrc) && bytes <= kSmemLimit)
      return {TX, (int)nj, nsrc, (int)threads, bytes, true};
  }
  for (int TX = 64; TX >= 1; TX /= 2)
    for (int nsrc : {4, 8, 16}) {
      const long NS = (long)TX + Dmax - 1;
      const long nj = (NS + nsrc - 1) / nsrc;
      const long threads = (nj * L + 31) / 32 * 32;
      if (threads > xi_threads(nsrc)) continue;
      const size_t bytes =
          sizeof(float) * (2 * (size_t)NS * L + NS + (size_t)TX * L +
                           (size_t)Dmax * L + Dmax +
                           kGdPass * (size_t)nj * L);
      if (bytes <= kSmemLimit)
        return {TX, (int)nj, nsrc, (int)threads, bytes, false};
    }
  return {0, 0, 0, 0, 0, false};
}

// K11 takes what K9 takes (the three-barrier frame's widths) and its two
// parts fit: the larger part's shared memory, 0 if not taken.
size_t grad_bytes(int L, int Dmax) {
  if (!make_plan(L, Dmax).ok) return 0;
  const size_t m = msg_bytes(L, nullptr);
  const XiPlan x = xi_plan(L, Dmax);
  if (m == 0 || x.bytes == 0) return 0;
  return m > x.bytes ? m : x.bytes;
}

// The whole number a rebased recursion (K9's note) takes off its rows at a
// cycle's first frame: the row maximum of the frame before, rounded (0 for
// a row of NEG_INF alone).
__device__ __forceinline__ float rebase_shift(float mrow) {
  return mrow > 0.5f * kNegInf ? rintf(mrow) : 0.0f;
}

// The slot of source frame t - 1 - d when frame t sits in slot r = t mod
// Dmax (0 <= d < t, d < Dmax).
__device__ __forceinline__ int source_slot(int r, int d, int Dmax) {
  const int s = r - 1 - d;
  return s < 0 ? s + Dmax : s;
}

// message + seg[t, d, l] for the segment over frames [t - d, t]: the window
// holds q (or M) and CS[u + 1] of source frame u = t - 1 - d; d == t is the
// segment from frame 0, whose message is 0 and whose CS is 0.  EXACT: single
// IEEE operations in the plain version's order.
template <bool EXACT>
__device__ __forceinline__ float window_term(const float* qw,
                                             const float* csw,
                                             const float* biasv,
                                             const float* invd, int t, int r,
                                             int d, int l, int L, int Dmax,
                                             float cum) {
  float q = 0.0f, cs = 0.0f;
  if (d < t) {
    const int s = source_slot(r, d, Dmax);
    q = qw[s * L + l];
    cs = csw[s * L + l];
  }
  if (EXACT)
    return __fadd_rn(q, __fadd_rn(__fmul_rn(__fsub_rn(cum, cs), invd[d]),
                                  biasv[d * L + l]));
  return q + ((cum - cs) * invd[d] + biasv[d * L + l]);
}

// invd[d]: 1 / (d + 1) for mean pooling (one IEEE division, the plain
// version's bits), else 1
__device__ __forceinline__ float pool_weight(int d, int mean_pool) {
  return mean_pool ? __fdiv_rn(1.0f, (float)(d + 1)) : 1.0f;
}

// max(max_p X[l, p], NEG_INF), X = trans (ROWS: the row maxima tmax_r, as
// kernels/fwdbwd.backward_factors takes them) or trans^T (the column maxima
// tmax, as forward_factors does)
template <bool ROWS>
__device__ __forceinline__ float trans_max(const float* __restrict__ trans,
                                           int L, int l) {
  float x = kNegInf;
  for (int p = 0; p < L; ++p)
    x = fmaxf(x, ROWS ? trans[(size_t)l * L + p] : trans[(size_t)p * L + l]);
  return x;
}

__device__ __forceinline__ float group_max(float x) {
  for (int o = 1; o < kGroup; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int o = 1; o < kGroup; o <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Loads what every kernel keeps in shared memory beside the factor.
__device__ __forceinline__ void stage_bias(const float* __restrict__ bias_g,
                                           const float* __restrict__ invd_g,
                                           float* biasv, float* invd, int L,
                                           int Dmax) {
  for (int i = threadIdx.x; i < Dmax * L; i += blockDim.x)
    biasv[i] = bias_g[i];
  for (int d = threadIdx.x; d < Dmax; d += blockDim.x) invd[d] = invd_g[d];
}

// K9 (VIT false): out = alphas, zout = logZ, rebased where off is given
// (off, zhat); factor = P.
// K12 (VIT true): out = deltas, argd, zout = scores, lab0; factor = trans.
template <bool VIT>
__global__ void __launch_bounds__(kMaxThreads)
seg_forward_kernel(const float* __restrict__ frame,
                   const float* __restrict__ factor,
                   const float* __restrict__ tmax_g,
                   const float* __restrict__ bias_g,
                   const float* __restrict__ invd_g,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   int* __restrict__ argd, float* __restrict__ zout,
                   int* __restrict__ lab0, float* __restrict__ off,
                   float* __restrict__ zhat, int T, int L, int Dmax, int ps,
                   int use_thr, float thr) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* Pm = smem;
  stage_matrix(factor, smem, L, ps);
  float* qw = smem + (size_t)L * ps;           // (Dmax, L) q or M by slot
  float* csw = qw + Dmax * L;                  // (Dmax, L) CS[u + 1] by slot
  float* biasv = csw + Dmax * L;               // (Dmax, L)
  float* invd = biasv + Dmax * L;              // (Dmax)
  float* a = invd + Dmax;                      // (L) alpha[t] / raw delta[t]
  float* e = a + L;                            // (L) exp(a - m) / delta[t]
  float* tmx = e + L;                          // (L)

  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* fb = frame + (size_t)b * T * L;
  float* ob = out + (size_t)b * T * L;
  int* ab = VIT ? argd + (size_t)b * T * L : nullptr;
  float* offb = !VIT && off ? off + (size_t)b * T : nullptr;

  stage_bias(bias_g, invd_g, biasv, invd, L, Dmax);
  for (int l = tid; l < L; l += nth) {
    a[l] = kNegInf;
    e[l] = kNegInf;
    tmx[l] = VIT ? 0.0f : tmax_g[l];
  }
  for (size_t i = (size_t)len * L + tid; i < (size_t)T * L; i += nth) {
    ob[i] = kNegInf;
    if (VIT) ab[i] = 0;
  }
  if (offb)
    for (int i = len + tid; i < T; i += nth) offb[i] = 0.0f;
  __syncthreads();

  const int g = tid % kGroup, l = tid / kGroup;
  const bool ok = l < L, mine = ok && g == 0;
  float cum = 0.0f;                            // CS[t + 1, l]
  int r = 0;                                   // t mod Dmax
  float base = 0.0f, mrow = 0.0f;              // the rebasing (K9's note)
  for (int t = 0; t < len; ++t) {
    if (offb && r == 0 && t > 0) {             // a cycle's first frame
      const float shift = rebase_shift(mrow);
      base += shift;
      if (ok)
        for (int s = g; s < Dmax; s += kGroup) qw[s * L + l] -= shift;
      __syncwarp();
    }
    if (ok) cum += fb[(size_t)t * L + l];
    const int dhi = min(t, Dmax - 1);
    float m[1];
    if (VIT) {
      float bv = -INFINITY;
      int bd = INT_MAX;
      if (ok)
        for (int d = g; d <= dhi; d += kGroup) {
          const float c = window_term<true>(qw, csw, biasv, invd, t, r, d, l,
                                            L, Dmax, cum);
          if (c > bv) {                        // ascending d: the shortest
            bv = c;
            bd = d;
          }
        }
      for (int o = 1; o < kGroup; o <<= 1)
        take_better(bv, bd, __shfl_xor_sync(0xffffffffu, bv, o),
                    __shfl_xor_sync(0xffffffffu, bd, o));
      if (mine) a[l] = bv;
      __syncthreads();
      row_max<1>(a, L, m);
      if (mine) {
        if (use_thr && !(bv >= __fsub_rn(m[0], thr))) bv = kNegInf;
        e[l] = bv;
        ob[(size_t)t * L + l] = bv;
        ab[(size_t)t * L + l] = bd;
      }
      __syncthreads();
      // M[t, l] = max_p delta[t, p] + trans[p, l]
      float mv = -INFINITY;
      if (ok)
        for (int p = g; p < L; p += kGroup)
          mv = fmaxf(mv, __fadd_rn(e[p], Pm[(size_t)p * ps + l]));
      mv = group_max(mv);
      if (mine) {
        qw[r * L + l] = mv;
        csw[r * L + l] = cum;
      }
    } else {
      float mx = kNegInf;
      if (ok)
        for (int d = g; d <= dhi; d += kGroup)
          mx = fmaxf(mx, window_term<false>(qw, csw, biasv, invd, t, r, d, l,
                                            L, Dmax, cum));
      mx = group_max(mx);
      float sum = 0.0f;
      if (ok)
        for (int d = g; d <= dhi; d += kGroup)
          sum += expf(window_term<false>(qw, csw, biasv, invd, t, r, d, l, L,
                                         Dmax, cum) - mx);
      sum = group_sum(sum);
      const float alpha = mx + logf(fmaxf(sum, kProdFloor));
      if (mine) {
        a[l] = alpha;
        ob[(size_t)t * L + l] = alpha;
      }
      __syncthreads();
      row_max<1>(a, L, m);
      mrow = m[0];
      if (offb && tid == 0) offb[t] = base;
      if (mine) e[l] = expf(alpha - m[0]);
      __syncthreads();
      float acc[1];
      group_dot<1>(e, Pm, ps, L, ok ? l : 0, g, ok, acc);
      if (mine) {
        qw[r * L + l] = m[0] + tmx[l] + logf(fmaxf(acc[0], kProdFloor));
        csw[r * L + l] = cum;
      }
    }
    __syncthreads();
    r = r + 1 == Dmax ? 0 : r + 1;
  }

  // the last frame's row: logZ = lse(alpha), or the best score and the
  // lowest label that reaches it
  if (tid < 32) {
    if (VIT) {
      float v = -INFINITY;
      int i = INT_MAX;
      for (int k = tid; k < L; k += 32) take_better(v, i, e[k], k);
      for (int o = 16; o > 0; o >>= 1)
        take_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
                    __shfl_xor_sync(0xffffffffu, i, o));
      if (tid == 0) {
        zout[b] = len > 0 ? v : kNegInf;
        lab0[b] = len > 0 ? i : 0;
      }
    } else {
      float m[1];
      row_max<1>(a, L, m);
      float sum = 0.0f;
      for (int k = tid; k < L; k += 32) sum += expf(a[k] - m[0]);
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float z = m[0] + logf(fmaxf(sum, kProdFloor));
      if (tid == 0) {
        zout[b] = z + base;
        if (zhat) zhat[b] = z;
      }
    }
  }
}

// K10.  The window holds beta[v] and R[v + 1] of the frames above, R[k] the
// sum of the frames k .. length - 1: CS[b] - CS[a] = R[a] - R[b].  Rebased
// where off is given.
__global__ void __launch_bounds__(kMaxThreads)
seg_backward_kernel(const float* __restrict__ frame,
                    const float* __restrict__ Ptg,
                    const float* __restrict__ tmaxr_g,
                    const float* __restrict__ bias_g,
                    const float* __restrict__ invd_g,
                    const int* __restrict__ lengths, float* __restrict__ betas,
                    float* __restrict__ off, int T, int L, int Dmax, int ps) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* Pm = smem;
  stage_matrix(Ptg, smem, L, ps);
  float* bw = smem + (size_t)L * ps;           // (Dmax, L) beta[v] by slot
  float* rw = bw + Dmax * L;                   // (Dmax, L) R[v + 1] by slot
  float* biasv = rw + Dmax * L;
  float* invd = biasv + Dmax * L;
  float* x = invd + Dmax;                      // (L) z[t]
  float* v = x + L;                            // (L) exp(z - zm)
  float* tmx = v + L;                          // (L)

  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* fb = frame + (size_t)b * T * L;
  float* ob = betas + (size_t)b * T * L;
  float* offb = off ? off + (size_t)b * T : nullptr;

  stage_bias(bias_g, invd_g, biasv, invd, L, Dmax);
  for (int l = tid; l < L; l += nth) tmx[l] = tmaxr_g[l];
  for (size_t i = (size_t)len * L + tid; i < (size_t)T * L; i += nth)
    ob[i] = kNegInf;
  if (offb)
    for (int i = len + tid; i < T; i += nth) offb[i] = 0.0f;
  __syncthreads();

  const int g = tid % kGroup, l = tid / kGroup;
  const bool ok = l < L, mine = ok && g == 0;
  float rnow = 0.0f;                           // R[t + 1, l]
  int r = len > 0 ? (len - 1) % Dmax : 0;      // t mod Dmax
  float base = 0.0f, mrow = 0.0f;              // the rebasing (K10's note)
  for (int t = len - 1; t >= 0; --t) {
    if (offb && r == Dmax - 1 && t < len - 1) {  // a cycle's top frame
      const float shift = rebase_shift(mrow);
      base += shift;
      if (ok)
        for (int s = g; s < Dmax; s += kGroup) bw[s * L + l] -= shift;
      __syncwarp();
    }
    float beta = 0.0f;                         // beta[length - 1] = 0
    if (t < len - 1) {
      const int dhi = min(Dmax - 1, len - 2 - t);
      float mx = kNegInf, sum = 0.0f;
      for (int pass = 0; pass < 2; ++pass) {
        if (ok)
          for (int d = g; d <= dhi; d += kGroup) {
            int s = r + 1 + d;                 // the slot of frame t + d + 1
            if (s >= Dmax) s -= Dmax;
            const float w = ((rnow - rw[s * L + l]) * invd[d] +
                             biasv[d * L + l]) + bw[s * L + l];
            if (pass == 0)
              mx = fmaxf(mx, w);
            else
              sum += expf(w - mx);
          }
        if (pass == 0) mx = group_max(mx);
      }
      sum = group_sum(sum);
      const float z = mx + logf(fmaxf(sum, kProdFloor));
      if (mine) x[l] = z;
      __syncthreads();
      float zm[1];
      row_max<1>(x, L, zm);
      mrow = zm[0];
      if (mine) v[l] = expf(z - zm[0]);
      __syncthreads();
      float acc[1];
      group_dot<1>(v, Pm, ps, L, ok ? l : 0, g, ok, acc);
      beta = zm[0] + tmx[l < L ? l : 0] + logf(fmaxf(acc[0], kProdFloor));
    }
    if (offb && tid == 0) offb[t] = base;
    if (mine) {
      ob[(size_t)t * L + l] = beta;
      bw[r * L + l] = beta;
      rw[r * L + l] = rnow;
    }
    if (ok) rnow += fb[(size_t)t * L + l];
    __syncthreads();
    r = r == 0 ? Dmax - 1 : r - 1;
  }
}


// The max-plus counterpart of quarter_dot<1, D, QV, SHARED>: out = max_p
// (x[p] + F[l_g, p]) for destination g (every lane for D = 1), x a row of
// 16 QV floats, 16-byte aligned.  Lane g takes its quarter, pruning each
// x[p] below cut to NEG_INF on read (prune: K12's beam), then the group's
// maxima are reduced and scattered by shuffles.  Single adds and maxima are
// exact in any order.  F's pads past L are -INFINITY: a pad entry never
// wins or ties.
template <int D, int QV, bool SHARED>
__device__ __forceinline__ float quarter_max(
    const float* x, const FactorRows<D, QV, SHARED>& f, int g, bool prune,
    float cut) {
  static_assert(D == 1 || D == 4, "destinations a group");
  const float4* xv = reinterpret_cast<const float4*>(x) + g * QV;
  float a[D];
#pragma unroll
  for (int d = 0; d < D; ++d) a[d] = -INFINITY;
#pragma unroll
  for (int k = 0; k < QV; ++k) {
    float4 v = xv[k];
    if (prune) {
      v.x = v.x >= cut ? v.x : kNegInf;
      v.y = v.y >= cut ? v.y : kNegInf;
      v.z = v.z >= cut ? v.z : kNegInf;
      v.w = v.w >= cut ? v.w : kNegInf;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float4 w = f.at(d, k);
      a[d] = fmaxf(a[d], fmaxf(fmaxf(__fadd_rn(v.x, w.x), __fadd_rn(v.y, w.y)),
                               fmaxf(__fadd_rn(v.z, w.z),
                                     __fadd_rn(v.w, w.w))));
    }
  }
  constexpr unsigned kAll = 0xffffffffu;
  if constexpr (D == 1) {
    return group_max(a[0]);
  } else {
    const bool hi2 = g & 2, hi1 = g & 1;
    const float w0 = fmaxf(hi2 ? a[2] : a[0],
                           __shfl_xor_sync(kAll, hi2 ? a[0] : a[2], 2));
    const float w1 = fmaxf(hi2 ? a[3] : a[1],
                           __shfl_xor_sync(kAll, hi2 ? a[1] : a[3], 2));
    return fmaxf(hi1 ? w1 : w0, __shfl_xor_sync(kAll, hi1 ? w0 : w1, 1));
  }
}

// K9 on fwdbwd.cu's recursion frame: alphas (B, T, L), logZ (B,).  Group
// `slot` (kGroup lanes) owns destinations l[d] = slot + d nslots; its lane g
// takes the window terms of durations g, g + 4, ... of each, and finishes
// destination g (g < D): the alpha entry, the message and the slots.
//
// Rebased (off given): the alphas grow by ~log L a frame (logZ ~2e3 at T =
// 512, config 4), and fp32 rows at that size round each step at ~1e-4, which
// left ~1e-3 on the gradient's posteriors.  So the frames are taken in cycles
// of Dmax (frame t in cycle t / Dmax, in slot r = t mod Dmax), and each
// cycle's rows are kept less a whole number base, off[t] (B, T): at a cycle's
// first frame the base rises by the last row's maximum, rounded
// (rebase_shift), and the messages in the window's slots, all of the cycle
// before, are lowered by that shift there, once (each group its own labels'
// slots).  Every offset is a whole number,
// so each difference of them is exact; the rows, messages and window terms
// stay within ~Dmax log L of 0.  alphas + off[..., None] are the alphas;
// logZ = zhat + off[length - 1], zhat (B,) the last row's log-sum itself.
// Every thread takes the same row maximum, so every thread keeps the base in
// registers; without off the rows are the alphas themselves.
template <int QV, int D, bool SHARED>
__global__ void __launch_bounds__(kFrameThreads)
seg_alpha_kernel(const float* __restrict__ frame,
                 const float* __restrict__ trans,
                 const float* __restrict__ bias_g, int mean_pool,
                 const int* __restrict__ lengths, float* __restrict__ alphas,
                 float* __restrict__ logZ, float* __restrict__ off,
                 float* __restrict__ zhat, int T, int L, int Dmax, int ws) {
  constexpr int Lq = 16 * QV;
  extern __shared__ float4 smem4[];
  float* Fs = reinterpret_cast<float*>(smem4);       // SHARED: (L, Lq)
  float* arow = Fs + (SHARED ? (size_t)L * Lq : 0);  // (2, Lq) by parity
  float* qw = arow + 2 * Lq;                         // (Dmax, ws) q by slot
  float* csw = qw + (size_t)Dmax * ws;               // (Dmax, ws) CS[u + 1]
  float* tcol = csw + (size_t)Dmax * ws;             // SHARED: (L) tmax
  const int tid = threadIdx.x, nth = blockDim.x;
  const int slot = tid / kGroup, nslots = nth / kGroup, g = tid % kGroup;
  int l[D];
  bool ok[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    l[d] = slot + d * nslots;
    ok[d] = l[d] < L;
  }
  const bool own = g < D && slot + g * nslots < L;
  const int lo = own ? slot + g * nslots : 0;        // my destination
  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* fb = frame + (size_t)b * T * L;
  float* ob = alphas + (size_t)b * T * L;
  float* offb = off ? off + (size_t)b * T : nullptr;

  // the factor, destination-major, formed here from trans: F[l, p] =
  // exp(trans[p, l] - tmax[l]), tmax the column maxima clamped at NEG_INF
  FactorRows<D, QV, SHARED> f;
  float tm = 0.0f;                                   // tmax[lo]
  if constexpr (SHARED) {
    for (int c = tid; c < L; c += nth) tcol[c] = trans_max<false>(trans, L, c);
    __syncthreads();
    for (int i = tid; i < L * Lq; i += nth) {
      const int r = i / Lq, c = i - r * Lq;
      Fs[i] = c < L ? expf(trans[(size_t)c * L + r] - tcol[r]) : 0.0f;
    }
    f.load(nullptr, Fs, L, l, g);
    if (own) tm = tcol[lo];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float cm = ok[d] ? trans_max<false>(trans, L, l[d]) : 0.0f;
      if (own && lo == l[d]) tm = cm;
#pragma unroll
      for (int k = 0; k < QV; ++k) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 4 * (QV * g + k) + j;
          v[j] = ok[d] && p < L ? expf(trans[(size_t)p * L + l[d]] - cm)
                                : 0.0f;
        }
        f.r[d][k] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  for (int j = tid; j < 2 * Lq; j += nth) arow[j] = kNegInf;
  for (size_t i = (size_t)len * L + tid; i < (size_t)T * L; i += nth)
    ob[i] = kNegInf;
  if (offb)
    for (int i = len + tid; i < T; i += nth) offb[i] = 0.0f;
  // the bias and invd of durations g + 4 i (i < kWin), constant over frames
  float bz[D][kWin], iv[kWin];
#pragma unroll
  for (int i = 0; i < kWin; ++i) {
    const int d = g + kGroup * i;
    iv[i] = d < Dmax ? pool_weight(d, mean_pool) : 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k)
      bz[k][i] = d < Dmax && ok[k] ? bias_g[(size_t)d * L + l[k]] : 0.0f;
  }
  float cum[D], cur[D];                // CS[t + 1] and frame t's scores
#pragma unroll
  for (int k = 0; k < D; ++k) {
    cum[k] = 0.0f;
    cur[k] = len > 0 && ok[k] ? fb[l[k]] : 0.0f;
  }
  __syncthreads();

  float base = 0.0f, mrow = 0.0f;      // the rebasing, above
  for (int t0 = 0; t0 < len; t0 += Dmax) {   // a cycle of Dmax frames
    if (offb && t0 > 0) {
      const float shift = rebase_shift(mrow);
      base += shift;
#pragma unroll
      for (int k = 0; k < D; ++k)
        if (ok[k])
          for (int s = g; s < Dmax; s += kGroup) qw[s * ws + l[k]] -= shift;
      __syncwarp();
    }
    const int t1 = min(t0 + Dmax, len);
    if (offb)
      for (int t = t0 + tid; t < t1; t += nth) offb[t] = base;
    for (int t = t0, r = 0; t < t1; ++t, ++r) {  // r = t mod Dmax
      float nxt[D];                      // a frame ahead of its use
#pragma unroll
      for (int k = 0; k < D; ++k) {
        nxt[k] = t + 1 < len && ok[k] ? fb[(size_t)(t + 1) * L + l[k]] : 0.0f;
        cum[k] += cur[k];
      }
      const int dhi = min(t, Dmax - 1);
      float alpha[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float mx = kNegInf, sum = 0.0f;
        for (int c = 0; c <= dhi; c += kWinPass) {
          float w[kWin];
          float cm = kNegInf;
#pragma unroll
          for (int i = 0; i < kWin; ++i) {
            const int d = c + g + kGroup * i;
            w[i] = -INFINITY;
            if (ok[k] && d <= dhi) {
              float q = 0.0f, cs = 0.0f;
              if (d < t) {
                const int s = source_slot(r, d, Dmax);
                q = qw[s * ws + l[k]];
                cs = csw[s * ws + l[k]];
              }
              const float bv = c == 0 ? bz[k][i] : bias_g[(size_t)d * L + l[k]];
              const float in = c == 0 ? iv[i] : pool_weight(d, mean_pool);
              w[i] = q + ((cum[k] - cs) * in + bv);
              cm = fmaxf(cm, w[i]);
            }
          }
          cm = group_max(cm);
          if (c == 0) {
            mx = cm;
          } else if (cm > mx) {          // a deeper pass: rescale online
            sum *= __expf(mx - cm);
            mx = cm;
          }
#pragma unroll
          for (int i = 0; i < kWin; ++i)
            if (w[i] != -INFINITY) sum += __expf(w[i] - mx);
        }
        alpha[k] = mx + __logf(fmaxf(group_sum(sum), kProdFloor));
      }
      float* at = arow + (t & 1) * Lq;
      float am = alpha[0], cm = cum[0];
#pragma unroll
      for (int k = 1; k < D; ++k)
        if (g == k) {
          am = alpha[k];
          cm = cum[k];
        }
      if (own) {
        at[lo] = am;
        ob[(size_t)t * L + lo] = am;
      }
      __syncthreads();
      float m[1];
      row_max_redux<1, (QV + 1) / 2>(at, L, m);
      mrow = m[0];
      float acc[(D + 3) / 4];
      quarter_dot<1, D, QV, SHARED, true>(at, f, g, acc, m[0]);
      if (own) {
        qw[r * ws + lo] = m[0] + tm + __logf(fmaxf(acc[0], kProdFloor));
        csw[r * ws + lo] = cm;
      }
      __syncwarp();                    // the group's slots, for frame t + 1
#pragma unroll
      for (int k = 0; k < D; ++k) cur[k] = nxt[k];
    }
  }

  // logZ = lse(alpha[length - 1]); an empty row reads NEG_INF
  if (tid < 32) {
    const float* last = arow + ((len - 1) & 1) * Lq;
    float m[1];
    row_max<1>(last, L, m);
    float sum = 0.0f;
    for (int k = tid; k < L; k += 32) sum += expf(last[k] - m[0]);
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float z = m[0] + logf(fmaxf(sum, kProdFloor));
    if (tid == 0) {
      logZ[b] = z + base;
      if (zhat) zhat[b] = z;
    }
  }
}

// K10 on K9's frame, mirrored in time: betas (B, T, L), the frames walked
// down from length - 1 (beta = 0 there).  The slots hold beta[v] and
// R[v + 1] of the frames above, by v mod Dmax, R[k] the sum of frames k ..
// length - 1 (CS[b] - CS[a] = R[a] - R[b]); the window of frame t takes the
// segments [t + 1, v], v = t + d + 1 < length.  Group `slot` owns
// destinations l[d] = slot + d nslots as in K9; destination l's factor row
// is row l of trans: F[l, p] = exp(trans[l, p] - tmax_r[l]).  Rebased as K9
// where off is given, its cycles walked down: the base rises at a cycle's
// top frame (r = Dmax - 1, below frame length - 1) by the last z row's
// maximum, rounded, and the window's betas, all of the cycle above, are
// lowered by that shift in their slots; betas + off[..., None] are the
// betas.
template <int QV, int D, bool SHARED>
__global__ void __launch_bounds__(kFrameThreads)
seg_beta_kernel(const float* __restrict__ frame,
                const float* __restrict__ trans,
                const float* __restrict__ bias_g, int mean_pool,
                const int* __restrict__ lengths, float* __restrict__ betas,
                float* __restrict__ off, int T, int L, int Dmax, int ws) {
  constexpr int Lq = 16 * QV;
  extern __shared__ float4 smem4[];
  float* Fs = reinterpret_cast<float*>(smem4);       // SHARED: (L, Lq)
  float* zrow = Fs + (SHARED ? (size_t)L * Lq : 0);  // (2, Lq) z by parity
  float* bw = zrow + 2 * Lq;                         // (Dmax, ws) beta[v]
  float* rw = bw + (size_t)Dmax * ws;                // (Dmax, ws) R[v + 1]
  float* trow = rw + (size_t)Dmax * ws;              // SHARED: (L) tmax_r
  const int tid = threadIdx.x, nth = blockDim.x;
  const int slot = tid / kGroup, nslots = nth / kGroup, g = tid % kGroup;
  int l[D];
  bool ok[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    l[d] = slot + d * nslots;
    ok[d] = l[d] < L;
  }
  const bool own = g < D && slot + g * nslots < L;
  const int lo = own ? slot + g * nslots : 0;        // my destination
  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* fb = frame + (size_t)b * T * L;
  float* ob = betas + (size_t)b * T * L;
  float* offb = off ? off + (size_t)b * T : nullptr;

  // the factor, destination-major, formed here from trans's rows
  FactorRows<D, QV, SHARED> f;
  float tm = 0.0f;                                   // tmax_r[lo]
  if constexpr (SHARED) {
    for (int c = tid; c < L; c += nth) trow[c] = trans_max<true>(trans, L, c);
    __syncthreads();
    for (int i = tid; i < L * Lq; i += nth) {
      const int r = i / Lq, c = i - r * Lq;
      Fs[i] = c < L ? expf(trans[(size_t)r * L + c] - trow[r]) : 0.0f;
    }
    f.load(nullptr, Fs, L, l, g);
    if (own) tm = trow[lo];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float rm = ok[d] ? trans_max<true>(trans, L, l[d]) : 0.0f;
      if (own && lo == l[d]) tm = rm;
#pragma unroll
      for (int k = 0; k < QV; ++k) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 4 * (QV * g + k) + j;
          v[j] = ok[d] && p < L ? expf(trans[(size_t)l[d] * L + p] - rm)
                                : 0.0f;
        }
        f.r[d][k] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  for (int j = tid; j < 2 * Lq; j += nth) zrow[j] = kNegInf;
  for (size_t i = (size_t)len * L + tid; i < (size_t)T * L; i += nth)
    ob[i] = kNegInf;
  if (offb)
    for (int i = len + tid; i < T; i += nth) offb[i] = 0.0f;
  // the bias and invd of durations g + 4 i (i < kWin), constant over frames
  float bz[D][kWin], iv[kWin];
#pragma unroll
  for (int i = 0; i < kWin; ++i) {
    const int d = g + kGroup * i;
    iv[i] = d < Dmax ? pool_weight(d, mean_pool) : 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k)
      bz[k][i] = d < Dmax && ok[k] ? bias_g[(size_t)d * L + l[k]] : 0.0f;
  }
  float rnow[D], cur[D];               // R[t + 1] and frame t's scores
#pragma unroll
  for (int k = 0; k < D; ++k) {
    rnow[k] = 0.0f;
    cur[k] = len > 0 && ok[k] ? fb[(size_t)(len - 1) * L + l[k]] : 0.0f;
  }
  __syncthreads();

  float base = 0.0f, mrow = 0.0f;      // the rebasing, above
  for (int t1 = len - 1; t1 >= 0;) {  // a cycle's frames, from its top t1
    const int t0 = t1 - t1 % Dmax;
    if (offb && t1 < len - 1) {
      const float shift = rebase_shift(mrow);
      base += shift;
#pragma unroll
      for (int k = 0; k < D; ++k)
        if (ok[k])
          for (int s = g; s < Dmax; s += kGroup) bw[s * ws + l[k]] -= shift;
      __syncwarp();
    }
    if (offb)
      for (int t = t0 + tid; t <= t1; t += nth) offb[t] = base;
    for (int t = t1, r = t1 - t0; t >= t0; --t, --r) {  // r = t mod Dmax
      float nxt[D];                      // a frame ahead of its use
#pragma unroll
      for (int k = 0; k < D; ++k)
        nxt[k] = t > 0 && ok[k] ? fb[(size_t)(t - 1) * L + l[k]] : 0.0f;
      float beta = 0.0f;                 // beta[length - 1] = 0
      if (t < len - 1) {                 // the same for the whole block
        const int dhi = min(Dmax - 1, len - 2 - t);
        float z[D];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          float mx = kNegInf, sum = 0.0f;
          for (int c = 0; c <= dhi; c += kWinPass) {
            float w[kWin];
            float cm = kNegInf;
#pragma unroll
            for (int i = 0; i < kWin; ++i) {
              const int d = c + g + kGroup * i;
              w[i] = -INFINITY;
              if (ok[k] && d <= dhi) {
                int s = r + 1 + d;       // the slot of frame t + d + 1
                if (s >= Dmax) s -= Dmax;
                const float bv =
                    c == 0 ? bz[k][i] : bias_g[(size_t)d * L + l[k]];
                const float in = c == 0 ? iv[i] : pool_weight(d, mean_pool);
                w[i] = ((rnow[k] - rw[s * ws + l[k]]) * in + bv) +
                       bw[s * ws + l[k]];
                cm = fmaxf(cm, w[i]);
              }
            }
            cm = group_max(cm);
            if (c == 0) {
              mx = cm;
            } else if (cm > mx) {        // a deeper pass: rescale online
              sum *= __expf(mx - cm);
              mx = cm;
            }
#pragma unroll
            for (int i = 0; i < kWin; ++i)
              if (w[i] != -INFINITY) sum += __expf(w[i] - mx);
          }
          z[k] = mx + __logf(fmaxf(group_sum(sum), kProdFloor));
        }
        float* zt = zrow + (t & 1) * Lq;
        float zo = z[0];
#pragma unroll
        for (int k = 1; k < D; ++k)
          if (g == k) zo = z[k];
        if (own) zt[lo] = zo;
        __syncthreads();
        float m[1];
        row_max_redux<1, (QV + 1) / 2>(zt, L, m);
        mrow = m[0];
        float acc[(D + 3) / 4];
        quarter_dot<1, D, QV, SHARED, true>(zt, f, g, acc, m[0]);
        beta = m[0] + tm + __logf(fmaxf(acc[0], kProdFloor));
      }
      float ro = rnow[0];
#pragma unroll
      for (int k = 1; k < D; ++k)
        if (g == k) ro = rnow[k];
      if (own) {
        ob[(size_t)t * L + lo] = beta;
        bw[r * ws + lo] = beta;
        rw[r * ws + lo] = ro;
      }
      __syncwarp();                    // the group's slots, for frame t - 1
#pragma unroll
      for (int k = 0; k < D; ++k) {
        rnow[k] += cur[k];
        cur[k] = nxt[k];
      }
    }
    t1 = t0 - 1;
  }
}

// K12 on K9's frame: deltas, arg_d (B, T, L), scores, lab0 (B,).  The slots
// hold M[u] and CS[u + 1] of source frame u; destination l's factor row is
// column l of trans (pads -INFINITY); the raw delta row is the one row the
// block shares, each lane applying the beam to its own quarter on read.
// Every sum is a single IEEE operation in the plain version's order and
// every max exact, so the outputs are the plain version's bits.
template <int QV, int D, bool SHARED>
__global__ void __launch_bounds__(kFrameThreads)
seg_delta_kernel(const float* __restrict__ frame,
                 const float* __restrict__ trans,
                 const float* __restrict__ bias_g, int mean_pool,
                 const int* __restrict__ lengths, float* __restrict__ deltas,
                 int* __restrict__ argd, float* __restrict__ scores,
                 int* __restrict__ lab0, int T, int L, int Dmax, int ws,
                 int use_thr, float thr) {
  constexpr int Lq = 16 * QV;
  extern __shared__ float4 smem4[];
  float* Fs = reinterpret_cast<float*>(smem4);       // SHARED: (L, Lq)
  float* drow = Fs + (SHARED ? (size_t)L * Lq : 0);  // (2, Lq) by parity
  float* mw = drow + 2 * Lq;                         // (Dmax, ws) M by slot
  float* csw = mw + (size_t)Dmax * ws;               // (Dmax, ws) CS[u + 1]
  const int tid = threadIdx.x, nth = blockDim.x;
  const int slot = tid / kGroup, nslots = nth / kGroup, g = tid % kGroup;
  int l[D];
  bool ok[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    l[d] = slot + d * nslots;
    ok[d] = l[d] < L;
  }
  const bool own = g < D && slot + g * nslots < L;
  const int lo = own ? slot + g * nslots : 0;        // my destination
  const int b = blockIdx.x;
  const int len = min(max(lengths[b], 0), T);
  const float* fb = frame + (size_t)b * T * L;
  float* ob = deltas + (size_t)b * T * L;
  int* ab = argd + (size_t)b * T * L;

  // the factor, destination-major: F[l, p] = trans[p, l], -INFINITY past L
  FactorRows<D, QV, SHARED> f;
  if constexpr (SHARED) {
    for (int i = tid; i < L * Lq; i += nth) {
      const int r = i / Lq, c = i - r * Lq;
      Fs[i] = c < L ? trans[(size_t)c * L + r] : -INFINITY;
    }
    f.load(nullptr, Fs, L, l, g);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int k = 0; k < QV; ++k) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 4 * (QV * g + k) + j;
          v[j] = ok[d] && p < L ? trans[(size_t)p * L + l[d]] : -INFINITY;
        }
        f.r[d][k] = make_float4(v[0], v[1], v[2], v[3]);
      }
  }
  for (int j = tid; j < 2 * Lq; j += nth) drow[j] = kNegInf;
  for (size_t i = (size_t)len * L + tid; i < (size_t)T * L; i += nth) {
    ob[i] = kNegInf;
    ab[i] = 0;
  }
  // the bias and invd of durations g + 4 i (i < kWin), constant over frames
  float bz[D][kWin], iv[kWin];
#pragma unroll
  for (int i = 0; i < kWin; ++i) {
    const int d = g + kGroup * i;
    iv[i] = d < Dmax ? pool_weight(d, mean_pool) : 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k)
      bz[k][i] = d < Dmax && ok[k] ? bias_g[(size_t)d * L + l[k]] : 0.0f;
  }
  float cum[D], cur[D];                // CS[t + 1] and frame t's scores
#pragma unroll
  for (int k = 0; k < D; ++k) {
    cum[k] = 0.0f;
    cur[k] = len > 0 && ok[k] ? fb[l[k]] : 0.0f;
  }
  __syncthreads();

  const bool prune = use_thr != 0;
  float cut = 0.0f;                    // the beam's cut of the last frame
  int r = 0;                           // t mod Dmax
  for (int t = 0; t < len; ++t) {
    float nxt[D];                      // a frame ahead of its use
#pragma unroll
    for (int k = 0; k < D; ++k) {
      nxt[k] = t + 1 < len && ok[k] ? fb[(size_t)(t + 1) * L + l[k]] : 0.0f;
      cum[k] += cur[k];
    }
    const int dhi = min(t, Dmax - 1);
    // delta[t, l] = max_d M[t - 1 - d, l] + seg[t, d, l]: a lane's first
    // maximum over its ascending d, then the group's by take_better
    float best[D];
    int bestd[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      best[k] = -INFINITY;
      bestd[k] = INT_MAX;
      for (int c = 0; c <= dhi; c += kWinPass)
#pragma unroll
        for (int i = 0; i < kWin; ++i) {
          const int d = c + g + kGroup * i;
          if (!ok[k] || d > dhi) continue;
          float q = 0.0f, cs = 0.0f;
          if (d < t) {
            const int s = source_slot(r, d, Dmax);
            q = mw[s * ws + l[k]];
            cs = csw[s * ws + l[k]];
          }
          const float bv = c == 0 ? bz[k][i] : bias_g[(size_t)d * L + l[k]];
          const float in = c == 0 ? iv[i] : pool_weight(d, mean_pool);
          const float w =
              __fadd_rn(q, __fadd_rn(__fmul_rn(__fsub_rn(cum[k], cs), in),
                                     bv));
          if (w > best[k]) {           // ascending d: the shortest
            best[k] = w;
            bestd[k] = d;
          }
        }
      for (int o = 1; o < kGroup; o <<= 1)
        take_better(best[k], bestd[k],
                    __shfl_xor_sync(0xffffffffu, best[k], o),
                    __shfl_xor_sync(0xffffffffu, bestd[k], o));
    }
    float dv = best[0], cm = cum[0];
    int dd = bestd[0];
#pragma unroll
    for (int k = 1; k < D; ++k)
      if (g == k) {
        dv = best[k];
        dd = bestd[k];
        cm = cum[k];
      }
    float* dt = drow + (t & 1) * Lq;
    if (own) dt[lo] = dv;
    __syncthreads();
    if (prune) {                       // the same for the whole block
      float m[1];
      row_max_redux<1, (QV + 1) / 2>(dt, L, m);
      cut = __fsub_rn(m[0], thr);
    }
    // M[t, l] = max_p delta[t, p] + trans[p, l] over the pruned row
    const float mv = quarter_max(dt, f, g, prune, cut);
    if (own) {
      ob[(size_t)t * L + lo] = prune && !(dv >= cut) ? kNegInf : dv;
      ab[(size_t)t * L + lo] = dd;
      mw[r * ws + lo] = mv;
      csw[r * ws + lo] = cm;
    }
    __syncwarp();                      // the group's slots, for frame t + 1
    r = r + 1 == Dmax ? 0 : r + 1;
#pragma unroll
    for (int k = 0; k < D; ++k) cur[k] = nxt[k];
  }

  // the best score of the last (pruned) row and the lowest label reaching
  // it; an empty row reports NEG_INF and label 0
  if (tid < 32) {
    const float* last = drow + ((len - 1) & 1) * Lq;
    float v = -INFINITY;
    int i = INT_MAX;
    for (int k = tid; k < L; k += 32) {
      const float x = last[k];
      take_better(v, i, prune && !(x >= cut) ? kNegInf : x, k);
    }
    for (int o = 16; o > 0; o >>= 1)
      take_better(v, i, __shfl_xor_sync(0xffffffffu, v, o),
                  __shfl_xor_sync(0xffffffffu, i, o));
    if (tid == 0) {
      scores[b] = len > 0 ? v : kNegInf;
      lab0[b] = len > 0 ? i : 0;
    }
  }
}

// dst[0, n) = src[0, n) by cp.async, every copy in flight at once; each
// thread waits for its own, the caller's barrier for everyone's.
__device__ __forceinline__ void stage_async(float* dst,
                                            const float* __restrict__ src,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    fdtk::cp_async4(dst + i, src + i);
  fdtk::cp_async_commit();
  fdtk::cp_async_wait<0>();
}

// K11's message pass over frames [t0, t0 + TC) of utterance blockIdx.y (t0
// = TC blockIdx.x): m (B, T) the row maxima of alpha, E (B, T, L4) =
// exp(alpha - m) (0 in the pad columns and at and past the length) and q
// (B, T, L) the messages; the last block of each utterance (blockIdx.x ==
// gridDim.x - 1) writes cs (B, T, L) = CS[u + 1], the running sum in frame
// order (the plain version's bits), one thread a label, the block staging
// TC frames at a time.  Rows at and past the length of q, cs and m are not
// written.  The factor P is formed from trans (L, L) in shared memory, its
// rows padded to L4 with zeros.
__global__ void __launch_bounds__(kMsgThreads)
seg_message_kernel(const float* __restrict__ alphas,
                   const float* __restrict__ frame,
                   const float* __restrict__ trans,
                   const int* __restrict__ lengths, float* __restrict__ E,
                   float* __restrict__ qg, float* __restrict__ csg,
                   float* __restrict__ mg, int T, int L, int TC) {
  extern __shared__ float4 smem4[];
  const int L4 = round_up4(L);
  float* Ps = reinterpret_cast<float*>(smem4);     // (L, L4)
  float* Es = Ps + (size_t)L * L4;                 // (TC, L4)
  float* As = Es + (size_t)TC * L4;                // (TC, L) alpha rows
  float* tmx = As + (size_t)TC * L;                // (L)
  float* ms = tmx + L;                             // (TC)
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * TC;
  const int len = min(max(lengths[b], 0), T);
  const size_t row0 = (size_t)b * T;
  if (blockIdx.x == gridDim.x - 1) {               // the running sums
    float cum = 0.0f;
    for (int c0 = 0; c0 < len; c0 += TC) {
      const int n = min(TC, len - c0);
      __syncthreads();                             // the last rows are read
      stage_async(As, frame + (row0 + c0) * L, n * L);
      __syncthreads();
      if (tid < L)
        for (int tt = 0; tt < n; ++tt) {
          cum += As[tt * L + tid];
          csg[(row0 + c0 + tt) * L + tid] = cum;
        }
    }
    return;
  }
  const int n = max(min(TC, len - t0), 0);         // live frames here
  // rows at and past the length: E is 0 there
  const int z0 = t0 + n, z1 = min(t0 + TC, T);
  for (int i = tid; i < (z1 - z0) * L4; i += nth)
    E[(row0 + z0) * L4 + i] = 0.0f;
  if (n == 0) return;
  for (int i = tid; i < L * L4; i += nth) {
    const int p = i / L4, c = i - p * L4;
    fdtk::cp_async4(Ps + i, trans + (size_t)p * L + min(c, L - 1),
                    c < L ? 4 : 0);
  }
  stage_async(As, alphas + (row0 + t0) * L, n * L);
  __syncthreads();
  // the factor from trans, in place: P = exp(trans - tmax), tmax the
  // column maxima clamped at NEG_INF (kernels/fwdbwd.forward_factors)
  for (int c = tid; c < L; c += nth) {
    float x = kNegInf;
    for (int p = 0; p < L; ++p) x = fmaxf(x, Ps[p * L4 + c]);
    tmx[c] = x;
  }
  __syncthreads();
  for (int i = tid; i < L * L4; i += nth) {
    const int c = i % L4;
    if (c < L) Ps[i] = expf(Ps[i] - tmx[c]);
  }
  for (int tt = warp; tt < n; tt += nwarps) {
    float x = kNegInf;
    for (int l = lane; l < L; l += 32) x = fmaxf(x, As[tt * L + l]);
    for (int o = 16; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) {
      ms[tt] = x;
      mg[row0 + t0 + tt] = x;
    }
  }
  __syncthreads();
  for (int i = tid; i < TC * L4; i += nth) {
    const int tt = i / L4, p = i - tt * L4;
    const float e = tt < n && p < L ? __expf(As[tt * L + p] - ms[tt]) : 0.0f;
    Es[i] = e;
    if (tt < n) E[(row0 + t0) * L4 + i] = e;
  }
  __syncthreads();
  // q on 4 x 4 tiles (frames f0.., labels l0..): the factor's row p read as
  // one float4, E[f][p] broadcast
  const int nl = L4 / 4, ng = (n + 3) / 4;
  for (int w = tid; w < ng * nl; w += nth) {
    const int f0 = (w / nl) * 4, l0 = (w % nl) * 4;
    float acc[4][4] = {};
    for (int p = 0; p < L; ++p) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + p * L4 + l0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = Es[(f0 + j) * L4 + p];
        acc[j][0] = fmaf(e, pv.x, acc[j][0]);
        acc[j][1] = fmaf(e, pv.y, acc[j][1]);
        acc[j][2] = fmaf(e, pv.z, acc[j][2]);
        acc[j][3] = fmaf(e, pv.w, acc[j][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int tt = f0 + j, l = l0 + k;
        if (tt < n && l < L)
          qg[(row0 + t0 + tt) * L + l] =
              ms[tt] + tmx[l] + __logf(fmaxf(acc[j][k], kProdFloor));
      }
  }
}

// K11's xi pass, the part its two kernels share.  The block of start frames
// [k0, k0 + TX) of utterance blockIdx.y (k0 = TX blockIdx.x) writes A and S
// of frames [k0, k0 + TX), F of source frames [k0 - 1, k0 + TX - 1) (and
// the last row, from the last chunk) and its gd partial (Dmax, L).  It also
// reads the Dmax - 1 start frames before k0 (their segments that end in the
// chunk feed A) and the Dmax - 1 end frames after it (the segments of its
// start frames that end there feed S and F).  Rows no segment reaches are
// zeroed here; the block's CS and beta - logZ of end frames [k0, te), the
// bias and invd are staged into shared memory.
//
// Rebased rows (K9's note; aoff and boff given): alphas, so q and m, are
// less the whole numbers aoff (B, T), betas less boff, and logZ less aoff
// at frame length - 1 (oz).  A term's exponent is then the sum of a part of
// rebased rows and the whole number aoff[u] + boff[t] - oz, which is exact:
// the staged ko[t] = boff[t] - oz of each end frame, and a source's aoff[u]
// in a register.  Without offsets both are 0.
struct XiChunk {
  int len, k0, k1, kh, te;    // start frames [kh, k1) read, ends [k0, te)
  size_t row0;
  float lz, gb;
  float* gdb;                 // this block's gd partial
  const float* aoff;          // rebased alphas' offsets, or null
};

__device__ __forceinline__ bool xi_begin(
    XiChunk& c, const float* __restrict__ csg, const float* __restrict__ betas,
    const float* __restrict__ logZ, const float* __restrict__ gvec,
    const float* __restrict__ aoff, const float* __restrict__ boff,
    const float* __restrict__ bias_g, int mean_pool,
    const int* __restrict__ lengths, float* __restrict__ A,
    float* __restrict__ S, float* __restrict__ F,
    float* __restrict__ gd_part, float* cums, float* x0s, float* kos,
    float* bs, float* iv, int T, int L, int Dmax, int TX) {
  const int tid = threadIdx.x, nth = blockDim.x, L4 = round_up4(L);
  const int b = blockIdx.y;
  c.k0 = blockIdx.x * TX;
  c.len = min(max(lengths[b], 0), T);
  c.row0 = (size_t)b * T;
  c.gdb = gd_part + ((size_t)b * gridDim.x + blockIdx.x) * Dmax * L;
  const int kend = min(c.k0 + TX, T);              // the chunk's frames
  c.k1 = min(kend, max(c.len, c.k0));              // ... that start segments
  // rows no segment reaches: A, S of [k1, kend), F of sources [k1 - 1, ...)
  for (int i = tid; i < (kend - c.k1) * L; i += nth) {
    const size_t o = (c.row0 + c.k1) * L + i;
    A[o] = 0.0f;
    S[o] = 0.0f;
  }
  const int fr0 = max(c.k1 - 1, 0), fr1 = c.k0 + TX >= T ? T : kend - 1;
  for (int i = tid; i < (fr1 - fr0) * L; i += nth) {
    const int u = fr0 + i / L, l = i % L;
    F[(c.row0 + u) * L4 + l] = 0.0f;
  }
  if (c.k1 <= c.k0) {                              // past the length
    for (int i = tid; i < Dmax * L; i += nth) c.gdb[i] = 0.0f;
    return false;
  }
  c.kh = max(c.k0 - Dmax + 1, 0);
  c.te = min(c.k1 + Dmax - 1, c.len);
  c.lz = logZ[b];
  c.gb = gvec[b];
  c.aoff = aoff;
  const float oz = aoff ? aoff[c.row0 + c.len - 1] : 0.0f;
  for (int i = tid; i < c.te - c.k0; i += nth)
    kos[i] = (boff ? boff[c.row0 + c.k0 + i] : 0.0f) - oz;
  const int ne = (c.te - c.k0) * L;
  const size_t o = (c.row0 + c.k0) * L;
  for (int i = tid; i < ne; i += nth) {
    fdtk::cp_async4(cums + i, csg + o + i);
    fdtk::cp_async4(x0s + i, betas + o + i);
  }
  for (int i = tid; i < Dmax * L; i += nth) fdtk::cp_async4(bs + i, bias_g + i);
  for (int d = tid; d < Dmax; d += nth) iv[d] = pool_weight(d, mean_pool);
  fdtk::cp_async_commit();
  fdtk::cp_async_wait<0>();
  for (int i = tid; i < ne; i += nth) x0s[i] -= c.lz;   // its own copies
  return true;
}

// The message, CS, m and offset of start frame k's source u = k - 1 (0 for
// k == 0: the segment from frame 0 has no source).
__device__ __forceinline__ void xi_source(const float* __restrict__ qg,
                                          const float* __restrict__ csg,
                                          const float* __restrict__ mg,
                                          const XiChunk& c, int k, int l,
                                          int L, bool live, float& q,
                                          float& cs, float& m, float& ov) {
  q = cs = m = ov = 0.0f;
  if (live && k > 0) {
    const size_t o = (c.row0 + k - 1) * L + l;
    q = qg[o];
    cs = csg[o];
    m = mg[c.row0 + k - 1];
    if (c.aoff) ov = c.aoff[c.row0 + k - 1];
  }
}

// Any window depth.  Thread (jl, l): label l, start frames kh + jl + NJ i
// (i < NSRC), whose message, CS and m sit in its registers while the block
// steps d over the window: S, F and gd gathered in registers, A in shared
// memory, one barrier a duration; the threads' gd partials of kGdPass
// durations are summed once a pass.  Each exponential is one ex2.approx of
// its (small, non-positive) exponent times log2(e); g is applied once to
// each sum.
template <int NSRC>
__global__ void __launch_bounds__(xi_threads(NSRC))
seg_xi_kernel(const float* __restrict__ qg, const float* __restrict__ csg,
              const float* __restrict__ mg, const float* __restrict__ betas,
              const float* __restrict__ logZ, const float* __restrict__ gvec,
              const float* __restrict__ aoff, const float* __restrict__ boff,
              const float* __restrict__ bias_g, int mean_pool,
              const int* __restrict__ lengths, float* __restrict__ A,
              float* __restrict__ S, float* __restrict__ F,
              float* __restrict__ gd_part, int T, int L, int Dmax, int TX,
              int NJ) {
  extern __shared__ float4 smem4[];
  const int L4 = round_up4(L);
  const int NSmax = TX + Dmax - 1;
  float* cums = reinterpret_cast<float*>(smem4);   // (NSmax, L) CS[t + 1]
  float* x0s = cums + (size_t)NSmax * L;           // (NSmax, L) beta - logZ
  float* As = x0s + (size_t)NSmax * L;             // (TX, L)
  float* bs = As + (size_t)TX * L;                 // (Dmax, L)
  float* iv = bs + (size_t)Dmax * L;               // (Dmax)
  float* gdp = iv + Dmax;                          // (kGdPass, NJ, L)
  float* kos = gdp + (size_t)kGdPass * NJ * L;     // (NSmax) offsets
  const int tid = threadIdx.x, nth = blockDim.x;
  XiChunk c;
  if (!xi_begin(c, csg, betas, logZ, gvec, aoff, boff, bias_g, mean_pool,
                lengths, A, S, F, gd_part, cums, x0s, kos, bs, iv, T, L,
                Dmax, TX))
    return;
  const int k0 = c.k0;
  for (int i = tid; i < TX * L; i += nth) As[i] = 0.0f;
  // start frame k = k0 + kk[i] takes durations [dlo, dhi): its segments
  // that end in [k0, te)
  const int jl = tid / L, l = tid % L;
  const bool act = jl < NJ;
  float qv[NSRC], cv[NSRC], mv[NSRC], ov[NSRC], sacc[NSRC], facc[NSRC];
  int kk[NSRC], dlo[NSRC], dhi[NSRC];
#pragma unroll
  for (int i = 0; i < NSRC; ++i) {
    const int k = c.kh + jl + NJ * i;
    sacc[i] = facc[i] = 0.0f;
    kk[i] = k - k0;
    dlo[i] = max(k0 - k, 0);
    dhi[i] = act && k < c.k1 ? c.te - k : 0;
    xi_source(qg, csg, mg, c, k, l, L, dhi[i] > 0, qv[i], cv[i], mv[i],
              ov[i]);
  }
  __syncthreads();

  const int dmax = min(Dmax, c.te - c.kh);         // durations that occur
  for (int d = 0; d < dmax; ++d) {
    float gdl = 0.0f;
    if (act) {
      const float in = iv[d], bv = bs[d * L + l];
#pragma unroll
      for (int i = 0; i < NSRC; ++i) {
        if (d < dlo[i] || d >= dhi[i]) continue;
        const int e = kk[i] + d;                   // end frame t - k0
        const float xv = ((cums[e * L + l] - cv[i]) * in + bv) +
                         x0s[e * L + l];
        const float kv = ov[i] + kos[e];           // exact: whole numbers
        const float xi = __expf((qv[i] + xv) + kv);
        const float y = in * xi;
        if (e < TX) As[e * L + l] += y;
        if (kk[i] >= 0) {                          // a start frame of mine
          sacc[i] += y;
          gdl += xi;
          if (kk[i] + k0 > 0) facc[i] += __expf((xv + mv[i]) + kv);
        }
      }
      gdp[((d % kGdPass) * NJ + jl) * L + l] = gdl;
    }
    __syncthreads();            // A of this duration
    if (d % kGdPass == kGdPass - 1 || d == dmax - 1) {
      // the gd partials of the last kGdPass durations, each summed over
      // its label's threads in order
      const int d0 = d - d % kGdPass;
      for (int o = tid; o < (d - d0 + 1) * L; o += nth) {
        const int dd = o / L, ll = o - dd * L;
        float s = 0.0f;
        for (int j = 0; j < NJ; ++j) s += gdp[(dd * NJ + j) * L + ll];
        c.gdb[(size_t)(d0 + dd) * L + ll] = c.gb * s;
      }
      __syncthreads();
    }
  }
  for (int d = dmax + tid; d < Dmax; d += nth)     // durations too long
    for (int i = 0; i < L; ++i) c.gdb[(size_t)d * L + i] = 0.0f;

  for (int i = tid; i < (c.k1 - k0) * L; i += nth)
    A[(c.row0 + k0) * L + i] = c.gb * As[i];
  if (act)
#pragma unroll
    for (int i = 0; i < NSRC; ++i) {
      const int k = k0 + kk[i];
      if (k < k0 || k >= c.k1) continue;
      S[(c.row0 + k) * L + l] = c.gb * sacc[i];
      if (k > 0) F[(c.row0 + k - 1) * L4 + l] = c.gb * facc[i];
    }
}

// Windows of at most kWinPass = 16 durations (config 4): thread (jl, l)
// owns the NSRC consecutive start frames kh + NSRC jl + i, and the block's
// durations are unrolled, so every term's sums sit in registers: S, F and
// the thread's A over the W = NSRC + 15 end frames its segments reach, with
// no barrier and no shared-memory update per term.  The threads' A and gd
// partials are summed at the end, each entry over its threads in order.
template <int NSRC>
__global__ void __launch_bounds__(xi_threads(NSRC))
seg_xi16_kernel(const float* __restrict__ qg, const float* __restrict__ csg,
                const float* __restrict__ mg,
                const float* __restrict__ betas,
                const float* __restrict__ logZ,
                const float* __restrict__ gvec,
                const float* __restrict__ aoff,
                const float* __restrict__ boff,
                const float* __restrict__ bias_g, int mean_pool,
                const int* __restrict__ lengths, float* __restrict__ A,
                float* __restrict__ S, float* __restrict__ F,
                float* __restrict__ gd_part, int T, int L, int Dmax, int TX,
                int NJ) {
  constexpr int W = NSRC + kWinPass - 1;
  extern __shared__ float4 smem4[];
  const int L4 = round_up4(L);
  const int NSmax = TX + Dmax - 1;
  float* cums = reinterpret_cast<float*>(smem4);   // (NSmax, L) CS[t + 1]
  float* x0s = cums + (size_t)NSmax * L;           // (NSmax, L) beta - logZ
  float* bs = x0s + (size_t)NSmax * L;             // (Dmax, L)
  float* iv = bs + (size_t)Dmax * L;               // (Dmax)
  float* gdp = iv + Dmax;                          // (Dmax, NJ, L)
  float* Ap = gdp + (size_t)Dmax * NJ * L;         // (NJ, W, L)
  float* kos = Ap + (size_t)NJ * W * L;            // (NSmax) offsets
  const int tid = threadIdx.x, nth = blockDim.x;
  XiChunk c;
  if (!xi_begin(c, csg, betas, logZ, gvec, aoff, boff, bias_g, mean_pool,
                lengths, A, S, F, gd_part, cums, x0s, kos, bs, iv, T, L,
                Dmax, TX))
    return;
  const int k0 = c.k0;
  const int jl = tid / L, l = tid % L;
  const bool act = jl < NJ;
  const int klo = c.kh + NSRC * jl;
  float qv[NSRC], cv[NSRC], mv[NSRC], ov[NSRC], sacc[NSRC], facc[NSRC], a[W];
#pragma unroll
  for (int i = 0; i < NSRC; ++i) {
    sacc[i] = facc[i] = 0.0f;
    xi_source(qg, csg, mg, c, klo + i, l, L, act && klo + i < c.k1, qv[i],
              cv[i], mv[i], ov[i]);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) a[w] = 0.0f;
  __syncthreads();

  if (act) {
#pragma unroll
    for (int d = 0; d < kWinPass; ++d) {
      if (d >= Dmax) break;
      const float in = iv[d], bv = bs[d * L + l];
      float gdl = 0.0f;
#pragma unroll
      for (int i = 0; i < NSRC; ++i) {
        const int k = klo + i, e = k + d - k0;     // end frame t - k0
        if (k >= c.k1 || e < 0 || k + d >= c.te) continue;
        const float xv = ((cums[e * L + l] - cv[i]) * in + bv) +
                         x0s[e * L + l];
        const float kv = ov[i] + kos[e];           // exact: whole numbers
        const float xi = __expf((qv[i] + xv) + kv);
        const float y = in * xi;
        a[i + d] += y;
        if (k >= k0) {                             // a start frame of mine
          sacc[i] += y;
          gdl += xi;
          if (k > 0) facc[i] += __expf((xv + mv[i]) + kv);
        }
      }
      gdp[((size_t)d * NJ + jl) * L + l] = gdl;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) Ap[((size_t)jl * W + w) * L + l] = a[w];
  }
  __syncthreads();

  // gd: each (d, l) over its label's threads in order
  for (int o = tid; o < Dmax * L; o += nth) {
    const int d = o / L, ll = o - d * L;
    float s = 0.0f;
    for (int j = 0; j < NJ; ++j) s += gdp[((size_t)d * NJ + j) * L + ll];
    c.gdb[o] = c.gb * s;
  }
  // A[t]: the partials of the threads whose end frames reach t, in order
  for (int o = tid; o < (c.k1 - k0) * L; o += nth) {
    const int r = k0 + o / L - c.kh, ll = o % L;
    const int j0 = max(0, (r - W + NSRC) / NSRC), j1 = min(NJ - 1, r / NSRC);
    float s = 0.0f;
    for (int j = j0; j <= j1; ++j)
      s += Ap[((size_t)j * W + r - NSRC * j) * L + ll];
    A[(c.row0 + k0) * L + o] = c.gb * s;
  }
  if (act)
#pragma unroll
    for (int i = 0; i < NSRC; ++i) {
      const int k = klo + i;
      if (k < k0 || k >= c.k1) continue;
      S[(c.row0 + k) * L + l] = c.gb * sacc[i];
      if (k > 0) F[(c.row0 + k - 1) * L4 + l] = c.gb * facc[i];
    }
}

// K13: one block an utterance (fdt_common.cuh's stream).  From (length -
// 1, lab0): the segment ending at t with label lab starts at t - arg_d[t,
// lab]; its predecessor, the label of the segment ending at start - 1, is
// the lowest p that maximises deltas[start - 1, p] + trans[p, lab].  Both
// reads of the next step (deltas and arg_d) lie in frame start - 1, so the
// walk holds one stream block at a time: frames [kC, min(kC + C, length)),
// deltas' rows then arg_d's in a slot, top block first.  Warp 0 walks: it
// takes the predecessor's argmax (two redux.sync on order keys) once the
// block holding start - 1 has landed, releasing each block it leaves or
// jumps over; the warp writes the markers (every lane the same word, one
// store).  trans^T (destination-major, so a lane's reads of a column are
// consecutive) is staged by the producers with the first block where it
// fits beside the ring (TS), else read from device memory, a column a
// segment.  NQ = 2: a lane takes its two labels unrolled (L <= 64); 0: a
// loop over the lane's labels.
template <bool TS, int NQ>
__global__ void __launch_bounds__(kTbThreads)
seg_traceback_kernel(const float* __restrict__ deltas,
                     const int* __restrict__ argd,
                     const float* __restrict__ trans,
                     const int* __restrict__ lab0,
                     const int* __restrict__ lengths,
                     int* __restrict__ end_lab, int* __restrict__ end_start,
                     int T, int L, int C) {
  extern __shared__ float4 tb_smem4[];
  const size_t slot = fdtk::tb_slot(C, L);
  float* ring = reinterpret_cast<float*>(tb_smem4);     // (kTbRing, 2, slot)
  float* trT = ring + 2 * kTbRing * slot;                // (L, L) if TS
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      trT + (TS ? seg_tb_trans_floats(L) : 0));
  unsigned long long* empty = full + kTbRing;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int t0 = min(max(lengths[b], 0), T) - 1;       // the last frame
  const int nblk = (t0 + C) / C;                        // 0 for t0 = -1
  const float* db = deltas + (size_t)b * T * L;
  const int* ab = argd + (size_t)b * T * L;
  if (tid == 0)
    for (int s = 0; s < kTbRing; ++s) {
      fdtk::mbar_init(&full[s], kTbProducers);
      fdtk::mbar_init(&empty[s], 1);
    }
  __syncthreads();                      // the barriers initialised

  if (tid >= 32) {                      // the stream, top block first
    const int p = tid - 32;
    if (TS && nblk > 0)                 // trT[l][q] = trans[q][l]
      for (int o = p; o < L * L; o += kTbProducers)
        fdtk::cp_async4(trT + (o % L) * L + o / L, trans + o);
    for (int i = 0; i < nblk; ++i) {
      const int f0 = (nblk - 1 - i) * C, n = (min(f0 + C, t0 + 1) - f0) * L;
      const int s = i % kTbRing;
      if (i >= kTbRing) fdtk::mbar_wait(&empty[s], (i / kTbRing - 1) & 1);
      float* sl = ring + 2 * s * slot;
      fdtk::tb_stream(sl, db + (size_t)f0 * L, n, p);
      fdtk::tb_stream(reinterpret_cast<int*>(sl + slot), ab + (size_t)f0 * L,
                      n, p);
      fdtk::cp_async_mbar_arrive(&full[s]);
    }
    fdtk::cp_async_wait<0>();
    return;
  }

  const int lane = tid;
  int* el = end_lab + (size_t)b * T;
  int* es = end_start + (size_t)b * T;
  for (int i = lane; i < T; i += 32) {
    el[i] = -1;
    es[i] = 0;
  }
  __syncwarp();                         // the lanes' stores before the walk's
  // the held stream block `held` and where frame f0 of it sits in its slot
  int held = -1, f0 = 0;
  const float* drow = nullptr;
  const int* arow = nullptr;
  // hold the stream block of frame u: release the held one, then wait for
  // (and release) every block down to it
  auto hold = [&](int u) {
    const int want = nblk - 1 - u / C;
    while (held < want) {
      if (held >= 0 && lane == 0) fdtk::mbar_arrive(&empty[held % kTbRing]);
      ++held;
      fdtk::mbar_wait(&full[held % kTbRing], (held / kTbRing) & 1);
    }
    f0 = (nblk - 1 - held) * C;
    const float* sl = ring + 2 * (held % kTbRing) * slot;
    drow = sl + fdtk::tb_align(db + (size_t)f0 * L) - (size_t)f0 * L;
    arow = reinterpret_cast<const int*>(sl + slot) +
           fdtk::tb_align(ab + (size_t)f0 * L) - (size_t)f0 * L;
  };
  // NQ = 2: the lane's labels lane and lane + 32 (L <= 64), read at an
  // index kept in range and dropped past L (a NaN candidate wins nothing)
  const int q0 = min(lane, L - 1), q1 = min(lane + 32, L - 1);
  const float nan = __int_as_float(0x7fc00000);
  const float off0 = lane < L ? 0.0f : nan, off1 = lane + 32 < L ? 0.0f : nan;
  int t = t0;
  int lab = min(max(lab0[b], 0), L - 1);
  if (t >= 0) hold(t);
  while (t >= 0) {
    // trans[., lab] for the predecessor's argmax, read before the chain's
    // loads (a barrier's wait in hold() would keep them behind it)
    float c0 = 0.0f, c1 = 0.0f;
    if constexpr (NQ == 2) {
      c0 = trT[lab * L + q0];
      c1 = trT[lab * L + q1];
    }
    const int start = t - max(arow[(size_t)t * L + lab], 0);
    el[t] = lab;                        // every lane: one store
    es[t] = start;
    if (start <= 0) break;
    t = start - 1;
    if (t < f0) hold(t);
    // the lowest p maximising deltas[t, p] + trans[p, lab]: each lane's
    // first maximum over its ascending p, then the warp's largest order
    // key (zeros made +0, so equal sums give equal keys) and the lowest
    // index holding it
    const float* dr = drow + (size_t)t * L;
    float v = -INFINITY;
    int i = INT_MAX;
    if constexpr (NQ == 2) {
      const float s0 = __fadd_rn(dr[q0], c0) + off0;
      const float s1 = __fadd_rn(dr[q1], c1) + off1;
      take_better(v, i, s0, lane);
      take_better(v, i, s1, lane + 32);
    } else {
      for (int q = lane; q < L; q += 32)
        take_better(v, i,
                    __fadd_rn(dr[q], TS ? trT[lab * L + q]
                                        : trans[(size_t)q * L + lab]),
                    q);
    }
    const int key = fdtk::order_key(__fadd_rn(v, 0.0f));
    const int top = __reduce_max_sync(0xffffffffu, key);
    const unsigned who = __reduce_min_sync(
        0xffffffffu, key == top ? static_cast<unsigned>(i) : UINT_MAX);
    lab = min(static_cast<int>(who), L - 1);
  }
  // release what is left, so the stream ends
  for (int i = max(held, 0); i < nblk; ++i) {
    if (i > held) fdtk::mbar_wait(&full[i % kTbRing], (i / kTbRing) & 1);
    if (lane == 0) fdtk::mbar_arrive(&empty[i % kTbRing]);
  }
}

// The frame's layout at width L: QV, D and whether the factor sits in
// shared memory (as kernels/fwdbwd.factor_layout, with the shared rows as
// short as L allows); false above L = 240.
bool frame_layout(int L, int& qv, int& D, int& shared) {
  D = 1;
  shared = 0;
  for (int q : {3, 5, 9})
    if (16 * q >= L) {
      qv = q;
      return L >= 1;
    }
  D = 4;
  shared = 1;
  qv = (L + 15) / 16;
  return qv <= 15;
}

// The frame of K9, K10 and K12 at (L, Dmax): QV of their own layout, 0 for
// the three-barrier frame, -1 if neither takes it; *bytes, *ws: the
// launch's shared memory and slot stride.
int recursion_frame(int L, int Dmax, size_t* bytes, int* ws) {
  const Plan p = make_plan(L, Dmax);
  *bytes = p.bytes;
  if (!p.ok) return -1;                // the three-barrier frame's widths
  int qv, D, shared;
  if (frame_layout(L, qv, D, shared)) {
    const size_t n = frame_bytes(L, Dmax, qv, D, shared, ws);
    if (n) {
      *bytes = n;
      return qv;
    }
  }
  return 0;
}

// A launch of K9 (out = alphas, zout = logZ; rebased where off is given:
// off, zhat), K10 (out = betas; rebased where off is given) or K12 (out =
// deltas, argd, zout = scores, lab0).
struct SegLaunch {
  const float* frame;
  const float* trans;
  const float* bias;
  int mean_pool;
  const int* lengths;
  float* out;
  int* argd;
  float* zout;
  int* lab0;
  float* off;
  float* zhat;
  int B, T, L, Dmax, use_thr;
  float thr;
};

template <int QV, int D, bool SHARED>
int launch_frame(Kind kind, const SegLaunch& a, size_t bytes, int ws,
                 cudaStream_t s) {
  const int threads = frame_threads(a.L, D);
  cudaError_t err;
  if (kind == kForward) {
    auto kernel = seg_alpha_kernel<QV, D, SHARED>;
    err = opt_in(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<a.B, threads, bytes, s>>>(a.frame, a.trans, a.bias,
                                         a.mean_pool, a.lengths, a.out,
                                         a.zout, a.off, a.zhat, a.T, a.L,
                                         a.Dmax, ws);
  } else if (kind == kBackward) {
    auto kernel = seg_beta_kernel<QV, D, SHARED>;
    err = opt_in(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<a.B, threads, bytes, s>>>(a.frame, a.trans, a.bias,
                                         a.mean_pool, a.lengths, a.out,
                                         a.off, a.T, a.L, a.Dmax, ws);
  } else {
    auto kernel = seg_delta_kernel<QV, D, SHARED>;
    err = opt_in(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<a.B, threads, bytes, s>>>(
          a.frame, a.trans, a.bias, a.mean_pool, a.lengths, a.out, a.argd,
          a.zout, a.lab0, a.T, a.L, a.Dmax, ws, a.use_thr, a.thr);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K9, K10 or K12: on their own frame, which forms the factor and invd from
// trans and the pooling; else on the three-barrier frame, which takes the
// factor (K9: P
// source-major, K10: Pt; K12: trans), its maxima and invd from the caller
// (null where seg_frame > 0).
int launch_recursion(Kind kind, const SegLaunch& a, const float* P,
                     const float* pmax, const float* invd, cudaStream_t s) {
  size_t bytes = 0;
  int ws = 0;
  const int qv = recursion_frame(a.L, a.Dmax, &bytes, &ws);
#define FRAME(Q, D, SH) \
  case Q:               \
    return launch_frame<Q, D, SH>(kind, a, bytes, ws, s)
  switch (qv) {
    FRAME(3, 1, false);
    FRAME(5, 1, false);
    FRAME(9, 1, false);
    FRAME(10, 4, true);
    FRAME(11, 4, true);
    FRAME(12, 4, true);
    FRAME(13, 4, true);
    FRAME(14, 4, true);
    FRAME(15, 4, true);
    case 0:
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FRAME
  const bool vit = kind == kViterbi;
  if (!invd || (!vit && (!P || !pmax)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(a.L, a.Dmax);
  const int threads = threads_for(a.L);
  cudaError_t err;
  if (kind == kBackward) {
    err = opt_in(seg_backward_kernel, p.bytes);
    if (err == cudaSuccess)
      seg_backward_kernel<<<a.B, threads, p.bytes, s>>>(
          a.frame, P, pmax, a.bias, invd, a.lengths, a.out, a.off, a.T, a.L,
          a.Dmax, p.ps);
  } else {
    auto kernel = vit ? seg_forward_kernel<true> : seg_forward_kernel<false>;
    err = opt_in(kernel, p.bytes);
    if (err == cudaSuccess)
      kernel<<<a.B, threads, p.bytes, s>>>(
          a.frame, vit ? a.trans : P, pmax, a.bias, invd, a.lengths, a.out,
          a.argd, a.zout, a.lab0, a.off, a.zhat, a.T, a.L, a.Dmax, p.ps,
          a.use_thr, a.thr);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int NSRC, bool WINDOWED>
int launch_xi(const XiPlan& x, const float* q, const float* cs,
              const float* m, const float* betas, const float* logZ,
              const float* g, const float* aoff, const float* boff,
              const float* bias, int mean_pool, const int* lengths, float* A,
              float* S, float* F, float* gd_part, int B, int T, int L,
              int Dmax, cudaStream_t s) {
  auto kernel = seg_xi_kernel<NSRC>;
  if constexpr (WINDOWED) kernel = seg_xi16_kernel<NSRC>;
  const cudaError_t err = opt_in(kernel, x.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + x.tx - 1) / x.tx, B);
  kernel<<<grid, x.threads, x.bytes, s>>>(q, cs, m, betas, logZ, g, aoff,
                                          boff, bias, mean_pool, lengths, A,
                                          S, F, gd_part, T, L, Dmax, x.tx,
                                          x.nj);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// A kernel's dynamic shared memory at (L, Dmax) in bytes, for the wrapper's
// check and the tests; 0: the kernel does not take them.  kind: 0 K9, 1 K12,
// 2 K10 (their frame's, seg_frame), 3 K11 (the larger of its message and xi
// passes').
size_t seg_smem_bytes(int kind, int L, int Dmax) {
  if (kind == kGrad) return grad_bytes(L, Dmax);
  size_t bytes = 0;
  int ws;
  return recursion_frame(L, Dmax, &bytes, &ws) >= 0 ? bytes : 0;
}

// The frame of K9, K10 and K12 at (L, Dmax): the QV of their own layout, 0
// for the three-barrier frame, -1 if they do not take them.
int seg_frame(int L, int Dmax) {
  size_t bytes;
  int ws;
  return recursion_frame(L, Dmax, &bytes, &ws);
}

// The start frames a block of K11's xi pass takes at (L, Dmax); its gd
// partials are (B ceil(T / chunk), Dmax, L).  0: not taken.
int seg_grad_chunk(int L, int Dmax) {
  return grad_bytes(L, Dmax) ? xi_plan(L, Dmax).tx : 0;
}

// The xi kernel K11 takes at (L, Dmax): 1 for seg_xi16_kernel (windows of
// at most 16 durations), 0 for seg_xi_kernel, -1 where it takes neither.
int seg_grad_xi16(int L, int Dmax) {
  if (!grad_bytes(L, Dmax)) return -1;
  return xi_plan(L, Dmax).windowed ? 1 : 0;
}

// K9: alphas (B, T, L), logZ (B,); off (B, T) and zhat (B,) null, or the
// rebased rows' offsets and the last row's log-sum (K9's note).  The
// three-barrier frame takes P (L, L) source-major, tmax and invd from the
// caller.
int seg_forward(const float* frame, const float* trans, const float* P,
                const float* tmax, const float* bias, const float* invd,
                int mean_pool, const int* lengths, float* alphas,
                float* logZ, float* off, float* zhat, int B, int T, int L,
                int Dmax, void* stream) {
  const SegLaunch a{frame, trans, bias, mean_pool, lengths, alphas, nullptr,
                    logZ,  nullptr, off, zhat,     B,       T,      L,
                    Dmax,  0,       0.0f};
  return launch_recursion(kForward, a, P, tmax, invd,
                          static_cast<cudaStream_t>(stream));
}

// K12: deltas, arg_d (B, T, L), scores, lab0 (B,).  The three-barrier frame
// takes invd from the caller.
int seg_viterbi(const float* frame, const float* trans, const float* bias,
                const float* invd, int mean_pool, const int* lengths,
                float* deltas, int* argd, float* scores, int* lab0, int B,
                int T, int L, int Dmax, int use_thr, float thr,
                void* stream) {
  const SegLaunch a{frame,   trans,   bias, mean_pool, lengths, deltas,
                    argd,    scores,  lab0, nullptr,   nullptr, B,
                    T,       L,       Dmax, use_thr,   thr};
  return launch_recursion(kViterbi, a, nullptr, nullptr, invd,
                          static_cast<cudaStream_t>(stream));
}

// K10: betas (B, T, L); off (B, T) null, or the rebased rows' offsets.
// The three-barrier frame takes Pt (L, L), tmax_r and invd from the caller.
int seg_backward(const float* frame, const float* trans, const float* Pt,
                 const float* tmax_r, const float* bias, const float* invd,
                 int mean_pool, const int* lengths, float* betas, float* off,
                 int B, int T, int L, int Dmax, void* stream) {
  const SegLaunch a{frame, trans,   bias,    mean_pool, lengths, betas,
                    nullptr, nullptr, nullptr, off,     nullptr, B,
                    T,     L,       Dmax,    0,         0.0f};
  return launch_recursion(kBackward, a, Pt, tmax_r, invd,
                          static_cast<cudaStream_t>(stream));
}

// K11's message pass: E (B, T, L4), q, cs (B, T, L), m (B, T) from alphas,
// frame (B, T, L) and trans (L, L).
int seg_grad_message(const float* alphas, const float* frame,
                     const float* trans, const int* lengths, float* E,
                     float* q, float* cs, float* m, int B, int T, int L,
                     int Dmax, void* stream) {
  int tc = 0;
  const size_t bytes = msg_bytes(L, &tc);
  if (!grad_bytes(L, Dmax)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = opt_in(seg_message_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + tc - 1) / tc + 1, B);      // + the running sums
  seg_message_kernel<<<grid, kMsgThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      alphas, frame, trans, lengths, E, q, cs, m, T, L, tc);
  return static_cast<int>(cudaGetLastError());
}

// K11's xi pass: A, S (B, T, L), F (B, T, L4), the gd partials gd_part
// (B ceil(T / seg_grad_chunk), Dmax, L), then gd (Dmax, L) = their sum in
// block order.  aoff, boff (B, T): null, or the offsets of rebased alphas
// and betas, logZ then K9's zhat.
int seg_grad_xi(const float* q, const float* cs, const float* m,
                const float* betas, const float* logZ, const float* g,
                const float* aoff, const float* boff, const float* bias,
                int mean_pool, const int* lengths, float* A, float* S,
                float* F, float* gd_part, float* gd, int B, int T, int L,
                int Dmax, void* stream) {
  if (!grad_bytes(L, Dmax)) return static_cast<int>(cudaErrorInvalidValue);
  const XiPlan x = xi_plan(L, Dmax);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
#define XI(NSRC, WIN)                                                    \
  launch_xi<NSRC, WIN>(x, q, cs, m, betas, logZ, g, aoff, boff, bias,   \
                       mean_pool, lengths, A, S, F, gd_part, B, T, L, Dmax, \
                       s)
  switch (x.windowed ? 0 : x.nsrc) {
    case 0: err = XI(4, true); break;
    case 4: err = XI(4, false); break;
    case 8: err = XI(8, false); break;
    default: err = XI(16, false);
  }
#undef XI
  if (err != 0) return err;
  const int n = Dmax * L, rows = B * ((T + x.tx - 1) / x.tx);
  fdtk::sum_partials_kernel<<<(n + 31) / 32, fdtk::kSumThreads, 0, s>>>(
      gd_part, gd, rows, n);
  return static_cast<int>(cudaGetLastError());
}

// K13's stream block: its frames C (the return; 0 where one frame does not
// fit a block's shared memory) and whether trans^T is staged beside the
// ring (*trans_shared).
int seg_traceback_frames(int L, int* trans_shared) {
  const int C = fdtk::tb_frames(L, 2, 4 * seg_tb_trans_floats(L));
  *trans_shared = C > 0;
  return C > 0 ? C : fdtk::tb_frames(L, 2, 0);
}

// K13: end_lab (B, T) (-1 where no segment ends), end_start (B, T); one
// block an utterance.
int seg_traceback(const float* deltas, const int* argd, const float* trans,
                  const int* lab0, const int* lengths, int* end_lab,
                  int* end_start, int B, int T, int L, void* stream) {
  int ts;
  const int C = seg_traceback_frames(L, &ts);
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      fdtk::tb_bytes(C, L, 2, ts ? 4 * seg_tb_trans_floats(L) : 0);
  const auto kernel = !ts     ? seg_traceback_kernel<false, 0>
                      : L <= 64 ? seg_traceback_kernel<true, 2>
                                : seg_traceback_kernel<true, 0>;
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kTbThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      deltas, argd, trans, lab0, lengths, end_lab, end_start, T, L, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
