"""Roofline model of the port's hot paths on one NVIDIA H100: how far from
the card's limits does a step run, and what floor can a redesign be held to?

Counterpart of :mod:`asr_craft_tpu.utils.roofline`.  The arithmetic
(:class:`ChipSpec`, :class:`Phase`, :meth:`Phase.sol_s`, :func:`summarize`)
is the JAX module's, so the same phases and the same spec give the same
record in both packages.  What the phases count is the port's own.

Model
-----
Every phase of a train or decode step is characterised by the bytes it must
move between device memory and the SMs (each input read once, each output
written once), its fp32 operations, and its element operations on the
recursion's critical path.  Its fp32 operations come in two kinds: the
matrix products with no dependence between frames (``mma_flops``: plane
formation, K2's, K5's and K11's contractions), which the tensor cores run at fp32
accuracy by 3xTF32, three TF32 products for one, so at a third of the TF32
rate; and the rest (``flops``), held to the CUDA cores' fp32 rate.  Its
speed-of-light time is

    sol = max(bytes / memory rate, mma_flops / (TF32 peak / 3),
              flops / fp32 peak,
              element operations / measured elementwise rate)

at the default ``mode="fp32"`` (the ``highest`` precision); ``mode``
``bf16x3`` holds the products to a third of the bf16 rate and ``default``
to the TF32 rate (:func:`_peak_flops`), the rest of the work to the fp32
rate as before

(the last term only when a measured rate is given), and phases run one after
another, so a step's SOL is the sum.  The counts follow the port's code, read
off ``csrc/*.cu`` and the wrappers: batch-major unpadded tensors, the packed
parameter matrix (``kernels/wall.py``), the planes formed before the
recursions, K2 as a recursion plus a contraction,
K5 as a recursion that writes its transition gradient's rows plus their
contraction on the tensor cores, K11 as a message pass, a frame-parallel
xi pass and the E^T F contraction on the tensor cores, and K13's walk of
one segment at a time.  None of the TPU's tile padding exists
here.

One definition of a kernel's bound.  :func:`kernel_phase` counts one kernel's
bytes and operations from its shapes; :func:`bound` turns a phase into the
least time the card could take.  ``chip_smoke.py``'s ``bound_ms`` and the
phase functions below both call them, so the kernel table of ``PERF.md`` and
the ``sol_ms`` of ``asr_craft_tpu_torch.bench`` cannot drift apart.

What the byte and operation counts do not see: every recursion is a chain of
up to 512 dependent frames in one block per utterance, so its time is
latency, 1-7% of the bound above.  Three pieces stand in for that, as in the
JAX module: the element-operation term held to a *measured* in-kernel rate
(:func:`measure_vpu_geps_pallas`, the K15 kernel), the per-kernel inventory
of element operations a frame (``_SCRF_PASSES``, :func:`scrf_tile_floor`,
:func:`fdt_tile_floor`), and the T-sweep fits of ``bench``.

Peaks: one H100 SXM, 3350 GB/s of device memory, 67 TFLOP/s fp32 on the
CUDA cores and 495 TFLOP/s TF32 on the tensor cores (NVIDIA's data sheet,
dense, at the 700 W limit).  Every kernel of the port computes in fp32 (the
tensor-core products in 3xTF32, which keeps fp32 accuracy), so ``mode``
takes ``"fp32"`` alone.  The planes of every frame are one phase of their
own (the plane kernel's), counted once a train step and once a decode; the
recursions that read them (K1, K2, K3) do no product.

Names, and their counterparts in the JAX module
-----------------------------------------------
=============================  =============================================
here                           ``asr_craft_tpu.utils.roofline``
=============================  =============================================
``ChipSpec``, ``Phase``,       the same (``ChipSpec`` gains the SM count,
``Phase.sol_s``, ``summarize`` clock and special-function width, which only
                               :func:`calibrate_phase` reads, and the TF32
                               rate; ``Phase`` gains ``mma_flops``: with none
                               the arithmetic is the JAX module's)
``H100``                       ``V5E`` (no TPU spec is carried over)
``train_step_phases``,         the same names, signatures and phase names;
``fdt_train_phases``,          the counts are the port's (``frames`` and
``fdt_decode_phases``,         ``segments`` are optional extras for ragged
``scrf_train_phases``,         batches and K13's data-dependent walk)
``scrf_decode_phases``,
``decode_phases``
``fdt_tile_floor``             the same name; ``fma_ms`` replaces
                               ``mxu_passes`` / ``mxu_ms`` (see its doc)
``_SCRF_PASSES``,              the same names; the inventory is recounted
``scrf_tile_floor``            from ``csrc/segmental.cu``
``vpu_elems``, ``vpu_geps``    kept: element operations on the CUDA cores
                               and their measured rate in 1e9 a second
``measure_stream_bw``          the same
``measure_vpu_geps_pallas``    the same name; runs K15
                               (``kernels/calibrate.py``, whose ``measure``
                               returns the whole record)
``measure_vpu_geps``           not carried over: it relies on XLA fusing a
                               24-stage chain into one pass; eager PyTorch
                               fuses nothing, so every stage would be a pass
                               over memory and the figure the memory rate
                               under another name.  K15 is the one
                               calibration, for the flagship's floor too.
``kernel_phase``, ``bound``,   new: the one definition of a kernel's bound
``calibrate_phase``            (``chip_smoke.py`` held its own before)
=============================  =============================================
"""
from __future__ import annotations

import dataclasses

__all__ = ["ChipSpec", "Phase", "H100", "KERNELS", "kernel_phase", "bound",
           "calibrate_phase", "train_step_phases", "fdt_train_phases",
           "decode_phases", "fdt_decode_phases", "scrf_train_phases",
           "scrf_decode_phases", "fdt_tile_floor", "scrf_tile_floor",
           "summarize", "measure_stream_bw", "measure_vpu_geps_pallas"]

_F32 = 4


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float        # device memory bandwidth, GB/s
    fp32_tflops: float     # fp32 TFLOP/s outside the tensor cores
    bf16_tflops: float     # tensor cores, dense (the bf16x3 products)
    sm_count: int = 0      # streaming multiprocessors
    sm_clock_ghz: float = 0.0      # boost clock
    sfu_per_sm_clk: int = 0        # special-function results / SM / clock
    tf32_tflops: float = 0.0       # tensor cores, dense TF32


H100 = ChipSpec(name="NVIDIA H100 SXM", hbm_gbps=3350.0, fp32_tflops=67.0,
                bf16_tflops=989.0, sm_count=132, sm_clock_ghz=1.98,
                sfu_per_sm_clk=16, tf32_tflops=495.0)


def _mma_peak(spec: ChipSpec) -> float:
    """FLOP/s of an fp32-accurate product on the tensor cores: 3xTF32 runs
    three TF32 products for each (the CUDA cores' rate on a spec without
    tensor cores)."""
    return (spec.tf32_tflops / 3 if spec.tf32_tflops
            else spec.fp32_tflops) * 1e12


def _peak_flops(spec: ChipSpec, mode: str) -> float:
    """FLOP/s of the products (a phase's ``mma_flops``) in the precision
    ``mode`` (``CrfConfig.precision``): ``fp32`` / ``highest`` the 3xTF32
    rate (:func:`_mma_peak`), ``bf16x3`` three bf16 products for each
    (``bf16_tflops / 3``), ``default`` one TF32 pass (``tf32_tflops``).  The
    rest of a phase's operations (``flops``) run at the fp32 rate in every
    mode: the recursions stay fp32.  ``bf16``, one bf16 pass, is the TPU's
    lowering of the reference's ``default``; no precision of the port runs
    it."""
    if mode in ("fp32", "highest"):
        return _mma_peak(spec)
    if mode == "bf16x3":
        return spec.bf16_tflops / 3 * 1e12
    if mode == "default":
        return (spec.tf32_tflops or spec.fp32_tflops) * 1e12
    raise NotImplementedError(
        f"roofline mode {mode!r}: the port's precisions are 'fp32' "
        "('highest'), 'bf16x3' and 'default' (one TF32 pass); a single bf16 "
        "pass is the TPU's lowering, which no precision of the port runs")


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    bytes: float
    flops: float
    # Element operations on the critical path (adds, maxes, exps of the
    # recursions: the work that is not a matrix product).  0 for phases
    # whose cost is bytes and FLOPs only.  Held to a MEASURED in-kernel
    # rate (measure_vpu_geps_pallas), so a latency-bound phase gets a
    # quantitative third roofline term.
    vpu_elems: float = 0.0
    # fp32 operations of matrix products with no dependence between frames,
    # held to the 3xTF32 rate of the tensor cores (_mma_peak); ``flops``
    # holds the rest
    mma_flops: float = 0.0

    def sol_s(self, spec: ChipSpec = H100, bw_gbps: float | None = None,
              fp32: bool = True, mode: str | None = None,
              vpu_geps: float | None = None) -> float:
        bw = (bw_gbps or spec.hbm_gbps) * 1e9
        mode = mode or ("fp32" if fp32 else "bf16")
        peak = _peak_flops(spec, mode)
        sol = max(self.bytes / bw, self.flops / (spec.fp32_tflops * 1e12))
        if self.mma_flops:
            sol = max(sol, self.mma_flops / peak)
        if vpu_geps and self.vpu_elems:
            sol = max(sol, self.vpu_elems / (vpu_geps * 1e9))
        return sol


def bound(phase: Phase, spec: ChipSpec = H100, mode: str = "fp32"):
    """``(bound_ms, bound_by)``: the least time the card could take for the
    phase's bytes and operations (its products at the rate of the precision
    ``mode``, :func:`_peak_flops`: 3xTF32 for ``fp32``; the rest at the fp32
    rate), and which binds."""
    by_bytes = phase.bytes / (spec.hbm_gbps * 1e9) * 1e3
    by_ops = max(phase.flops / (spec.fp32_tflops * 1e12),
                 phase.mma_flops / _peak_flops(spec, mode)) * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


# ---------------------------------------------------------------------------
# one kernel's bytes and operations
# ---------------------------------------------------------------------------

def _fdt_dims(L: int, D: int, ns: int, Du: int | None):
    """(P, L', R, Dw) of the packed parameter matrix: rows [state L' | self
    L' | adv L' | cross P * P], columns the Du transition dims and the bias
    (``kernels/wall.build_wall``)."""
    P = L // ns
    Du = D if Du is None else Du
    return P, L, 3 * L + P * P, Du + 1


# Element operations a frame: (per phone pair and lattice, per expanded
# label and lattice), counted line by line off the recursions' bodies at the
# flagship's ns = 3 (a phone's share spread over its ns labels).
# K1's recursion (csrc/fdt_train.cu fdt_train_fwd_kernel).  A phone pair
# and lattice: the term (an add), its max, its subtract, its expf and the
# sum's add: 5.  A label and lattice: the self and advance candidates (2),
# lse3 (the max of three and its clamp 3, three subtracts, three expf, two
# adds, the floor, a logf and an add: 14), alpha_t (two adds and the mask's
# compare: 3), and its share of a destination phone's cross lse (two
# 16-lane shuffle merges of 4 rounds each with their maxes and adds: 16;
# the clamp, the floor, a logf and an add: 4; 20 over the ns labels).
# K2's recursion (fdt_train_bwd_kernel).  A phone pair and lattice: the
# cross lse's max pass (an add, a max: 2), one exponential shared by the
# lse and the xi (an add, a subtract, the expf, the sum: 4) and the xi's
# multiply-add (1): 7.  A label and lattice: xs (two adds and the mask's
# compare: 3), the self and the advance xi (two adds, a subtract, a min, an
# expf, a multiply, the lattice sum: 7 each), beta_t's lse3 (the self and
# advance candidates 2, the max of three and its clamp 3, three subtracts,
# three expf, two adds, the floor, a logf and an add: 16), gamma_t (an add,
# a subtract, a min, an expf, a multiply, an add: 6), and its share of a
# source phone's work (two 16-lane shuffle merges of 4 rounds each with
# their maxes and adds: 16; the xi factor's add, subtract, min, expf and
# multiply: 5; the floor, a logf and an add: 3; 24 over the ns labels of a
# phone: 8 at ns = 3): 47.
# K3's recursion (csrc/fdt_viterbi.cu fdt_vit_fwd_kernel), one lattice, the
# exact decode.  A phone pair: the term (an add) and take_better's three
# compares and two selects: 6.  A label: the self and advance candidates
# (2), their max with the cross max (2), the backpointer's two compares,
# two selects and the cross label's multiply-add (5), the end mask's
# compare and add and the plane's add (3), and its share of a destination
# phone's cross max (one 16-lane merge of 4 rounds, two shuffles and
# take_better's five operations each: 28 over the ns labels).
_FDT_OPS = {"fwd": (5.0, 19.0 + 20.0 / 3), "bwd": (7.0, 47.0),
            "vit": (6.0, 12.0 + 28.0 / 3)}


def _fdt_elems(kind: str, frames: float, L: int, P: int) -> float:
    cross, row = _FDT_OPS[kind]
    lattices = 1 if kind == "vit" else 2
    return frames * lattices * (cross * P * P + row * L)


def _round_up4(n: int) -> int:
    """R4: a plane row's floats in the kernels' layout (16-byte rows)."""
    return (n + 3) // 4 * 4


def _plane_ops(frames: float, R: int, Dw: int) -> tuple[float, float]:
    """``(mma_flops, flops)`` of plane formation, ``Wall @ [x; 1]`` a frame,
    or of the ``dWall = dplane^T @ [x; 1]`` contraction: a product of depth
    Du = Dw - 1 and one add a row for the bias column (the contraction's
    column sum of dplane)."""
    return frames * 2.0 * R * (Dw - 1), frames * float(R)


def _k_fdt_viterbi_fwd(B, T, L, D, ns, Du=None, frames=None):
    """K3's recursion: every existing frame's plane row (B, T, R4) and the
    lengths in; backpointers (B, T, L') i32, last states and scores out.
    Per frame the max-plus step (an add and a compare per self, advance and
    cross term); it forms no plane."""
    P, Lp, R, Dw = _fdt_dims(L, D, ns, Du)
    frames = B * T if frames is None else frames
    return Phase("fdt_viterbi_fwd",
                 _F32 * (frames * _round_up4(R) + B * T * Lp + 3 * B),
                 frames * 2.0 * (2 * Lp + P * P),
                 _fdt_elems("vit", frames, Lp, P))


def _k_traceback(B, T, **_):
    """The traceback follows one backpointer a frame: B * T entries read
    (what this walk needs, not the whole (B, T, L') array), the last states
    and lengths, and B * T labels written."""
    return Phase("viterbi_traceback", _F32 * (2 * B * T + 2 * B),
                 float(B * T), float(B * T))


def _k_fdt_train_fwd(B, T, L, D, ns, Du=None, frames=None):
    """K1's recursion: every existing frame's plane row (B, T, R4), labels
    and lengths in; alphas (B, T, 2, L'), zf, zc out; two lattices'
    log-semiring step a frame.  It forms no plane."""
    P, Lp, R, Dw = _fdt_dims(L, D, ns, Du)
    frames = B * T if frames is None else frames
    dp = 2 * (2 * Lp + P * P)                       # one lattice's DP
    return Phase("fdt_train_fwd",
                 _F32 * (frames * _round_up4(R) + B * T + 2 * B * T * Lp
                         + 3 * B),
                 frames * 2 * dp, _fdt_elems("fwd", frames, Lp, P))


def _k_fdt_plane(name):
    """The plane kernel under the launch-count key ``name`` (training's
    ``fdt_train_plane``, the decode's ``fdt_viterbi_plane``)."""

    def count(B, T, L, D, ns, Du=None, frames=None):
        """Wall and feats in, every frame's plane (B, T, R) out; one product
        of depth Du, held to the 3xTF32 rate, and the bias column's add."""
        P, Lp, R, Dw = _fdt_dims(L, D, ns, Du)
        frames = B * T if frames is None else frames
        mma, bias = _plane_ops(frames, R, Dw)
        return Phase(name, _F32 * (R * Dw + B * T * D + B * T * R), bias,
                     0.0, mma)
    return count


def _k_fdt_train_bwd(B, T, L, D, ns, Du=None, frames=None):
    """K2's recursion: planes (B, T, R), labels, alphas, lengths, zf, zc,
    wf, wc in, dplane (B, T, R) out; beta, xi and gamma for both
    lattices."""
    P, Lp, R, Dw = _fdt_dims(L, D, ns, Du)
    frames = B * T if frames is None else frames
    dp = 2 * (2 * Lp + P * P)
    return Phase("fdt_train_bwd",
                 _F32 * (2 * B * T * R + B * T + 2 * B * T * Lp + 5 * B),
                 frames * 6 * dp, _fdt_elems("bwd", frames, Lp, P))


def _k_fdt_train_contract(B, T, L, D, ns, Du=None, frames=None):
    """K2's contraction ``dWall = dplane^T @ [x; 1]``: dplane and feats in,
    dWall out; one product of depth Du, held to the 3xTF32 rate, and the
    column sum of dplane that xu's ones column gives."""
    P, Lp, R, Dw = _fdt_dims(L, D, ns, Du)
    frames = B * T if frames is None else frames
    mma, colsum = _plane_ops(frames, R, Dw)
    return Phase("fdt_train_contract",
                 _F32 * (B * T * R + B * T * D + R * Dw), colsum, 0.0, mma)


def _shared_io(B, T, L):
    # state (B, T, L), trans, backpointers (B, T, L) i32, lengths, last, score
    return _F32 * (2 * B * T * L + L * L + 3 * B)


def _beam_select(frames, L, beam_width):
    """The beam width's cut a frame: the radix select of the bw-th largest
    of the row (csrc/viterbi.cu kth_largest), 32 rounds of a compare and an
    add per entry (one warp's share; the others repeat it)."""
    return frames * 32 * 2.0 * L if beam_width and beam_width < L else 0.0


def _k_viterbi_dense_fwd(B, T, L, frames=None, beam_width=None, **_):
    """K7: an add and a compare per (predecessor, destination) a frame,
    and the beam width's selection."""
    frames = B * T if frames is None else frames
    ops = frames * 2.0 * L * L + _beam_select(frames, L, beam_width)
    return Phase("viterbi_dense_fwd", _shared_io(B, T, L), ops, ops)


def _k_viterbi_nstate_fwd(B, T, L, ns, frames=None, rescans=0,
                          beam_width=None, **_):
    """K8: self and advance terms per state, cross terms per phone pair;
    ``rescans`` dense columns of L' predecessors (the dead destinations of
    this run's data: kernels.viterbi.nstate_rescans) and the beam width's
    selection."""
    frames = B * T if frames is None else frames
    P = L // ns
    ops = (frames * 2.0 * (2 * L + P * P) + rescans * 2.0 * L
           + _beam_select(frames, L, beam_width))
    return Phase("viterbi_nstate_fwd", _shared_io(B, T, L), ops, ops)


# Element operations a frame and label (both lattices of the dual kernels)
# beside the (L) x (L, L) products, counted line by line off csrc/fwdbwd.cu
# and fdt_common.cuh at the configs' layouts.  A lattice and label: its
# share of the row max (a max; the redux.sync is a warp's), the exp pass (a
# subtract, an expf), the group's merge of the destination's sum (four
# partial-sum adds, three shuffles and three adds of the reduce-scatter:
# 10), and its finish: the floor, a logf and three adds (alpha: m + tmax +
# log + state; beta: m + tmax + log, then x = beta + state): 18.  The clamped
# lattice adds its penalty (a division, a compare, a select: 3).  K5's
# recursion adds, a lattice and label, U (an add, a subtract, an expf, a
# multiply) and the posterior (the same four), and a label the lattice sum
# of g_state (an add): 17.
_FB_ROW_OPS = {"forward": 18.0, "backward": 18.0, "forward_dual": 39.0,
               "backward_dual": 39.0, "backward_dual_grad": 56.0}


def _k_fb(name, tensors, products):
    """K4, K5's recursion, K6a, K6b, K14: ``tensors`` (B, T, L) arrays
    moved, ``products`` (L) x (L, L) products a frame."""
    def count(B, T, L, frames=None, **_):
        frames = B * T if frames is None else frames
        dual = name != "forward" and name != "backward"
        small = _F32 * (L * L + L + 2 * B)
        extra = _F32 * B * T if dual else 0               # the labels
        return Phase(name, _F32 * tensors * B * T * L + extra + small,
                     frames * 2.0 * products * L * L,
                     frames * (_FB_ROW_OPS[name] * L + products * L * L))
    count.__doc__ = (f"{name}: {tensors} (B, T, L) tensors moved, "
                     f"{products} (L) x (L, L) products a frame.")
    return count


def _k_fb_contract(B, T, L, frames=None, **_):
    """K5's contraction ``UV = sum U_t^T V_t``: the rows of both lattices
    at the frames with a successor (``frames - B`` of them a lattice, the
    last frame of each row having none) read once, UV written; one product
    over those rows, held to the 3xTF32 rate."""
    frames = B * T if frames is None else frames
    rows = 2 * max(frames - B, 0)
    return Phase("backward_dual_contract", _F32 * (2 * rows * L + L * L),
                 0.0, 0.0, rows * 2.0 * L * L)


# Element operations of the segmental kernels, counted off csrc/segmental.cu.
# kernel: (operations per window term, per label of a frame's row, (L) x
# (L, L) products a frame).  A window term is one (duration, label) pair of
# the Dmax * L a frame holds.
_SCRF_PASSES = {
    # K9, seg_alpha_kernel (since PR 10).  The window is walked once, its
    # terms kept in registers: the term (a subtract, a multiply-add, an add:
    # 3) and a max, then a subtract, an expf and an add of the exp-sum: 7.
    # A label: the running sum (1), the group's max and sum merges (two
    # shuffles and two operations each: 8), the floor, logf and add of
    # alpha (3), its share of the redux row max (1), its product's
    # reduce-scatter (a partial-sum add, two shuffles and two adds: 5) and
    # the message m + tmax + log(max(dot, floor)) (4): 22.  Per (p, l): the
    # product's multiply-add, and the quarters' exponentials: a group a
    # destination (D = 1 up to L = 144) exponentiates the whole row it
    # reads, a subtract and an ex2 an entry: 3.
    "fwd": (7.0, 22.0, 3),
    # K10, seg_beta_kernel: K9 mirrored, the same inventory.
    # The term ((R[t + 1] - R[v + 1]) invd + bias) + beta[v] (a subtract, a
    # multiply-add, an add: 3) and a max, then the exp-sum's subtract, expf
    # and add: 7.  A label: the running suffix sum (1), the group's max and
    # sum merges (8), z's floor, logf and add (3), the redux row max (1),
    # the product's reduce-scatter (5) and beta = zm + tmax_r +
    # log(max(dot, floor)) (4): 22.  Per (p, l): the multiply-add and the
    # quarters' exponentials (2): 3.
    "bwd": (7.0, 22.0, 3),
    # K11's xi pass, seg_xi16_kernel / seg_xi_kernel (since PR 10), by
    # window term: the term (a subtract, a multiply-add and the add of beta
    # - logZ, staged once a frame: 3), exp(q + x) (an add, the log2(e)
    # multiply and an ex2: 3), y = invd xi (1), the gathers of A, S and gd
    # (3), F's exp(x + m) (3) and its add (1): 14; g multiplies each sum
    # once.  It walks no frame chain: its row work is the message pass's.
    "grad": (14.0, 0.0, 0),
    # K12, seg_delta_kernel, without a beam (scrf_decode's
    # default).  The window is walked once: four single IEEE operations for
    # the term, a compare and the two selects of the lane's first argmax:
    # 7.  A label: the running sum (1), the group's two argmax merges (two
    # shuffles, take_better's three compares and two selects: 7 each) and
    # the group max of the predecessor pass (two shuffles, two maxima): 19.
    # Per (p, l): the max-plus pass's add and max: 2.  A beam adds the redux
    # row max and the cut (2) and the owner's prune (2) a label, and a
    # compare and a select per (p, l) (each lane prunes its quarter on read).
    "vit": (7.0, 19.0, 2),
}
# K11's message pass, seg_message_kernel, a label of a frame: its share of
# the row max (1), E's subtract and exp (2), the running sum (1) and the
# message's floor, log and two adds (4): 8, beside one (L) x (L, L) product
# (each block's forming of the factor, L^2 exponentials for 64 frames, is
# left out).
_SCRF_MSG_OPS = 8.0
# K13, seg_traceback_kernel, works per SEGMENT of the best path, not per
# frame: one add and one compare per predecessor label (2 L), five shuffle
# rounds and the marker stores (12).
_SCRF_TB_OPS_PER_SEGMENT = (2.0, 12.0)      # (per label, per segment)


def _scrf_elems(name: str, frames: float, L: int, Dmax: int) -> float:
    """The kernel's element operations: the window terms, the row work and
    the (L, L) product's terms, for ``frames`` frames."""
    w, s, prod = _SCRF_PASSES[name]
    return frames * (w * Dmax * L + s * L + prod * L * L)


def _scrf_small(B, L, Dmax):
    # the transition factor, the (Dmax, L) bias, invd, lengths and logZ
    return _F32 * (L * L + Dmax * L + Dmax + 2 * B)


def _k_seg(name, kind, tensors, term_flops, products):
    """K9, K10, K12: ``tensors`` (B, T, L) arrays moved; per frame
    ``products`` (L) x (L, L) products and ``term_flops`` fp32 operations
    per window term (a subtract, a multiply, two adds, the max and the
    exp-sum: 6; K12 compares where K9 sums: 5)."""
    def count(B, T, L, Dmax, frames=None, **_):
        frames = B * T if frames is None else frames
        return Phase(name,
                     _F32 * tensors * B * T * L + _scrf_small(B, L, Dmax),
                     frames * (2.0 * products * L * L
                               + term_flops * Dmax * L),
                     _scrf_elems(kind, frames, L, Dmax))
    count.__doc__ = (f"{name}: {tensors} (B, T, L) tensors moved, "
                     f"{products} products and {term_flops} operations per "
                     "window term a frame.")
    return count


def _k_seg_message(B, T, L, frames=None, **_):
    """K11's message pass: alpha and the frame scores in; E (rows of L4),
    q, cs (B, T, L) and m (B, T) out; per frame one (L) x (L, L) product
    and ``_SCRF_MSG_OPS`` a label."""
    frames = B * T if frames is None else frames
    return Phase("segmental_grad_message",
                 _F32 * (B * T * (4 * L + _round_up4(L) + 1) + L * L + L
                         + B),
                 frames * (2.0 * L * L + _SCRF_MSG_OPS * L),
                 frames * (L * L + _SCRF_MSG_OPS * L))


def _k_seg_xi(B, T, L, Dmax, frames=None, **_):
    """K11's xi pass: q, cs, beta in and A, S out (B, T, L), m (B, T) in, F
    out (rows of L4), the bias, invd, logZ, g and gd; 14 operations a
    window term (the block partials of gd are not counted)."""
    frames = B * T if frames is None else frames
    w = _SCRF_PASSES["grad"][0]
    return Phase("segmental_grad",
                 _F32 * (B * T * (5 * L + _round_up4(L) + 1)
                         + 2 * Dmax * L + Dmax + 3 * B),
                 frames * w * Dmax * L, _scrf_elems("grad", frames, L, Dmax))


def _k_seg_contract(B, T, L, frames=None, **_):
    """K11's ``gt = sum_u E[u]^T F[u]``: the rows with a successor frame
    (``frames - B``: a row's last frame feeds no segment) read once from E
    and F, gt written; one product over them at the 3xTF32 rate."""
    frames = B * T if frames is None else frames
    rows = max(frames - B, 0)
    return Phase("segmental_grad_contract", _F32 * (2 * rows * L + L * L),
                 0.0, 0.0, rows * 2.0 * L * L)


# K11's parts, in launch order (their sum is the step model's scrf_grad)
SCRF_GRAD_PARTS = ("segmental_grad_message", "segmental_grad",
                   "segmental_grad_contract")


def _k_seg_traceback(B, T, L, segments=None, **_):
    """K13: per segment of the best paths one duration, one delta row and
    one transition column read; two (B, T) marker arrays written.
    ``segments`` is this batch's count (default: one a frame, the most a
    batch can hold)."""
    segments = B * T if segments is None else segments
    per_label, per_seg = _SCRF_TB_OPS_PER_SEGMENT
    return Phase("segmental_viterbi_traceback",
                 _F32 * (segments * (1 + L) + L * L + 2 * B + 2 * B * T),
                 segments * 2.0 * L,
                 segments * (per_label * L + per_seg))


# name (the wrappers' launch counters, kernels.<name>[...]) -> its count
KERNELS = {
    "fdt_viterbi_plane": _k_fdt_plane("fdt_viterbi_plane"),
    "fdt_viterbi_fwd": _k_fdt_viterbi_fwd,
    "fdt_viterbi_traceback": _k_traceback,
    "fdt_train_fwd": _k_fdt_train_fwd,
    "fdt_train_plane": _k_fdt_plane("fdt_train_plane"),
    "fdt_train_bwd": _k_fdt_train_bwd,
    "fdt_train_contract": _k_fdt_train_contract,
    "viterbi_dense_fwd": _k_viterbi_dense_fwd,
    "viterbi_nstate_fwd": _k_viterbi_nstate_fwd,
    "viterbi_traceback": _k_traceback,
    "forward": _k_fb("forward", 2, 1),
    "backward": _k_fb("backward", 2, 1),
    "forward_dual": _k_fb("forward_dual", 3, 2),
    "backward_dual": _k_fb("backward_dual", 3, 2),
    # K5's recursion: state, af, ac in; g_state and the (B, T, 2, L) rows U
    # and V out
    "backward_dual_grad": _k_fb("backward_dual_grad", 8, 2),
    "backward_dual_contract": _k_fb_contract,
    "segmental_forward": _k_seg("segmental_forward", "fwd", 2, 6, 1),
    "segmental_backward": _k_seg("segmental_backward", "bwd", 2, 6, 1),
    "segmental_grad_message": _k_seg_message,
    "segmental_grad": _k_seg_xi,
    "segmental_grad_contract": _k_seg_contract,
    "segmental_viterbi": _k_seg("segmental_viterbi", "vit", 3, 5, 1),
    "segmental_viterbi_traceback": _k_seg_traceback,
}


def kernel_phase(name: str, **shape) -> Phase:
    """One kernel's bytes (each input read once, each output written once),
    fp32 operations and element operations at ``shape`` (``B``, ``T``,
    ``L`` and what the family needs of ``D``, ``ns``, ``Du``, ``Dmax``;
    ``frames``: the frames that exist, default ``B * T``; ``segments``:
    K13's walk).  ``name`` names a launch counter, ``kernels.<name>``."""
    return KERNELS[name](**shape)


def calibrate_phase(Dmax: int, Ls: int, Bk: int, passes: int, frames: int,
                    grid_n: int, spec: ChipSpec = H100):
    """K15's work and ``(bound_ms, bound_by)`` for one launch: ``steps =
    grid_n * frames`` steps of ``passes`` dependent operations on each of
    ``Dmax * Ls * Bk`` elements; every eighth is ``expf(z * -0.5)`` (a
    multiply and one special-function result), the rest one multiply-add.
    It moves next to nothing (one (Ls, Bk) plane in, the window out), so
    operations bind: the multiply-adds over the fp32 rate plus the
    exponentials over the special-function rate (``sm_count *
    sfu_per_sm_clk * sm_clock_ghz``)."""
    elems = float(Dmax) * Ls * Bk
    n_exp = sum(1 for p in range(passes) if p % 8 == 7)
    steps = float(grid_n) * frames
    fma, exps = steps * (passes - n_exp) * elems, steps * n_exp * elems
    phase = Phase("calibrate", _F32 * (Ls * Bk + elems),
                  2.0 * fma + exps, steps * passes * elems)
    sfu = spec.sm_count * spec.sfu_per_sm_clk * spec.sm_clock_ghz * 1e9
    by_ops = ((2.0 * fma + exps) / (spec.fp32_tflops * 1e12)
              + exps / sfu) * 1e3
    by_bytes = phase.bytes / (spec.hbm_gbps * 1e9) * 1e3
    return phase, ((by_bytes, "bytes") if by_bytes >= by_ops
                   else (by_ops, "operations"))


def _renamed(phase: Phase, name: str, more_bytes: float = 0.0) -> Phase:
    return dataclasses.replace(phase, name=name,
                               bytes=phase.bytes + more_bytes)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def train_step_phases(B: int, T: int, L: int, D: int,
                      n_lambda: int | None = None) -> list[Phase]:
    """One shared-transition train step (configs 1, 3, 5: loss, gradient,
    update): the potentials (``models/crf.potentials``: one fp32 matmul and
    the boundary pass), K4, K5 (its recursion, which writes the rows of the
    transition gradient, and their contraction), the feature map's backward
    matmul, the optimizer."""
    tbl = T * B * L * _F32
    btd = B * T * D * _F32
    n_lambda = n_lambda or (D * L + L * L + 2 * L)
    return [
        # feats @ W + b written once; apply_boundaries reads and writes it
        Phase("featuremap", btd + D * L * _F32 + 3 * tbl,
              2.0 * B * T * D * L),
        _renamed(kernel_phase("forward_dual", B=B, T=T, L=L),
                 "dual_forward"),
        # K5: the recursion writes the rows U, V; the contraction reads them
        _summed("dual_backward_grad",
                [kernel_phase(n, B=B, T=T, L=L)
                 for n in ("backward_dual_grad", "backward_dual_contract")]),
        # dW = feats^T @ g_state (the boundary pass's backward reads and
        # writes g_state once more)
        Phase("featuremap_bwd", btd + 3 * tbl + D * L * _F32,
              2.0 * B * T * D * L),
        # grad norm (read g), SGD (read p and g, write p)
        Phase("optimizer", 4 * n_lambda * _F32, 4.0 * n_lambda),
    ]


def _summed(name: str, phases: list[Phase]) -> Phase:
    """One phase holding the bytes and operations of several kernels."""
    return Phase(name, sum(p.bytes for p in phases),
                 sum(p.flops for p in phases),
                 sum(p.vpu_elems for p in phases),
                 sum(p.mma_flops for p in phases))


def fdt_train_phases(B: int, T: int, L: int, D: int, ns: int,
                     n_lambda: int | None = None) -> list[Phase]:
    """One frame-dependent-transition train step (config 2): packing
    (``build_wall``, the padded copy of Wall the plane kernel reads, the
    scatter of dWall back to the parameters), the forward (the planes of
    every frame, formed once a step, and K1's recursion, which reads them),
    K2 (the recursion, which reads the same planes and writes dplane, then
    the contraction, which reads it back), the optimizer.  The products of
    plane formation and of the contraction bind the step's bound, at the
    3xTF32 rate."""
    P, Lp, R, Dw = _fdt_dims(L, D, ns, None)
    wall = R * Dw * _F32
    n_lambda = n_lambda or R * Dw
    shape = dict(B=B, T=T, L=L, D=D, ns=ns)
    return [
        # gather into Wall, its one copy (wall_k4), dWall scattered back
        # through autograd
        Phase("fdt_prep", 2 * (n_lambda * _F32 + wall) + 2 * wall, 0.0),
        _summed("fdt_forward", [kernel_phase(name, **shape) for name in
                                ("fdt_train_plane", "fdt_train_fwd")]),
        _summed("fdt_backward_grad", [kernel_phase(name, **shape) for name in
                                      ("fdt_train_bwd",
                                       "fdt_train_contract")]),
        Phase("optimizer", 4 * n_lambda * _F32, 4.0 * n_lambda),
    ]


def fdt_decode_phases(B: int, T: int, L: int, D: int,
                      ns: int) -> list[Phase]:
    """The config-2 decode (``models/crf.decode``): packing (``build_wall``
    and the padded copy of Wall the plane kernel reads), the forward (the
    planes of every frame on the tensor cores, then K3's recursion, int32
    backpointers) and the traceback.  The chain of dependent frames is NOT
    in this model: ``bench``'s measured decode floor (the T-sweep) is the
    companion latency bound."""
    P, Lp, R, Dw = _fdt_dims(L, D, ns, None)
    wall = R * Dw * _F32
    shape = dict(B=B, T=T, L=L, D=D, ns=ns)
    return [
        Phase("fdt_prep", 2 * wall + 2 * wall, 0.0),
        _summed("fdt_viterbi_forward", [kernel_phase(name, **shape) for name
                                        in ("fdt_viterbi_plane",
                                            "fdt_viterbi_fwd")]),
        _renamed(kernel_phase("fdt_viterbi_traceback", B=B, T=T),
                 "fdt_traceback"),
    ]


def fdt_tile_floor(B: int, T: int, L: int, D: int, ns: int,
                   mode: str = "fp32", vpu_geps: float | None = None,
                   spec: ChipSpec = H100) -> dict:
    """A defended floor for the config-2 train step.  The JAX function
    counts the 128-wide passes of the TPU's matrix unit (``mxu_passes``,
    ``mxu_ms``); nothing is padded here.  Its place is taken by
    ``fma_ms``: the products of plane formation (``Wall @ [x; 1]`` once a
    frame, once a step: the forward forms the planes and K2 reads them
    again) and of the ``dWall`` contraction, exact from the shapes, at the
    rate of ``mode`` (:func:`_peak_flops`: 3xTF32 at ``fp32``), and the
    multiply-adds of the two
    recursions' DP at the fp32 rate.  ``vpu_ms`` is, as there, the element
    operations of the two recursions (K1's, K2's) over the measured
    in-kernel rate (K15), serial with the products.  A step within
    ~1.2x of ``floor_ms`` is at the practical speed of light for this
    shape."""
    phases = [p for p in fdt_train_phases(B, T, L, D, ns)
              if p.name in ("fdt_forward", "fdt_backward_grad")]
    fma_s = (sum(p.flops for p in phases) / (spec.fp32_tflops * 1e12)
             + sum(p.mma_flops for p in phases) / _peak_flops(spec, mode))
    vpu_el = sum(p.vpu_elems for p in phases)
    vpu_s = vpu_el / ((vpu_geps or 3000.0) * 1e9)
    return {"fma_ms": round(fma_s * 1e3, 3),
            "vpu_ms": round(vpu_s * 1e3, 3),
            "floor_ms": round((fma_s + vpu_s) * 1e3, 3)}


def scrf_train_phases(B: int, T: int, L: int, D: int,
                      Dmax: int) -> list[Phase]:
    """One streaming SCRF train step (config 4): the frame scores, K9, K10,
    K11 (its three parts), the gold numerator and the gradient assembly.  Element operations are the kernel-body
    inventories (``_SCRF_PASSES``).  The chain of dependent frames is NOT
    modeled: ``bench``'s measured decode floor is the latency companion."""
    btd = B * T * D * _F32
    tbl = T * B * L * _F32
    shape = dict(B=B, T=T, L=L, Dmax=Dmax)
    return [
        # frame scores: one fp32 einsum, feats in, (B, T, L) out
        Phase("scrf_prep", btd + D * L * _F32 + tbl, 2.0 * B * T * D * L),
        _renamed(kernel_phase("segmental_forward", **shape), "scrf_forward"),
        _renamed(kernel_phase("segmental_backward", **shape),
                 "scrf_backward"),
        # K11: its message pass, its xi pass and the E^T F contraction
        _summed("scrf_grad", [kernel_phase(n, **shape)
                              for n in SCRF_GRAD_PARTS]),
        # scatter-free gold numerator, value and gradient: run analysis, a
        # gather and two one-hot count einsums
        Phase("scrf_numerator", 4 * tbl,
              2.0 * 2 * B * T * L * (L + Dmax), 12.0 * B * T * L),
        # kernels.segmental.frame_grad (a copy, a subtract, a transposed
        # copy, a flipped cumulative sum: 13 passes) and the frame scores'
        # backward dW = feats^T @ dframe
        Phase("scrf_grad_finish", 13 * tbl + btd + D * L * _F32,
              2.0 * B * T * D * L, 8.0 * B * T * L),
    ]


def scrf_decode_phases(B: int, T: int, L: int, D: int, Dmax: int,
                       segments: int | None = None) -> list[Phase]:
    """The streaming segmental Viterbi (``scrf_decode``): the frame scores,
    K12 and K13.  ``segments``: the segments on this batch's best paths
    (K13 works per segment; default one a frame)."""
    btd = B * T * D * _F32
    tbl = T * B * L * _F32
    return [
        Phase("scrf_prep", btd + D * L * _F32 + tbl, 2.0 * B * T * D * L),
        _renamed(kernel_phase("segmental_viterbi", B=B, T=T, L=L,
                              Dmax=Dmax), "scrf_viterbi_forward"),
        # the marker packing after it: a cumulative sum and two scatters
        # over the (B, T) markers
        _renamed(kernel_phase("segmental_viterbi_traceback", B=B, T=T, L=L,
                              segments=segments), "scrf_traceback",
                 6.0 * B * T * _F32),
    ]


def scrf_tile_floor(B: int, T: int, L: int, Dmax: int,
                    vpu_geps: float | None = None,
                    spec: ChipSpec = H100,
                    segments: int | None = None) -> dict:
    """A defended floor for the segmental kernels: the per-frame inventory
    of element operations of each kernel body (``_SCRF_PASSES``: every one
    an operation the recursion's data dependencies require in this design),
    the (L, L) products' terms among them, held to the MEASURED in-kernel
    elementwise rate (K15 runs the same regime: a window in shared memory,
    one block per batch column, a barrier a step).  The JAX function adds
    its matrix-unit passes at their own rate; here the products run on the
    same CUDA cores as everything else, so they are element operations
    like the rest.  K11 walks no frame chain (since PR 10): its floor
    (``grad``) is the bound of its three parts, which the measured rate
    does not move.  A step within ~1.2x of this floor is at the practical
    speed of light for this design; what remains is to change the
    inventory itself, or the number of blocks a frame keeps busy."""
    geps = (vpu_geps or 3000.0) * 1e9
    frames = float(B) * T
    parts = {name: _scrf_elems(name, frames, L, Dmax) / geps
             for name in ("fwd", "bwd", "vit")}
    parts["grad"] = sum(bound(kernel_phase(n, B=B, T=T, L=L, Dmax=Dmax))[0]
                        for n in SCRF_GRAD_PARTS) * 1e-3
    parts["tb"] = kernel_phase("segmental_viterbi_traceback", B=B, T=T, L=L,
                               segments=segments).vpu_elems / geps
    train = parts["fwd"] + parts["bwd"] + parts["grad"]
    return {"train_floor_ms": round(train * 1e3, 3),
            "decode_floor_ms": round((parts["vit"] + parts["tb"]) * 1e3, 3),
            "kernels_ms": {k: round(v * 1e3, 3) for k, v in parts.items()},
            "vpu_geps_used": round((vpu_geps or 3000.0), 1)}


def decode_phases(B: int, T: int, L: int, D: int,
                  num_states: int = 1) -> list[Phase]:
    """One exact shared-transition Viterbi decode: the potentials, K8 (n
    states) or K7 (one), the traceback kernel."""
    tbl = T * B * L * _F32
    btd = B * T * D * _F32
    ns = max(num_states, 1)
    fwd = (kernel_phase("viterbi_nstate_fwd", B=B, T=T, L=L, ns=ns)
           if ns > 1 else kernel_phase("viterbi_dense_fwd", B=B, T=T, L=L))
    return [
        Phase("featuremap", btd + D * L * _F32 + 3 * tbl,
              2.0 * B * T * D * L),
        _renamed(fwd, "viterbi_forward"),
        kernel_phase("viterbi_traceback", B=B, T=T),
    ]


def summarize(phases: list[Phase], measured_s: float,
              spec: ChipSpec = H100,
              measured_bw_gbps: float | None = None,
              mode: str = "fp32",
              vpu_geps: float | None = None) -> dict:
    """Roll phases up into the bench's roofline record.  ``mode`` selects
    the peak the FLOPs are held to (``"fp32"`` alone here); ``vpu_geps``
    (measured, :func:`measure_vpu_geps_pallas`) activates the element
    term."""
    total_bytes = sum(p.bytes for p in phases)
    total_flops = sum(p.flops + p.mma_flops for p in phases)
    sol = sum(p.sol_s(spec, mode=mode, vpu_geps=vpu_geps) for p in phases)
    out = {
        "chip": spec.name,
        "hbm_gbps_peak": spec.hbm_gbps,
        "gbytes_streamed": round(total_bytes / 1e9, 4),
        "gflops": round(total_flops / 1e9, 2),
        "sol_ms": round(sol * 1e3, 3),
        "measured_ms": round(measured_s * 1e3, 3),
        "pct_of_sol": round(100.0 * sol / measured_s, 1),
        "achieved_gbps": round(total_bytes / measured_s / 1e9, 1),
        "phases": {p.name: {"mb": round(p.bytes / 1e6, 1),
                            "gflop": round((p.flops + p.mma_flops)
                                           / 1e9, 2),
                            "vpu_gelems": round(p.vpu_elems / 1e9, 2),
                            "sol_ms": round(
                                p.sol_s(spec, mode=mode,
                                        vpu_geps=vpu_geps) * 1e3, 3)}
                   for p in phases},
    }
    if vpu_geps:
        out["vpu_geps_measured"] = round(vpu_geps, 1)
    if measured_bw_gbps:
        sol_ach = sum(p.sol_s(spec, bw_gbps=measured_bw_gbps, mode=mode,
                              vpu_geps=vpu_geps)
                      for p in phases)
        out["hbm_gbps_achievable"] = round(measured_bw_gbps, 1)
        out["pct_of_achievable_sol"] = round(100.0 * sol_ach / measured_s, 1)
    return out


# ---------------------------------------------------------------------------
# measurements
# ---------------------------------------------------------------------------

def measure_vpu_geps_pallas(Dmax: int = 16, Ls: int = 48, Bk: int = 128,
                            passes: int = 16, frames: int = 32,
                            grid_n: int = 256, reps: int = 5,
                            device="cuda") -> float:
    """In-kernel elementwise throughput in giga-element-operations a
    second, measured by K15: ``grid_n * frames`` steps of ``passes``
    dependent operations (one expf in eight, like the recursions' bodies)
    over a ``(Dmax, Ls)`` window in each of ``Bk`` blocks' shared memory.
    The denominator of :func:`scrf_tile_floor` and :func:`fdt_tile_floor`.
    The median over ``reps`` slope measurements
    (``kernels.calibrate.measure``, whose whole record ``bench`` prints).
    Unlike the JAX function it never returns None: on a CUDA device the
    kernel runs or the call raises; on the CPU the plain version is timed
    at a short chain, a host figure and never a device one."""
    from asr_craft_tpu_torch.kernels import calibrate
    return calibrate.measure(Dmax=Dmax, Ls=Ls, Bk=Bk, passes=passes,
                             frames=frames, grid_n=grid_n, reps=reps,
                             device=device)["geps"]


def measure_stream_bw(n_mb: int = 256, iters: int = 48,
                      spec: ChipSpec = H100, device="cuda") -> float:
    """Empirical streaming bandwidth (GB/s) of ``device``: an out-of-place
    add of a scalar over ``n_mb`` MB (reads N and writes N bytes a call, far
    beyond the L2 cache), ``iters`` calls between two CUDA events, the
    better of two runs, clamped to ``spec.hbm_gbps``.  On the CPU the same
    loop on the host's clock: a host figure."""
    import time

    import torch
    device = torch.device(device)
    n = n_mb * 1024 * 1024 // _F32
    x = torch.ones((n,), dtype=torch.float32, device=device)
    y = torch.empty_like(x)

    def run():
        for _ in range(iters):
            torch.add(x, 1e-9, out=y)

    def timed():
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0

    timed()                                        # warm
    dt = min(timed(), timed())
    bw = 2.0 * n * _F32 * iters / dt / 1e9
    return min(bw, spec.hbm_gbps)
