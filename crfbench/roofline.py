"""The benchmark's yardstick: each kernel's bytes and operations, and the
published peaks of one NVIDIA H100, frozen here so that a change to the
program cannot move what it is judged by.

A copy of the counts of ``asr_craft_tpu_torch/utils/roofline.py`` (the
kernel table ``KERNELS``, ``_peak_flops``, the step models), with every
count taking ``frames=``, the frames that exist (real, unpadded), and
nothing measured: the denominators are NVIDIA's data-sheet peaks (SXM part,
dense, at the 700 W limit), never a rate measured on the card.

Bytes: each input read once, each output written once.  Operations come in
two kinds: the products with no dependence between frames (``mma_flops``:
the planes, the gradient contractions), held to the rate of the
configuration's precision, and the rest (``flops``), held to the CUDA
cores' fp32 rate.
"""
from __future__ import annotations

import dataclasses

F32 = 4

HBM_BYTES_PER_S = 3350e9          # 80 GB HBM3 at 3.35 TB/s
FP32_FLOPS = 67e12                # CUDA cores, fp32
TF32_FLOPS = 495e12               # tensor cores, dense TF32
BF16_FLOPS = 989e12               # tensor cores, dense bf16


def product_peak(precision: str) -> float:
    """FLOP/s of the products at ``precision``: ``highest`` is 3xTF32 (three
    TF32 products for one), ``bf16x3`` three bf16 products for one,
    ``default`` one TF32 pass."""
    if precision == "highest":
        return TF32_FLOPS / 3
    if precision == "bf16x3":
        return BF16_FLOPS / 3
    if precision == "default":
        return TF32_FLOPS
    raise ValueError(f"precision {precision!r}")


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    bytes: float
    flops: float
    mma_flops: float = 0.0

    def op_seconds(self, precision: str) -> float:
        """The least time the operations take: the products at the
        precision's rate and the rest at the fp32 rate, whichever is
        longer (they run on different units)."""
        return max(self.flops / FP32_FLOPS,
                   self.mma_flops / product_peak(precision))

    def sol_seconds(self, precision: str) -> float:
        """The least time the card could take: the larger of the bytes over
        the memory rate and :meth:`op_seconds`."""
        return max(self.bytes / HBM_BYTES_PER_S, self.op_seconds(precision))


def summed(name: str, phases) -> Phase:
    phases = list(phases)
    return Phase(name, sum(p.bytes for p in phases),
                 sum(p.flops for p in phases),
                 sum(p.mma_flops for p in phases))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _fdt_dims(L, D, ns):
    """(P, L', R, Dw) of the packed parameter matrix: rows [state L' | self
    L' | adv L' | cross P * P], columns the D transition dims and the
    bias."""
    P = L // ns
    return P, L, 3 * L + P * P, D + 1


def _round_up4(n):
    return (n + 3) // 4 * 4


def _plane_ops(frames, R, Dw):
    """(mma_flops, flops) of ``Wall @ [x; 1]`` a frame, or of the
    ``dWall = dplane^T @ [x; 1]`` contraction."""
    return frames * 2.0 * R * (Dw - 1), frames * float(R)


def _fdt_plane(name):
    def count(B, T, L, D, ns, frames=None, **_):
        P, Lp, R, Dw = _fdt_dims(L, D, ns)
        frames = B * T if frames is None else frames
        mma, bias = _plane_ops(frames, R, Dw)
        return Phase(name, F32 * (R * Dw + B * T * D + B * T * R), bias, mma)
    return count


def _fdt_viterbi_fwd(B, T, L, D, ns, frames=None, **_):
    P, Lp, R, Dw = _fdt_dims(L, D, ns)
    frames = B * T if frames is None else frames
    return Phase("fdt_viterbi_fwd",
                 F32 * (frames * _round_up4(R) + B * T * Lp + 3 * B),
                 frames * 2.0 * (2 * Lp + P * P))


def _traceback(B, T, **_):
    return Phase("fdt_viterbi_traceback", F32 * (2 * B * T + 2 * B),
                 float(B * T))


def _fdt_train_fwd(B, T, L, D, ns, frames=None, **_):
    P, Lp, R, Dw = _fdt_dims(L, D, ns)
    frames = B * T if frames is None else frames
    dp = 2 * (2 * Lp + P * P)
    return Phase("fdt_train_fwd",
                 F32 * (frames * _round_up4(R) + B * T + 2 * B * T * Lp
                        + 3 * B), frames * 2 * dp)


def _fdt_train_bwd(B, T, L, D, ns, frames=None, **_):
    P, Lp, R, Dw = _fdt_dims(L, D, ns)
    frames = B * T if frames is None else frames
    dp = 2 * (2 * Lp + P * P)
    return Phase("fdt_train_bwd",
                 F32 * (2 * B * T * R + B * T + 2 * B * T * Lp + 5 * B),
                 frames * 6 * dp)


def _fdt_train_contract(B, T, L, D, ns, frames=None, **_):
    P, Lp, R, Dw = _fdt_dims(L, D, ns)
    frames = B * T if frames is None else frames
    mma, colsum = _plane_ops(frames, R, Dw)
    return Phase("fdt_train_contract",
                 F32 * (B * T * R + B * T * D + R * Dw), colsum, mma)


def _seg_small(B, L, Dmax):
    return F32 * (L * L + Dmax * L + Dmax + 2 * B)


def _seg_viterbi(B, T, L, Dmax, frames=None, **_):
    """K12: 3 (B, T, L) arrays moved; a frame's (L) x (L, L) max-plus
    product and 5 operations a window term."""
    frames = B * T if frames is None else frames
    return Phase("segmental_viterbi",
                 F32 * 3 * B * T * L + _seg_small(B, L, Dmax),
                 frames * (2.0 * L * L + 5 * Dmax * L))


def _seg_traceback(B, T, L, segments=None, **_):
    """K13: per segment of the best paths one duration, one delta row and
    one transition column read; two (B, T) marker arrays written."""
    segments = B * T if segments is None else segments
    return Phase("segmental_viterbi_traceback",
                 F32 * (segments * (1 + L) + L * L + 2 * B + 2 * B * T),
                 segments * 2.0 * L)


KERNELS = {
    "fdt_viterbi_plane": _fdt_plane("fdt_viterbi_plane"),
    "fdt_viterbi_fwd": _fdt_viterbi_fwd,
    "fdt_viterbi_traceback": _traceback,
    "fdt_train_plane": _fdt_plane("fdt_train_plane"),
    "fdt_train_fwd": _fdt_train_fwd,
    "fdt_train_bwd": _fdt_train_bwd,
    "fdt_train_contract": _fdt_train_contract,
    "segmental_viterbi": _seg_viterbi,
    "segmental_viterbi_traceback": _seg_traceback,
}


def kernel_phase(name: str, **shape) -> Phase:
    """One kernel's bytes and operations at ``shape`` (``B``, ``T``, ``L``
    and what it needs of ``D``, ``ns``, ``Dmax``, ``frames``,
    ``segments``)."""
    return KERNELS[name](**shape)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def fdt_train_phases(B, T, L, D, ns, frames=None):
    """One frame-dependent-transition train step (config 2): packing, the
    planes and K1, K2 and its contraction, the optimizer."""
    P, Lp, R, Dw = _fdt_dims(L, D, ns)
    wall = R * Dw * F32
    n_lambda = R * Dw
    shape = dict(B=B, T=T, L=L, D=D, ns=ns, frames=frames)
    return [
        Phase("fdt_prep", 2 * (n_lambda * F32 + wall) + 2 * wall, 0.0),
        summed("fdt_forward", [kernel_phase(n, **shape) for n in
                               ("fdt_train_plane", "fdt_train_fwd")]),
        summed("fdt_backward_grad", [kernel_phase(n, **shape) for n in
                                     ("fdt_train_bwd", "fdt_train_contract")]),
        Phase("optimizer", 4 * n_lambda * F32, 4.0 * n_lambda),
    ]


def fdt_decode_phases(B, T, L, D, ns, frames=None):
    """The config-2 decode: packing, the planes and K3's forward, the
    traceback."""
    P, Lp, R, Dw = _fdt_dims(L, D, ns)
    wall = R * Dw * F32
    shape = dict(B=B, T=T, L=L, D=D, ns=ns, frames=frames)
    return [
        Phase("fdt_prep", 4 * wall, 0.0),
        summed("fdt_viterbi_forward", [kernel_phase(n, **shape) for n in
                                       ("fdt_viterbi_plane",
                                        "fdt_viterbi_fwd")]),
        kernel_phase("fdt_viterbi_traceback", B=B, T=T),
    ]


def scrf_decode_phases(B, T, L, D, Dmax, frames=None, segments=None):
    """The streaming segmental Viterbi: the frame scores (for every padded
    frame), K12, K13 and the marker packing."""
    btd = B * T * D * F32
    tbl = T * B * L * F32
    k13 = kernel_phase("segmental_viterbi_traceback", B=B, T=T, L=L,
                       segments=segments)
    return [
        Phase("scrf_prep", btd + D * L * F32 + tbl, 2.0 * B * T * D * L),
        kernel_phase("segmental_viterbi", B=B, T=T, L=L, Dmax=Dmax,
                     frames=frames),
        dataclasses.replace(k13, bytes=k13.bytes + 6.0 * B * T * F32),
    ]
