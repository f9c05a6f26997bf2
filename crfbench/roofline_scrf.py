"""The yardstick of the segmental CRF's training step, frozen here beside
``roofline.py`` (whose peaks, ``Phase`` and conventions it takes): the
bytes and operations of K9, K10 and K11's three parts, a copy of
``asr_craft_tpu_torch/utils/roofline.py``'s ``segmental_forward``,
``segmental_backward``, ``segmental_grad_message``, ``segmental_grad`` and
``segmental_grad_contract`` (without its element-operation term, which is
held to a measured rate), every count taking ``frames=``, the real frames;
and a model of the whole step for the share of the chip's peak.

The readers of ``metrics/sol_pct.seg_train.py`` and
``metrics/mfu_pct.seg_train.py`` are here too: ``readers.sol_pct`` counts
with ``roofline.py``'s table, and ``readers.step_phases`` gives a
segmental cell the decode's model.
"""
from __future__ import annotations

from crfbench import readers
from crfbench.roofline import F32, Phase, _round_up4, _seg_small


def _seg_recursion(name, tensors, term_flops, products):
    """K9, K10: ``tensors`` (B, T, L) arrays moved; per frame ``products``
    (L) x (L, L) products and ``term_flops`` fp32 operations per window
    term (a subtract, a multiply, two adds, the max and the exp-sum: 6)."""
    def count(B, T, L, Dmax, frames=None, **_):
        frames = B * T if frames is None else frames
        return Phase(name,
                     F32 * tensors * B * T * L + _seg_small(B, L, Dmax),
                     frames * (2.0 * products * L * L
                               + term_flops * Dmax * L))
    return count


def _seg_message(B, T, L, frames=None, **_):
    """K11's message pass: alpha and the frame scores in; E (rows of L4),
    q, cs (B, T, L) and m (B, T) out; per frame one (L) x (L, L) product
    and 8 operations a label."""
    frames = B * T if frames is None else frames
    return Phase("segmental_grad_message",
                 F32 * (B * T * (4 * L + _round_up4(L) + 1) + L * L + L
                        + B),
                 frames * (2.0 * L * L + 8.0 * L))


def _seg_xi(B, T, L, Dmax, frames=None, **_):
    """K11's xi pass: q, cs, beta in and A, S out (B, T, L), m (B, T) in, F
    out (rows of L4), the bias, invd, logZ, g and gd; 14 operations a
    window term."""
    frames = B * T if frames is None else frames
    return Phase("segmental_grad",
                 F32 * (B * T * (5 * L + _round_up4(L) + 1)
                        + 2 * Dmax * L + Dmax + 3 * B),
                 frames * 14.0 * Dmax * L)


def _seg_contract(B, T, L, frames=None, **_):
    """K11's ``gt = sum_u E[u]^T F[u]``: the rows with a successor frame
    (``frames - B``) read once from E and F, gt written; one product over
    them, held to the precision's rate."""
    frames = B * T if frames is None else frames
    rows = max(frames - B, 0)
    return Phase("segmental_grad_contract", F32 * (2 * rows * L + L * L),
                 0.0, rows * 2.0 * L * L)


KERNELS = {
    "segmental_forward": _seg_recursion("segmental_forward", 2, 6, 1),
    "segmental_backward": _seg_recursion("segmental_backward", 2, 6, 1),
    "segmental_grad_message": _seg_message,
    "segmental_grad": _seg_xi,
    "segmental_grad_contract": _seg_contract,
}


def kernel_phase(name: str, **shape) -> Phase:
    """One kernel's bytes and operations at ``shape`` (``B``, ``T``, ``L``,
    ``Dmax``, ``frames``)."""
    return KERNELS[name](**shape)


def train_phases(B, T, L, D, Dmax, frames=None) -> list:
    """One step of the segmental CRF's training: the frame scores' product
    (``x @ w_frame``, held to the precision's rate), K9, K10, K11, the gold
    numerator, the frame gradient's assembly (``A[t] - S[t + 1]`` and its
    reverse running sum), the frame scores' backward (``x^T @ dframe``),
    the bias and transition gradients, and SGD with the gradient's norm.
    The numerator counts what the gold segmentation needs (a pick and a
    scale a frame, a bias and a transition a segment: at most 4 operations
    a frame, and as many for its gradient), not the one-hot products that
    compute it."""
    frames = B * T if frames is None else frames
    btd, tbl = F32 * B * T * D, F32 * B * T * L
    n = D * L + L * L + Dmax * L + L
    shape = dict(B=B, T=T, L=L, Dmax=Dmax, frames=frames)
    return [
        Phase("scrf_frame_scores", btd + F32 * D * L + tbl, 0.0,
              2.0 * frames * D * L),
        *(kernel_phase(k, **shape) for k in KERNELS),
        Phase("scrf_numerator", btd + tbl, 8.0 * frames),
        Phase("scrf_frame_grad", 4 * tbl, 2.0 * frames * L),
        Phase("scrf_frame_scores_bwd", btd + tbl + F32 * D * L, 0.0,
              2.0 * frames * D * L),
        Phase("scrf_bias_trans_grad", F32 * (2 * Dmax * L + 3 * L * L),
              Dmax * L + 2.0 * L * L),
        Phase("sgd", F32 * 4 * n, 4.0 * n),
    ]


def _shapes(ctx):
    """``(B, T, frames)`` of each traced step."""
    cell = ctx["cell"]
    return [(B, T, f) for call in ctx["trace"]["calls"]
            for B, T, f, _ in readers.steps(cell, call)]


def sol_pct(ctx, kind: str, groups: dict) -> float | None:
    """As ``readers.sol_pct``, with this module's counts: 100 x the
    group's least time for the traced steps over its traced device time;
    ``groups`` maps kernel names to the count that stands for them (each
    count taken once)."""
    cell, tr = ctx["cell"], ctx["trace"]
    prec = cell.precision(kind)
    m = cell.config["model"]
    dev = sum(t - s for n, s, t in readers._device(tr) if n in groups)
    if not tr["calls"] or dev <= 0:
        return None
    least = sum(kernel_phase(c, B=B, T=T, L=m["num_labels"],
                             Dmax=m["max_dur"], frames=f).sol_seconds(prec)
                for B, T, f in _shapes(ctx) for c in set(groups.values()))
    return 100.0 * least / dev


def mfu_pct(ctx, kind: str) -> float | None:
    """As ``readers.mfu_pct``, with :func:`train_phases`: 100 x the least
    time the traced steps' counted operations take at the published peaks
    (products at the precision's rate, the rest at fp32's) over the
    stretch."""
    cell, tr = ctx["cell"], ctx["trace"]
    prec = cell.precision(kind)
    m = cell.config["model"]
    if not tr["calls"] or tr["span_s"] <= 0:
        return None
    least = sum(p.op_seconds(prec)
                for B, T, f in _shapes(ctx)
                for p in train_phases(B, T, m["num_labels"], m["feat_dim"],
                                      m["max_dur"], f))
    return 100.0 * least / tr["span_s"]
