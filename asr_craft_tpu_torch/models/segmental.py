"""Segmental CRF (SCRF) model: segment potentials, loss, decode.

Counterpart of :mod:`asr_craft_tpu.models.segmental`, same public names:
variable-duration segments scored from pooled frame features plus duration
and label-bias features, with segment-level label transitions.  Two tiers:

- **Oracle path** (``scrf_loss`` / ``seg_potentials`` /
  ``scrf_decode_dense``): materializes the ``(B, T, Dmax, L)`` potential
  tensor; autograd differentiates it.  For tests and small shapes only.
- **Production path** (``scrf_loss_fused`` / ``scrf_log_partition_fused`` /
  ``scrf_decode``): O(B T L) memory.  Segment potentials are rebuilt from
  cumulative frame scores inside rolling windows
  (:mod:`asr_craft_tpu_torch.ops.segmental_stream`: the K9-K13 kernels for
  CUDA tensors), with the classical segmental forward-backward gradient.

The frame-score product is ``torch.einsum`` in IEEE fp32 (the caller keeps
TF32 off, as for ``models.crf.potentials``), outside every kernel as in the
reference.  The training numerator is the gold segmentation's score, derived
from frame labels by run-length analysis on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels.segmental import segment_bias
from asr_craft_tpu_torch.ops import segmental as seg_ops
from asr_craft_tpu_torch.ops.segmental_stream import (
    nstate_cuts, seg_log_partition_stream, seg_log_partition_stream_ns,
    seg_viterbi_stream)
from asr_craft_tpu_torch.ops.semiring import NEG_INF

__all__ = ["SegCrfConfig", "nstate_cuts", "seg_potentials",
           "gold_segment_score", "gold_segment_score_stream",
           "gold_segment_score_stream_ns", "gold_segment_score_batch",
           "scrf_loss", "scrf_loss_fused", "scrf_log_partition_fused",
           "scrf_decode", "scrf_decode_dense", "scrf_frame_labels"]


@dataclasses.dataclass(frozen=True)
class SegCrfConfig:
    num_labels: int
    feat_dim: int
    max_dur: int = 8                  # Dmax; gold runs must be <= max_dur
    pooling: str = "mean"             # "mean" | "sum" frame pooling
    use_dur_feature: bool = True      # per-(duration, label) bias
    use_seg_bias: bool = True         # per-label bias
    # Sub-states per segment: a segment's frames are split into num_states
    # contiguous proportional spans, each scored against its own frame-weight
    # column (nstate_cuts).  1 = plain segments.
    num_states: int = 1
    precision: str = "highest"

    def param_shapes(self) -> dict:
        wf = ((self.feat_dim, self.num_labels) if self.num_states == 1
              else (self.feat_dim, self.num_states, self.num_labels))
        shapes = {"w_frame": wf,
                  "b_trans": (self.num_labels, self.num_labels)}
        if self.use_dur_feature:
            shapes["b_dur"] = (self.max_dur, self.num_labels)
        if self.use_seg_bias:
            shapes["b_seg"] = (self.num_labels,)
        return shapes

    def init_params(self, generator: Optional[torch.Generator] = None,
                    scale: float = 0.0, device="cpu") -> dict:
        """Zero parameters (the reference's start), or ``scale * N(0, 1)``
        drawn on the CPU from ``generator`` in sorted-name order and moved to
        ``device``.  The numbers differ from the JAX package's ``jax.random``
        draws: cross-package tests build numpy parameters."""
        out = {}
        for name, shape in sorted(self.param_shapes().items()):
            w = (scale * torch.randn(shape, generator=generator) if scale
                 else torch.zeros(shape))
            out[name] = w.to(device)
        return out


def _check_precision(cfg: SegCrfConfig, tensor) -> None:
    """Raise for a precision other than ``highest`` where a kernel would
    serve ``tensor``: the kernels are IEEE fp32 only."""
    if kernels.use_kernel(tensor) and cfg.precision != "highest":
        raise NotImplementedError(
            f"precision {cfg.precision!r} on the CUDA kernels (only "
            "'highest', IEEE fp32, is ported; ROADMAP.md Queue 1)")


def _frame_scores_and_bias(cfg: SegCrfConfig, params, feats):
    """(frame scores ``(B, T, L)``, or ``(B, T, ns, L)`` for n-state;
    combined ``(Dmax, L)`` segment bias).  Params flow through the bias sum,
    so autograd routes its gradient back to b_dur / b_seg."""
    if cfg.num_states == 1:
        frame = torch.einsum("btd,dl->btl", feats, params["w_frame"])
    else:
        frame = torch.einsum("btd,dsl->btsl", feats, params["w_frame"])
    bias = segment_bias(params["b_dur"] if cfg.use_dur_feature else None,
                        params["b_seg"] if cfg.use_seg_bias else None,
                        cfg.max_dur, cfg.num_labels, frame)
    return frame, bias


def seg_potentials(cfg: SegCrfConfig, params, feats):
    """feats (B, T, D) -> (seg_score (B, T, Dmax, L), trans (L, L)).

    ``seg_score[b, t, d, l]``: pooled frame score of frames [t-d, t] plus
    the duration and label biases (entries with d > t are invalid: masked in
    the DP, arbitrary here).  With ``num_states > 1`` the segment is split
    into proportional sub-state spans, each pooled against its own
    frame-score column (:func:`nstate_cuts`)."""
    frame, bias = _frame_scores_and_bias(cfg, params, feats)
    T, dev = feats.shape[1], feats.device
    ds = torch.arange(cfg.max_dur, device=dev)
    start = torch.arange(T, device=dev)[:, None] - ds[None, :]   # (T, Dmax)
    cs = torch.cat([torch.zeros_like(frame[:, :1]), frame.cumsum(dim=1)],
                   dim=1)                         # (B, T+1, [ns,] L)
    if cfg.num_states == 1:
        # sum(frames[t-d..t]) = cs[t+1] - cs[t-d]
        seg = cs[:, 1:, None, :] - cs[:, start.clamp(0, T)]
        if cfg.pooling == "mean":
            seg = seg / (ds + 1.0)[None, None, :, None]
    else:
        ns = frame.shape[2]
        cuts = torch.from_numpy(nstate_cuts(cfg.max_dur, ns)).to(dev).long()
        seg = 0.0
        for s in range(ns):
            lo = (start + cuts[None, :, s]).clamp(0, T)          # (T, Dmax)
            hi = (start + cuts[None, :, s + 1]).clamp(0, T)
            span = cs[:, hi, s, :] - cs[:, lo, s, :]             # (B,T,Dmax,L)
            if cfg.pooling == "mean":
                span_len = (cuts[:, s + 1] - cuts[:, s]).clamp(min=1)
                span = span / span_len[None, None, :, None]
            seg = seg + span
    return seg + bias, params["b_trans"]


def _runs(labels, lengths):
    """Run-length analysis of frame labels ``(B, T)``: a frame is a boundary
    when its label differs from the previous frame's; run starts are the
    running max of boundary positions; a frame is a run end when the next
    frame starts a new run or the sequence ends.  Returns ``(ts (1, T),
    valid, prev, boundary, run_start, is_end)``, all ``(B, T)``."""
    B, T = labels.shape
    dev = labels.device
    lengths = lengths.to(dev)
    ts = torch.arange(T, device=dev)[None, :]
    valid = ts < lengths[:, None]
    prev = torch.cat([labels[:, :1] - 1, labels[:, :-1]], dim=1)
    boundary = (labels != prev) | (ts == 0)
    run_start = torch.where(boundary, ts, 0).cummax(dim=1).values
    nxt_new = torch.cat([boundary[:, 1:], torch.ones_like(boundary[:, :1])],
                        dim=1)
    last = lengths[:, None] - 1
    is_end = valid & (nxt_new | (ts == last)) & (ts <= last)
    return ts, valid, prev, boundary, run_start, is_end


def _pick(x, labels):
    """x[..., labels]: one entry of the last axis per leading position."""
    return x.gather(-1, labels.long()[..., None])[..., 0]


def _trans_score(trans, prev, labels, boundary, ts, valid):
    tr = trans[prev.long().clamp(min=0), labels.long()]
    return torch.where(boundary & (ts > 0) & valid, tr, 0.0).sum(dim=1)


def gold_segment_score(seg_score, trans, labels, length):
    """Score of the gold segmentation (from frame labels): the SCRF
    numerator.  Single sequence: seg_score (T, Dmax, L), labels (T,).  Gold
    runs longer than Dmax contribute a semiring zero (configs must set
    max_dur above the corpus maximum)."""
    T, Dmax, L = seg_score.shape
    labels = labels[None]
    ts, valid, prev, boundary, run_start, is_end = _runs(
        labels, torch.as_tensor([int(length)], device=labels.device))
    dur = ts - run_start
    seg_sc = _pick(seg_score[ts[0], dur[0].clamp(0, Dmax - 1)], labels[0])
    seg_sc = torch.where(dur[0] < Dmax, seg_sc, NEG_INF)
    score = torch.where(is_end[0], seg_sc, 0.0).sum()
    return score + _trans_score(trans, prev, labels, boundary, ts, valid)[0]


def gold_segment_score_stream(frame, bias, trans, labels, length,
                              mean_pool: bool = True):
    """Gold-segmentation score from frame scores alone (no (T, Dmax, L)
    tensor): pooled scores via cumulative-sum differences.  Single sequence:
    frame (T, L), bias (Dmax, L), labels (T,)."""
    return gold_segment_score_stream_ns(frame[:, None], bias, trans, labels,
                                        length, None, mean_pool)


def gold_segment_score_stream_ns(frame, bias, trans, labels, length, cuts,
                                 mean_pool: bool = True):
    """n-state gold-segmentation score from sub-state frame scores alone.
    Single sequence: frame (T, ns, L), bias (Dmax, L), ``cuts`` (Dmax, ns+1)
    static span boundaries (None: one span, the whole segment).  Each run's
    score sums its sub-state spans' pooled scores from per-stream cumulative
    sums."""
    T, ns, L = frame.shape
    Dmax = bias.shape[0]
    dev = frame.device
    cs = torch.cat([torch.zeros_like(frame[:1]), frame.cumsum(dim=0)])
    labels = labels[None]
    ts, valid, prev, boundary, run_start, is_end = _runs(
        labels, torch.as_tensor([int(length)], device=dev))
    lab, rs = labels[0], run_start[0]
    dur = ts[0] - rs
    dix = dur.clamp(0, Dmax - 1)
    if cuts is None:
        lo, hi = torch.zeros_like(dix)[:, None], (dur + 1)[:, None]
    else:
        cuts = torch.as_tensor(cuts, device=dev).long()[dix]     # (T, ns+1)
        lo, hi = cuts[:, :-1], cuts[:, 1:]
    pool = 0.0
    for s in range(ns):
        span = (_pick(cs[(rs + hi[:, s]).clamp(0, T), s], lab)
                - _pick(cs[(rs + lo[:, s]).clamp(0, T), s], lab))
        if mean_pool:
            span = span / (hi[:, s] - lo[:, s]).clamp(min=1)
        pool = pool + span
    seg_sc = pool + _pick(bias[dix], lab)
    seg_sc = torch.where(dur < Dmax, seg_sc, NEG_INF)
    score = torch.where(is_end[0], seg_sc, 0.0).sum()
    return score + _trans_score(trans, prev, labels, boundary, ts, valid)[0]


def gold_segment_score_batch(frame, bias, trans, labels, lengths,
                             mean_pool: bool = True):
    """Batched gold-segmentation scores: (B, T, L) frame scores + (B, T)
    labels -> (B,) scores, identical to the streamed form (fp reassociation
    aside), with a backward free of scattered adds into ``bias`` and
    ``trans``:

    - pooling is elementwise: frame u of a run of length n contributes
      ``frame[u, lab_u] / n`` (mean pool);
    - the bias and transition sums ride one-hot count matrices, whose
      adjoints are plain reductions (the same bits on every run).

    Runs longer than Dmax poison the score with NEG_INF per bad segment and
    give no pool or bias gradient, matching the streamed form."""
    B, T, L = frame.shape
    Dmax = bias.shape[0]
    dev = frame.device
    ts, valid, prev, boundary, run_start, is_end = _runs(labels, lengths)
    # end frame of the run containing u: the nearest is_end at or after u
    run_end = torch.where(is_end, ts, T - 1).flip(1).cummin(dim=1).values \
        .flip(1)
    dur = run_end - run_start
    ok_run = dur < Dmax
    w = torch.where(valid & ok_run,
                    1.0 / (dur + 1).to(frame.dtype) if mean_pool
                    else torch.ones_like(dur, dtype=frame.dtype), 0.0)
    pool = (_pick(frame, labels) * w).sum(dim=1)                 # (B,)

    onehot = (labels[..., None] == torch.arange(L, device=dev)).to(
        frame.dtype)
    d1 = ((dur.clamp(0, Dmax - 1)[..., None]
           == torch.arange(Dmax, device=dev))
          & (is_end & ok_run)[..., None]).to(frame.dtype)        # (B,T,Dmax)
    pe = torch.einsum("btd,btl->bdl", d1, onehot)
    score_bias = (pe * bias).sum(dim=(1, 2))
    # inexpressible gold (a run longer than Dmax): NEG_INF per bad segment
    score_bias = score_bias + NEG_INF * (is_end & ~ok_run).to(
        frame.dtype).sum(dim=1)

    p1 = ((prev[..., None] == torch.arange(L, device=dev))
          & (boundary & (ts > 0) & valid)[..., None]).to(frame.dtype)
    tm = torch.einsum("btp,btl->bpl", p1, onehot)
    return pool + score_bias + (tm * trans).sum(dim=(1, 2))


def _nll(logZ, gold, lengths):
    lengths = lengths.to(logZ.device)
    nll = torch.where(lengths > 0, logZ - gold, 0.0)
    total = lengths.sum().clamp(min=1)
    return nll.sum() / total, {"logZ": logZ, "gold": gold, "nll": nll}


def scrf_loss(cfg: SegCrfConfig, params, feats, labels, lengths):
    """Mean negative segmental log-likelihood per frame (batched), through
    the materialized (B, T, Dmax, L) tensor: the small-shape oracle;
    production training uses :func:`scrf_loss_fused`."""
    seg, trans = seg_potentials(cfg, params, feats)
    _, logZ = seg_ops.segmental_forward_batch(seg, trans, lengths)
    gold = torch.stack([gold_segment_score(s, trans, l, int(n))
                        for s, l, n in zip(seg, labels, lengths)])
    return _nll(logZ, gold, lengths)


def scrf_loss_fused(cfg: SegCrfConfig, params, feats, labels, lengths):
    """Production SCRF training loss: the value and gradient of
    :func:`scrf_loss` without the (B, T, Dmax, L) tensor.  The denominator
    runs the streaming classical-gradient Function (K9, K10 and K11 for CUDA
    tensors) and the numerator scores gold segments from the frame scores.
    ``num_states > 1``: the same streaming recursion with sub-state span
    pooling, as frame loops."""
    _check_precision(cfg, feats)
    frame, bias = _frame_scores_and_bias(cfg, params, feats)
    mean_pool = cfg.pooling == "mean"
    trans = params["b_trans"]
    if cfg.num_states > 1:
        logZ = seg_log_partition_stream_ns(
            frame, bias, trans, lengths, cfg.max_dur, cfg.num_states,
            mean_pool)
        cuts = nstate_cuts(cfg.max_dur, cfg.num_states)
        gold = torch.stack([gold_segment_score_stream_ns(
            f, bias, trans, l, int(n), cuts, mean_pool)
            for f, l, n in zip(frame, labels, lengths)])
    else:
        logZ = seg_log_partition_stream(frame, bias, trans, lengths,
                                        cfg.max_dur, mean_pool)
        gold = gold_segment_score_batch(frame, bias, trans, labels, lengths,
                                        mean_pool)
    return _nll(logZ, gold, lengths)


def scrf_decode(cfg: SegCrfConfig, params, feats, lengths,
                beam_threshold: Optional[float] = None,
                beam_width: Optional[int] = None):
    """Best segmentations.  Returns (starts, labels, n_segs, scores) with
    fixed-size (B, T) segment arrays (see ops.segmental.segmental_viterbi).
    Runs the streaming max-plus lattice (K12 and K13 for CUDA tensors with
    one sub-state and no ``beam_width``); both beam options None = exact."""
    _check_precision(cfg, feats)
    with torch.no_grad():
        frame, bias = _frame_scores_and_bias(cfg, params, feats)
        return seg_viterbi_stream(
            frame, bias, params["b_trans"], lengths, cfg.max_dur,
            cfg.num_states, cfg.pooling == "mean", beam_threshold, beam_width)


def scrf_decode_dense(cfg: SegCrfConfig, params, feats, lengths):
    """Materialized-(B, T, Dmax, L) decode: the small-shape oracle the
    streaming path is held to."""
    with torch.no_grad():
        seg, trans = seg_potentials(cfg, params, feats)
        return seg_ops.segmental_viterbi_batch(seg, trans, lengths)


def scrf_log_partition_fused(cfg: SegCrfConfig, params, feats, lengths):
    """SCRF logZ without materializing (B, T, Dmax, L); differentiable
    (the classical segmental forward-backward gradient)."""
    _check_precision(cfg, feats)
    frame, bias = _frame_scores_and_bias(cfg, params, feats)
    if cfg.num_states > 1:
        return seg_log_partition_stream_ns(
            frame, bias, params["b_trans"], lengths, cfg.max_dur,
            cfg.num_states, cfg.pooling == "mean")
    return seg_log_partition_stream(frame, bias, params["b_trans"], lengths,
                                    cfg.max_dur, cfg.pooling == "mean")


def scrf_frame_labels(cfg: SegCrfConfig, params, feats, lengths):
    """Decode and expand to per-frame labels (B, T) for frame metrics."""
    starts, labs, n, scores = scrf_decode(cfg, params, feats, lengths)
    frames = seg_ops.segments_to_frames(starts, labs, n, lengths,
                                        feats.shape[1])
    return frames, scores
