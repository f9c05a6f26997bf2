"""Segmental CRF (SCRF) recursions over a dense (time x duration x label)
lattice: the small-shape oracle.

Counterpart of :mod:`asr_craft_tpu.ops.segmental`, same public names.  Plain
frame loops over a materialized ``(T, Dmax, L)`` segment-potential tensor;
autograd differentiates the forward (the ``--dense_loss`` training path).
The production path never builds that tensor: it is
:mod:`asr_craft_tpu_torch.ops.segmental_stream`.

Conventions (the reference's):
- ``seg_score[t, d, l]``: log potential of a segment labelled ``l`` covering
  frames ``[t - d, t]`` inclusive (``d`` = duration - 1).  Entries with
  ``d > t`` are invalid and masked inside the recursion.
- ``trans``: ``(L, L)`` segment-level label transitions (the frame-dependent
  ``(T, L, L)`` form has no caller in the port).
- Ties: the shortest duration among equal candidates, then the lowest
  predecessor label, the lowest final label.
"""
from __future__ import annotations

import torch

from asr_craft_tpu_torch.ops.semiring import NEG_INF

__all__ = ["segmental_forward", "segmental_viterbi",
           "segmental_forward_batch", "segmental_viterbi_batch",
           "segments_to_frames", "traceback_segments"]


def _alpha_scan(seg_score, trans, tropical: bool):
    """The alpha recursion over a batch: ``seg_score (B, T, Dmax, L)``.
    Returns alphas ``(B, T, L)`` and, for the tropical semiring, the
    duration and predecessor argmaxes ``(B, T, L)`` int64."""
    B, T, Dmax, L = seg_score.shape
    dev = seg_score.device
    ds = torch.arange(Dmax, device=dev)
    # buf[:, i] = alpha[t - 1 - i]; rows before the start of time are zero
    buf = torch.full((B, Dmax, L), NEG_INF, dtype=seg_score.dtype, device=dev)
    alphas, arg_ds, arg_ps = [], [], []
    for t in range(T):
        starts = (t - ds)[None, :, None]
        pair = buf[:, :, :, None] + trans                 # (B, Dmax, P, L)
        if tropical:
            msg, arg_p = pair.max(dim=2)
        else:
            msg = torch.logsumexp(pair, dim=2)
        # a segment starting at 0 has no predecessor: the semiring one
        msg = torch.where(starts == 0, 0.0, msg)
        msg = torch.where(starts < 0, NEG_INF, msg)
        cand = msg + seg_score[:, t]                      # (B, Dmax, L)
        if tropical:
            alpha_t, arg_d = cand.max(dim=1)
            arg_ds.append(arg_d)
            arg_ps.append(arg_p.gather(1, arg_d[:, None])[:, 0])
        else:
            alpha_t = torch.logsumexp(cand, dim=1)
        alphas.append(alpha_t)
        buf = torch.cat([alpha_t[:, None], buf[:, :-1]], dim=1)
    alphas = torch.stack(alphas, dim=1)
    if tropical:
        return alphas, torch.stack(arg_ds, dim=1), torch.stack(arg_ps, dim=1)
    return alphas


def _last_row(alphas, lengths):
    """alphas[b, lengths[b] - 1]; a zero length reads the last frame, as the
    reference's wrapped index does."""
    T = alphas.shape[1]
    idx = (lengths.to(alphas.device).long() - 1) % T
    return alphas[torch.arange(alphas.shape[0], device=alphas.device), idx]


def segmental_forward_batch(seg_score, trans, lengths):
    """``(alphas (B, T, L), logZ (B,))`` over all segmentations and
    labelings of the first ``lengths[b]`` frames."""
    alphas = _alpha_scan(seg_score, trans, tropical=False)
    return alphas, torch.logsumexp(_last_row(alphas, lengths), dim=-1)


def segmental_forward(seg_score, trans, length):
    """Single sequence: ``seg_score (T, Dmax, L)``.  Returns ``(alphas (T,
    L), logZ)``."""
    alphas, logZ = segmental_forward_batch(
        seg_score[None], trans, torch.as_tensor([int(length)]))
    return alphas[0], logZ[0]


def traceback_segments(arg_d, arg_p, lab0, lengths):
    """Walk the duration and predecessor argmaxes ``(B, T, L)`` back from
    ``(lengths - 1, lab0)``: at ``(t, l)`` the best last segment spans ``[t -
    arg_d[t, l], t]`` and its predecessor's label is ``arg_p[t, l]``.  Returns
    ``(starts (B, T), labels (B, T), n_segs (B,))`` int32, ascending.  A walk
    on the host, one utterance after the other."""
    B, T, _ = arg_d.shape
    dev = arg_d.device
    arg_d, arg_p, lab0 = arg_d.cpu(), arg_p.cpu(), lab0.cpu()
    starts = torch.zeros((B, T), dtype=torch.int32)
    labels = torch.zeros((B, T), dtype=torch.int32)
    n_segs = torch.zeros((B,), dtype=torch.int32)
    for b, length in enumerate(lengths.tolist()):
        t, lab, segs = length - 1, int(lab0[b]), []
        while t >= 0:
            start = t - int(arg_d[b, t, lab])
            segs.append((start, lab))
            lab, t = int(arg_p[b, t, lab]), start - 1
        segs.reverse()                        # written last segment first
        n_segs[b] = len(segs)
        if segs:
            seg_t = torch.tensor(segs, dtype=torch.int32)
            starts[b, :len(segs)] = seg_t[:, 0]
            labels[b, :len(segs)] = seg_t[:, 1]
    return starts.to(dev), labels.to(dev), n_segs.to(dev)


def segmental_viterbi_batch(seg_score, trans, lengths):
    """Best segmentations.  Returns ``(starts, labels, n_segs, scores)``:
    ``(B, T)`` int32 arrays whose entries ``[0, n_segs)`` hold the segment
    start frames (ascending) and labels; segment ``i`` spans ``[starts[i],
    starts[i + 1] - 1]`` and the last ends at ``length - 1``."""
    alphas, arg_d, arg_p = _alpha_scan(seg_score, trans, tropical=True)
    scores, lab0 = _last_row(alphas, lengths).max(dim=-1)
    starts, labels, n_segs = traceback_segments(arg_d, arg_p, lab0, lengths)
    return starts, labels, n_segs, scores


def segmental_viterbi(seg_score, trans, length):
    """Single sequence: ``(starts (T,), labels (T,), n_segs, score)``."""
    starts, labels, n, scores = segmental_viterbi_batch(
        seg_score[None], trans, torch.as_tensor([int(length)]))
    return starts[0], labels[0], n[0], scores[0]


def segments_to_frames(starts, labels, n_segs, length, T: int):
    """Expand segment lists ``(..., K)`` to per-frame labels ``(..., T)``
    (frames past the last segment's start keep its label; ``length`` is
    unused, as in the reference)."""
    ts = torch.arange(T, device=starts.device)
    K = starts.shape[-1]
    live = torch.arange(K, device=starts.device) < n_segs[..., None]
    # frame t belongs to segment i where starts[i] <= t < starts[i + 1]
    seg_idx = ((ts[:, None] >= starts[..., None, :])
               & live[..., None, :]).sum(dim=-1) - 1
    return labels.gather(-1, seg_idx.clamp(0, K - 1))
