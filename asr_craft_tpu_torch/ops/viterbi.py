"""Viterbi decoding: the plain path.

Counterpart of :mod:`asr_craft_tpu.ops.viterbi`, the same names:
``viterbi`` decodes one utterance (``state (T, L)``), ``viterbi_batch`` a
batch (``state (B, T, L)``) over shared ``(L, L)`` or ``(T, L, L)``
transitions or per-sequence ``(B, T, L, L)`` ones.  Written batched over B
instead of through ``vmap``: a Python loop over frames of tensor ops, the
same arithmetic as the JAX ``lax.scan`` version.  The CUDA kernels of
:mod:`asr_craft_tpu_torch.kernels.viterbi` (K7 dense, K8 n-state) are held
to it for ``(L, L)`` transitions; the other shapes have no TPU kernel in the
JAX package either, and run here on either device.

The tie order is the XLA path's, and part of the public contract: every
backpointer and the final label are the FIRST argmax in expanded-state
order ``q * ns + s``.  Pruning (threshold, then top-k with ties at the k-th
value kept) applies on frame 0 too; frames ``t >= length`` keep the carry
with identity backpointers.  Boundary masking is not done here:
``models.crf.decode`` folds it into the state potentials first.
"""
from __future__ import annotations

from typing import Optional

import torch

from asr_craft_tpu_torch.ops.fdt import (first_argmax, fdt_viterbi_traceback,
                                         prune)
from asr_craft_tpu_torch.ops.fwdbwd import _check, _one, _trans_at

__all__ = ["viterbi", "viterbi_batch"]


def viterbi_forward(state, trans, lengths,
                    beam_width: Optional[int] = None,
                    beam_threshold: Optional[float] = None):
    """Max-plus forward: ``state (B, T, L)``, ``trans (L, L)``, ``(T, L,
    L)`` or ``(B, T, L, L)`` (row = predecessor; frame 0's unused),
    ``lengths (B,)``.

    Returns ``bp (B, T, L) int32`` (the predecessor of each label at each
    frame; identity at frame 0 and at frames ``t >= length``), the final
    first-argmax ``last (B,) int32`` and ``scores (B,)`` — the layout of
    :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_forward`.
    """
    B, T, L = _check(state, trans)
    dev = state.device
    lengths = lengths.to(dev)
    lab = torch.arange(L, device=dev, dtype=torch.int32)
    bp = torch.empty((B, T, L), dtype=torch.int32, device=dev)
    bp[:, 0] = lab
    delta = prune(state[:, 0], beam_threshold, beam_width)
    for t in range(1, T):
        best, bpt = first_argmax(delta[:, :, None] + _trans_at(trans, t),
                                 dim=1)
        new = prune(best + state[:, t], beam_threshold, beam_width)
        valid = (t < lengths)[:, None]
        delta = torch.where(valid, new, delta)
        bp[:, t] = torch.where(valid, bpt, lab)
    scores, last = first_argmax(delta, dim=-1)
    return bp, last, scores


def viterbi_batch(state, trans, lengths, beam_width: Optional[int] = None,
                  beam_threshold: Optional[float] = None):
    """Max-plus decode with traceback of a batch: (paths (B, T) int32,
    scores (B,)).  ``trans``: ``(L, L)``, ``(T, L, L)`` or ``(B, T, L,
    L)``.  Padded frames of a path repeat its label at ``length - 1`` (the
    backpointers there are the identity); a row of length 0 is its frame-0
    argmax throughout."""
    bp, last, scores = viterbi_forward(state, trans, lengths, beam_width,
                                       beam_threshold)
    return fdt_viterbi_traceback(bp, last, lengths), scores


def viterbi(log_phi_state, log_phi_trans, length,
            beam_width: Optional[int] = None,
            beam_threshold: Optional[float] = None):
    """Best label path of one utterance: ``(path (T,) int32, score)`` from
    ``state (T, L)``, ``trans (L, L)`` or ``(T, L, L)`` and a scalar
    ``length``; :func:`viterbi_batch` on a batch of one, so the tie order
    and the padding rule are the same."""
    state, trans, lengths = _one(log_phi_state, log_phi_trans, length)
    paths, scores = viterbi_batch(state, trans, lengths, beam_width,
                                  beam_threshold)
    return paths[0], scores[0]


def path_score(state, trans, paths, lengths):
    """(B,) score of given ``paths (B, T)`` under ``state (B, T, L)`` and
    ``trans (L, L)``: the sum over valid frames of the state potential and,
    from frame 1, of the transition taken.  A decode's score is the score
    of its own path; two paths of near-equal score are both optimal within
    the fp32 tolerance (the near-tie rule)."""
    B, T, L = state.shape
    lengths = lengths.to(state.device)
    cur = paths.long()
    s = torch.gather(state, 2, cur[..., None])[..., 0]             # (B, T)
    tr = trans[cur[:, :-1], cur[:, 1:]]                            # (B, T-1)
    valid = torch.arange(T, device=state.device)[None, :] < lengths[:, None]
    return (torch.where(valid, s, 0.0).sum(1)
            + torch.where(valid[:, 1:], tr, 0.0).sum(1))
