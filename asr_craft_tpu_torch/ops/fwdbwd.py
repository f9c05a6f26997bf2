"""Generic forward-backward recursions: the plain path.

Counterpart of :mod:`asr_craft_tpu.ops.fwdbwd`, the same names.  The
batched surface (``forward_batch``, ``log_partition_batch``,
``posteriors_batch``, ``path_score_batch``) is written batched over B
instead of through ``vmap``: a Python loop over frames of tensor ops, the
same arithmetic as the JAX ``lax.scan`` version.  The single-utterance
functions (``forward``, ``backward``, ``log_partition``, ``posteriors``,
``path_score``, ``broadcast_trans``) run it on a batch of one.  The
recursions take ``semiring=`` (:mod:`asr_craft_tpu_torch.ops.semiring`:
``LOG``, the default, or ``TROPICAL``); posteriors are the log semiring's.
Transitions are shared ``(L, L)`` or ``(T, L, L)``, or per sequence and
frame ``(B, T, L, L)``; ``trans[..., t, p, l]`` scores the
edge from label ``p`` at frame ``t - 1`` to label ``l`` at frame ``t`` (row
0 is unused).  Gradients come from autograd through the loop.

The shared ``(L, L)`` training path does not run here: it runs the
rescaled-exp recursions of :mod:`asr_craft_tpu_torch.ops.mxu` (the K4-K6
kernels on the card).  This module holds no kernel.
"""
from __future__ import annotations

import torch

from asr_craft_tpu_torch.ops.semiring import LOG, get_semiring

__all__ = ["broadcast_trans", "forward", "backward", "log_partition",
           "posteriors", "path_score", "forward_batch", "log_partition_batch",
           "posteriors_batch", "path_score_batch"]


def _trans_at(trans, t: int):
    """Frame ``t``'s transitions, broadcastable against ``(B, L, L)``."""
    if trans.dim() == 2:
        return trans
    return trans[t] if trans.dim() == 3 else trans[:, t]


def _check(state, trans):
    """``(B, T, L)`` of ``state``, with ``trans`` shared ``(L, L)`` or
    ``(T, L, L)``, or per sequence ``(B, T, L, L)``, as the JAX batched
    functions take them."""
    B, T, L = state.shape
    if tuple(trans.shape) not in ((L, L), (trans.shape[0], L, L),
                                  (B, trans.shape[1], L, L)):
        raise ValueError(f"trans {tuple(trans.shape)} vs state "
                         f"{tuple(state.shape)}")
    if trans.dim() > 2 and trans.shape[-3] != T:
        raise ValueError(
            f"frame-dependent transitions have T={trans.shape[-3]}, but "
            f"state potentials have T={T}")
    return B, T, L


def forward_batch(state, trans, lengths, semiring=LOG):
    """Alpha pass: ``(alphas (B, T, L), logZ (B,))``.  ``alpha[0] =
    state[0]``; frames ``t >= length`` carry alpha through, so ``logZ`` is
    the semiring sum of ``alpha[length - 1]`` (of frame 0 for an empty
    row): the log-partition (``LOG``) or the best path's score
    (``TROPICAL``)."""
    sr = get_semiring(semiring)
    B, T, L = _check(state, trans)
    lengths = lengths.to(state.device)
    a = state[:, 0]
    alphas = [a]
    for t in range(1, T):
        new = sr.sum(a[:, :, None] + _trans_at(trans, t), 1) + state[:, t]
        a = torch.where((t < lengths)[:, None], new, a)
        alphas.append(a)
    return torch.stack(alphas, dim=1), sr.sum(a, -1)


def backward_batch(state, trans, lengths, semiring=LOG):
    """Beta pass: ``betas (B, T, L)``, 0 at frames ``t >= length - 1``."""
    sr = get_semiring(semiring)
    B, T, L = _check(state, trans)
    lengths = lengths.to(state.device)
    b = torch.zeros((B, L), dtype=state.dtype, device=state.device)
    betas = [b]
    for t in range(T - 2, -1, -1):
        x = b + state[:, t + 1]
        new = sr.sum(_trans_at(trans, t + 1) + x[:, None, :], 2)
        b = torch.where((t + 1 < lengths)[:, None], new,
                        torch.zeros_like(new))
        betas.insert(0, b)
    return torch.stack(betas, dim=1)


def log_partition_batch(state, trans, lengths, semiring=LOG):
    """``logZ (B,)`` (``LOG``) or the best paths' scores (``TROPICAL``)."""
    return forward_batch(state, trans, lengths, semiring)[1]


def posteriors_batch(state, trans, lengths):
    """(B, T, L) frame posteriors ``exp(alpha + beta - logZ)``; rows of
    frames past each length are zero."""
    alphas, logZ = forward_batch(state, trans, lengths)
    betas = backward_batch(state, trans, lengths)
    gamma = torch.exp(alphas + betas - logZ[:, None, None])
    T = state.shape[1]
    valid = (torch.arange(T, device=state.device)[None, :]
             < lengths.to(state.device)[:, None])
    return torch.where(valid[..., None], gamma, 0.0)


def path_score_batch(state, trans, labels, lengths):
    """(B,) log score of the label paths ``labels (B, T)``: the sum over
    valid frames of ``state[t, y_t]`` and, from frame 1, ``trans[t,
    y_{t-1}, y_t]``."""
    B, T, L = _check(state, trans)
    lengths = lengths.to(state.device)
    cur = labels.long()
    s = torch.gather(state, 2, cur[..., None])[..., 0]             # (B, T)
    prev, nxt = cur[:, :-1], cur[:, 1:]
    if trans.dim() == 2:
        tr = trans[prev, nxt]
    elif trans.dim() == 3:
        tr = trans[torch.arange(1, T, device=state.device)[None, :], prev,
                   nxt]
    else:
        tr = trans[torch.arange(B, device=state.device)[:, None],
                   torch.arange(1, T, device=state.device)[None, :], prev,
                   nxt]
    valid = torch.arange(T, device=state.device)[None, :] < lengths[:, None]
    return (torch.where(valid, s, 0.0).sum(1)
            + torch.where(valid[:, 1:], tr, 0.0).sum(1))


# ---------------------------------------------------------------------------
# One utterance: ``state (T, L)``, ``trans (L, L)`` or ``(T, L, L)``, a
# scalar ``length``; the batched code on a batch of one.
# ---------------------------------------------------------------------------

def broadcast_trans(log_phi_trans, T: int):
    """``(T, L, L)`` transitions from ``(L, L)`` (a broadcast view, not a
    copy) or ``(T, L, L)``."""
    if log_phi_trans.dim() == 2:
        return log_phi_trans.expand(T, *log_phi_trans.shape)
    if log_phi_trans.shape[0] != T:
        raise ValueError(
            f"frame-dependent transitions have T={log_phi_trans.shape[0]}, "
            f"but state potentials have T={T}")
    return log_phi_trans


def _one(state, trans, length):
    """``(state, trans, lengths)`` of a batch of one utterance."""
    if trans.dim() == 3:
        trans = broadcast_trans(trans, state.shape[0])[None]
    lengths = torch.as_tensor(length, device=state.device).reshape(1)
    return state[None], trans, lengths


def forward(log_phi_state, log_phi_trans, length, semiring=LOG):
    """Alpha pass: ``(alphas (T, L), logZ)``; ``alpha[t, l] =
    sr.sum_p(alpha[t-1, p] + trans[t, p, l]) + state[t, l]``, padded frames
    carry alpha through."""
    alphas, logZ = forward_batch(*_one(log_phi_state, log_phi_trans, length),
                                 semiring)
    return alphas[0], logZ[0]


def backward(log_phi_state, log_phi_trans, length, semiring=LOG):
    """Beta pass: ``betas (T, L)``, the semiring one (0.0) at ``t >=
    length - 1``."""
    return backward_batch(*_one(log_phi_state, log_phi_trans, length),
                          semiring)[0]


def log_partition(log_phi_state, log_phi_trans, length, semiring=LOG):
    """``logZ`` (log semiring) or the best path's score (tropical)."""
    return forward(log_phi_state, log_phi_trans, length, semiring)[1]


def posteriors(log_phi_state, log_phi_trans, length):
    """Frame posteriors ``(T, L)``; rows past ``length`` are zero."""
    return posteriors_batch(*_one(log_phi_state, log_phi_trans, length))[0]


def path_score(log_phi_state, log_phi_trans, labels, length):
    """Log score of one label path ``labels (T,)`` over the valid
    frames."""
    state, trans, lengths = _one(log_phi_state, log_phi_trans, length)
    return path_score_batch(state, trans, labels[None], lengths)[0]
