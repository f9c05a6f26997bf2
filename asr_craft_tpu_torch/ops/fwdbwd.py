"""Generic forward-backward recursions: the plain batched path.

Counterpart of the batched surface of :mod:`asr_craft_tpu.ops.fwdbwd`
(``forward_batch``, ``log_partition_batch``, ``posteriors_batch``,
``path_score_batch``), written batched over B instead of through ``vmap``:
a Python loop over frames of tensor ops, the same arithmetic as the JAX
``lax.scan`` version, in the log semiring.  Transitions are shared ``(L,
L)`` or per sequence and frame ``(B, T, L, L)``; ``trans[..., t, p, l]``
scores the edge from label ``p`` at frame ``t - 1`` to label ``l`` at frame
``t`` (row 0 is unused).  Gradients come from autograd through the loop.

The shared ``(L, L)`` training path does not run here: it runs the
rescaled-exp recursions of :mod:`asr_craft_tpu_torch.ops.mxu` (the K4-K6
kernels on the card).  This module holds no kernel.
"""
from __future__ import annotations

import torch

from asr_craft_tpu_torch.ops.semiring import NEG_INF


def _lse(x, dim: int):
    """Max-subtracted logsumexp along ``dim`` whose max is clamped at
    NEG_INF, so an all-dead slice stays finite."""
    m = torch.clamp(x.amax(dim=dim, keepdim=True), min=NEG_INF)
    return (m + torch.log(torch.exp(x - m).sum(dim=dim,
                                               keepdim=True))).squeeze(dim)


def _trans_at(trans, t: int):
    """Frame ``t``'s transitions, broadcastable against ``(B, L, L)``."""
    return trans if trans.dim() == 2 else trans[:, t]


def _check(state, trans):
    B, T, L = state.shape
    if tuple(trans.shape) not in ((L, L), (B, trans.shape[1], L, L)):
        raise ValueError(f"trans {tuple(trans.shape)} vs state "
                         f"{tuple(state.shape)}")
    if trans.dim() == 4 and trans.shape[1] != T:
        raise ValueError(
            f"frame-dependent transitions have T={trans.shape[1]}, but "
            f"state potentials have T={T}")
    return B, T, L


def forward_batch(state, trans, lengths):
    """Alpha pass: ``(alphas (B, T, L), logZ (B,))``.  ``alpha[0] =
    state[0]``; frames ``t >= length`` carry alpha through, so ``logZ`` is
    the logsumexp of ``alpha[length - 1]`` (of frame 0 for an empty
    row)."""
    B, T, L = _check(state, trans)
    lengths = lengths.to(state.device)
    a = state[:, 0]
    alphas = [a]
    for t in range(1, T):
        new = _lse(a[:, :, None] + _trans_at(trans, t), 1) + state[:, t]
        a = torch.where((t < lengths)[:, None], new, a)
        alphas.append(a)
    return torch.stack(alphas, dim=1), _lse(a, -1)


def backward_batch(state, trans, lengths):
    """Beta pass: ``betas (B, T, L)``, 0 at frames ``t >= length - 1``."""
    B, T, L = _check(state, trans)
    lengths = lengths.to(state.device)
    b = torch.zeros((B, L), dtype=state.dtype, device=state.device)
    betas = [b]
    for t in range(T - 2, -1, -1):
        x = b + state[:, t + 1]
        new = _lse(_trans_at(trans, t + 1) + x[:, None, :], 2)
        b = torch.where((t + 1 < lengths)[:, None], new,
                        torch.zeros_like(new))
        betas.insert(0, b)
    return torch.stack(betas, dim=1)


def log_partition_batch(state, trans, lengths):
    """``logZ (B,)``."""
    return forward_batch(state, trans, lengths)[1]


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
    else:
        tr = trans[torch.arange(B, device=state.device)[:, None],
                   torch.arange(1, T, device=state.device)[None, :], prev,
                   nxt]
    valid = torch.arange(T, device=state.device)[None, :] < lengths[:, None]
    return (torch.where(valid, s, 0.0).sum(1)
            + torch.where(valid[:, 1:], tr, 0.0).sum(1))
