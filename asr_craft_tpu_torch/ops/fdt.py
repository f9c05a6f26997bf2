"""Frame-dependent transition features, topology-factored: the plain path.

Counterpart of :mod:`asr_craft_tpu.ops.fdt`.  Under the n-state
left-to-right topology only three transition classes are legal —

    self     (s, s)            L'  entries per frame
    advance  (s, s+1)          L' - P entries (within-phone)
    cross    (last_i, first_j) P^2 entries (phone bigram)

so the lattice is scored on per-frame factored planes ``selfp (B, T, L')``,
``advp (B, T, L')`` and ``crossp (B, T, P, P)`` instead of a materialized
``(B, T, L', L')`` tensor.  For ``ns == 1`` every pair is legal and
``crossp`` is the full frame-dependent matrix.

This module is the plain PyTorch reference: a Python loop over frames of
tensor ops, the same arithmetic as the JAX ``lax.scan`` version.  It holds
both semirings: max-plus (the decode, :func:`fdt_viterbi`) and log
(the training criterion, :func:`fdt_logZ_pair` / :func:`fdt_nll_dual`,
differentiated by autograd, and :func:`fdt_posteriors`).  The CUDA kernels
(``kernels/fdt_viterbi.py``, ``kernels/fdt_train.py``) are held to it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.ops.semiring import NEG_INF


def _adv_valid(Lp: int, ns: int) -> np.ndarray:
    """(L',) 1.0 where state-major label l has an advance edge (st < ns-1)."""
    st = np.arange(Lp) % ns
    return (st < ns - 1).astype(np.float32)


def factored_trans_weights(params: dict, Lp: int, ns: int):
    """Gather the legal-transition columns of the canonical parameters.

    ``params``: ``w_trans (Dt, L', L')`` and optionally ``b_trans (L', L')``.
    Returns ``(w_self (Dt, L'), b_self (L',), w_adv, b_adv,
    w_cross (Dt, P, P), b_cross (P, P))``.  For ``ns == 1`` only the cross
    pair is meaningful; self/adv are zeros and must not be used.
    """
    w = params["w_trans"]
    b = params.get("b_trans")
    Dt = w.shape[0]
    P = Lp // ns
    dev = w.device
    if b is None:
        b = torch.zeros((Lp, Lp), dtype=w.dtype, device=dev)
    if ns == 1:
        z = torch.zeros((Dt, Lp), dtype=w.dtype, device=dev)
        zb = torch.zeros((Lp,), dtype=w.dtype, device=dev)
        return z, zb, z, zb, w, b
    lab = torch.arange(Lp, device=dev)
    adv_mask = torch.from_numpy(_adv_valid(Lp, ns)).to(dev)
    w_self = torch.diagonal(w, dim1=1, dim2=2)             # (Dt, L')
    b_self = torch.diagonal(b)
    nxt = torch.clamp(lab + 1, max=Lp - 1)                 # dummy at last col
    w_adv = w[:, lab, nxt] * adv_mask
    b_adv = b[lab, nxt] * adv_mask
    last = torch.arange(P, device=dev) * ns + (ns - 1)
    first = torch.arange(P, device=dev) * ns
    w_cross = w[:, last][:, :, first]                      # (Dt, P, P)
    b_cross = b[last][:, first]
    return w_self, b_self, w_adv, b_adv, w_cross, b_cross


def factored_planes(params: dict, feats, Lp: int, ns: int, state_range,
                    trans_range, use_state_bias: bool = True):
    """feats (B, T, D) -> (state (B,T,L'), selfp, advp, crossp (B,T,P,P)).

    fp32 matmuls throughout (the ``highest`` precision of the reference).
    ``selfp``/``advp`` are None for ``ns == 1``.
    """
    xs = feats[..., state_range[0]:state_range[1]]
    xt = feats[..., trans_range[0]:trans_range[1]]
    state = xs @ params["w_state"]
    if use_state_bias and "b_state" in params:
        state = state + params["b_state"]
    w_self, b_self, w_adv, b_adv, w_cross, b_cross = \
        factored_trans_weights(params, Lp, ns)
    crossp = torch.einsum("...td,dpq->...tpq", xt, w_cross) + b_cross
    if ns == 1:
        return state, None, None, crossp
    selfp = xt @ w_self + b_self
    advp = xt @ w_adv + b_adv
    # keep illegal advance slots at the semiring zero regardless of bias
    adv_ok = torch.from_numpy(_adv_valid(Lp, ns)).to(feats.device) > 0
    advp = torch.where(adv_ok, advp, NEG_INF)
    return state, selfp, advp, crossp


def _boundary_state(state, lengths, ns: int, boundaries: bool):
    """Fold start/end n-state masking into the state plane (state-major):
    frame 0 may only enter a phone's first state, frame ``length-1`` may
    only leave from a phone's last state."""
    if ns == 1 or not boundaries:
        return state
    B, T, Lp = state.shape
    st = torch.arange(Lp, device=state.device) % ns
    start = torch.where(st == 0, 0.0, NEG_INF)
    end = torch.where(st == ns - 1, 0.0, NEG_INF)
    state = state.clone()
    state[:, 0, :] += start
    at_end = (torch.arange(T, device=state.device)[None, :]
              == (lengths - 1)[:, None])
    return state + torch.where(at_end[..., None], end, 0.0)


def first_argmax(x, dim: int):
    """(max, first index of the max) along ``dim``; int32 indices.

    Spelled out because the tie order is part of the public contract:
    among equal maxima the lowest index wins."""
    m = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device, dtype=torch.int32).reshape(shape)
    a = torch.where(x == m, idx, n).amin(dim=dim)
    return m.squeeze(dim), a


def prune(delta, beam_threshold: Optional[float],
          beam_width: Optional[int]):
    """Threshold, then top-k, over the last axis (None = off).

    Threshold keeps ``delta >= max - thr`` in fp32; top-k keeps every value
    ``>=`` the exact K-th largest (ties at the K-th all kept) and applies
    only when ``beam_width < L'``."""
    if beam_threshold is not None:
        m = delta.amax(dim=-1, keepdim=True)
        delta = torch.where(delta >= m - beam_threshold, delta, NEG_INF)
    if beam_width is not None and beam_width < delta.shape[-1]:
        kth = torch.topk(delta, beam_width, dim=-1).values[..., -1:]
        delta = torch.where(delta >= kth, delta, NEG_INF)
    return delta


def fdt_viterbi_forward(state, selfp, advp, crossp, lengths, ns: int,
                        boundaries: bool = True,
                        beam_width: Optional[int] = None,
                        beam_threshold: Optional[float] = None):
    """Max-plus forward over the factored lattice.

    Returns ``bp (B, T, L') int32`` — the predecessor expanded label of
    each state at each frame (identity at frame 0 and at frames
    ``t >= length``) — and the final ``last (B,) int32`` first-argmax label
    and ``scores (B,)``.  Tie order between transition kinds is
    self > advance > cross; the cross predecessor is the first phone among
    equal maxima.
    """
    B, T, Lp = state.shape
    dev = state.device
    lengths = lengths.to(dev)
    state = _boundary_state(state, lengths, ns, boundaries)
    lab = torch.arange(Lp, device=dev, dtype=torch.int32)
    st = lab % ns
    bp = torch.empty((B, T, Lp), dtype=torch.int32, device=dev)
    bp[:, 0] = lab
    delta = prune(state[:, 0], beam_threshold, beam_width)
    for t in range(1, T):
        if ns == 1:
            cand = delta[:, :, None] + crossp[:, t]             # (B, Pprev, P)
            best, bpt = first_argmax(cand, dim=1)
        else:
            self_c = delta + selfp[:, t]
            adv_c = torch.roll(delta + advp[:, t], 1, dims=-1)
            adv_c = torch.where(st > 0, adv_c, NEG_INF)
            camd = delta[:, ns - 1::ns, None] + crossp[:, t]    # (B, P, P)
            cross_best, cross_arg = first_argmax(camd, dim=1)
            cross_c = torch.where(
                st == 0, torch.repeat_interleave(cross_best, ns, dim=-1),
                NEG_INF)
            cross_bp = torch.repeat_interleave(cross_arg * ns + (ns - 1), ns,
                                               dim=-1)
            best = torch.maximum(torch.maximum(self_c, adv_c), cross_c)
            bpt = torch.where(self_c == best, lab,
                              torch.where(adv_c == best, lab - 1, cross_bp))
        new = prune(best + state[:, t], beam_threshold, beam_width)
        valid = (t < lengths)[:, None]
        delta = torch.where(valid, new, delta)
        bp[:, t] = torch.where(valid, bpt, lab)
    scores, last = first_argmax(delta, dim=-1)
    return bp, last, scores


def fdt_viterbi_traceback(bp, last, lengths):
    """Follow ``bp`` back from ``last``: (B, T) int32 state-major paths.
    Frames ``t >= length - 1`` carry the final label."""
    B, T, _ = bp.shape
    end = lengths.to(bp.device).clamp(max=T) - 1
    paths = torch.empty((B, T), dtype=torch.int32, device=bp.device)
    cur = last
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            prev = torch.gather(bp[:, t + 1], 1, cur[:, None].long())[:, 0]
            cur = torch.where(t >= end, last, prev)
        else:
            cur = last
        paths[:, t] = cur
    return paths


def path_score(state, selfp, advp, crossp, paths, lengths, ns: int,
               boundaries: bool = True):
    """(B,) score of given state-major ``paths`` over the factored planes:
    the sum over valid frames of the (boundary-masked) state potential and,
    from frame 1, the potential of the transition taken (NEG_INF where it
    is illegal).  A decode's score is the score of its own path; two paths
    of near-equal score are both optimal within the fp32 tolerance."""
    B, T, Lp = state.shape
    lengths = lengths.to(state.device)
    state = _boundary_state(state, lengths, ns, boundaries)
    cur = paths.long()
    s = torch.gather(state, 2, cur[..., None])[..., 0]             # (B, T)
    prev, nxt = cur[:, :-1], cur[:, 1:]
    cross = crossp[:, 1:].flatten(2)                # (B, T-1, P*P)
    c = torch.gather(cross, 2, ((prev // ns) * (Lp // ns)
                                + nxt // ns)[..., None])[..., 0]
    if ns == 1:
        tr = c
    else:
        f = torch.gather(selfp[:, 1:], 2, nxt[..., None])[..., 0]
        a = torch.gather(advp[:, 1:], 2, prev[..., None])[..., 0]
        is_adv = (nxt == prev + 1) & (nxt % ns != 0)
        is_cross = (prev % ns == ns - 1) & (nxt % ns == 0)
        tr = torch.where(prev == nxt, f, torch.where(
            is_adv, a, torch.where(is_cross, c, NEG_INF)))
    t = torch.arange(T, device=state.device)
    valid = t[None, :] < lengths[:, None]
    return (torch.where(valid, s, 0.0).sum(1)
            + torch.where(valid[:, 1:], tr, 0.0).sum(1))


def fdt_viterbi(state, selfp, advp, crossp, lengths, ns: int,
                boundaries: bool = True, beam_width: Optional[int] = None,
                beam_threshold: Optional[float] = None):
    """Max-plus decode with traceback over the factored lattice.

    Returns (paths (B, T) int32 state-major expanded labels, scores (B,)).
    Beam options: None = exact; the initial frame is pruned too.
    """
    bp, last, scores = fdt_viterbi_forward(
        state, selfp, advp, crossp, lengths, ns, boundaries, beam_width,
        beam_threshold)
    return fdt_viterbi_traceback(bp, last, lengths), scores


# ---------------------------------------------------------------------------
# log semiring: the training criterion
# ---------------------------------------------------------------------------

def _clamp_row(labels_t, Lp: int, clamp_ns: int):
    """(B,) labels -> (B, L') additive clamp penalty (state-major)."""
    lane = torch.arange(Lp, device=labels_t.device)
    return torch.where(lane[None, :] // clamp_ns == labels_t[:, None].long(),
                       0.0, NEG_INF)


def _lse(x, dim: int):
    """Log-sum-exp with the reference's guards: the max is clamped at
    NEG_INF and the sum floored at 1e-35, so an all-dead slice gives a
    finite NEG_INF-sized value and no nan."""
    m = torch.clamp(x.amax(dim=dim, keepdim=True), min=NEG_INF)
    out = m + torch.log(torch.clamp(torch.exp(x - m).sum(dim=dim,
                                                          keepdim=True),
                                    min=1e-35))
    return out.squeeze(dim)


def _factored_update(alpha, f_t, a_t, c_t, ns: int):
    """One factored semiring matvec: alpha (B, L') -> (B, L') candidates
    (before adding the state plane)."""
    if ns == 1:
        return _lse(alpha[:, :, None] + c_t, dim=1)
    Lp = alpha.shape[-1]
    st = torch.arange(Lp, device=alpha.device) % ns
    self_c = alpha + f_t
    adv_c = torch.roll(alpha + a_t, 1, dims=-1)
    adv_c = torch.where(st > 0, adv_c, NEG_INF)
    crossed = _lse(alpha[:, ns - 1::ns, None] + c_t, dim=1)     # (B, P)
    cross_c = torch.where(st == 0, torch.repeat_interleave(crossed, ns, -1),
                          NEG_INF)
    return torch.logaddexp(self_c, torch.logaddexp(adv_c, cross_c))


def _dead_guard(z):
    """Zero the gradient of sequences whose lattice has no legal path
    (z == NEG_INF, e.g. a clamp made inconsistent by a mid-phone length
    cut): the 'gradient' there is a softmax over garbage.  The K2 kernel
    applies the same rule (its ``live`` gate)."""
    return torch.where(z > NEG_INF * 0.5, z, z.detach())


def fdt_logZ_pair(state, selfp, advp, crossp, labels, lengths, ns: int,
                  clamp_ns: int, boundaries: bool = True):
    """Free + clamped log-partitions over the factored lattice.

    All planes batched (B, T, ...), state-major expanded labels; ``labels``
    (B, T) int32 at ``clamp_ns`` granularity (ns = phone labels, 1 = state
    labels).  Returns (zf, zc): (B,) each, differentiable by autograd.
    """
    B, T, Lp = state.shape
    lengths = lengths.to(state.device)
    state = _boundary_state(state, lengths, ns, boundaries)
    af = state[:, 0]
    ac = state[:, 0] + _clamp_row(labels[:, 0], Lp, clamp_ns)
    for t in range(1, T):
        f_t = selfp[:, t] if ns > 1 else None
        a_t = advp[:, t] if ns > 1 else None
        c_t = crossp[:, t]
        s_t = state[:, t]
        cand_f = _factored_update(af, f_t, a_t, c_t, ns) + s_t
        cand_c = (_factored_update(ac, f_t, a_t, c_t, ns) + s_t
                  + _clamp_row(labels[:, t], Lp, clamp_ns))
        valid = (t < lengths)[:, None]
        af = torch.where(valid, cand_f, af)
        ac = torch.where(valid, cand_c, ac)
    return _dead_guard(_lse(af, -1)), _dead_guard(_lse(ac, -1))


def fdt_nll_dual(fmap_cfg, ns: int, params, feats, labels, lengths,
                 clamp_ns: Optional[int] = None, boundaries: bool = True,
                 grad_feats: bool = False):
    """Fused dual-lattice objective for frame-dependent transitions:
    per-sequence ``(nll, logZ, numerator)``.

    Dispatch by :func:`asr_craft_tpu_torch.kernels.use_kernel`: the K1/K2
    autograd Function (``kernels/fdt_train.fdt_nll_dual_wall``, which
    raises for what the kernels do not take, P > 128 among them) or, for a
    CPU tensor under ``auto`` and under ``torch``, :func:`fdt_logZ_pair`
    on the planes, differentiated by autograd.

    ``grad_feats``: when False, ``feats`` is detached on both backends, so
    no feature cotangent is formed; set it to differentiate through
    ``feats``.
    """
    if not grad_feats:
        feats = feats.detach()
    Lp = fmap_cfg.num_expanded
    clamp_ns = ns if clamp_ns is None else clamp_ns
    if kernels.use_kernel(feats):
        # imported here: kernels.fdt_train imports this module
        from asr_craft_tpu_torch.kernels.fdt_train import fdt_nll_dual_wall
        from asr_craft_tpu_torch.kernels.wall import build_wall
        Wall, u0, u1, dims = build_wall(params, fmap_cfg, ns)
        zf, zc = fdt_nll_dual_wall(
            Wall, feats, labels, lengths, u0=u0, u1=u1, ns=ns, P=dims["P"],
            clamp_ns=clamp_ns, boundaries=boundaries, grad_feats=grad_feats)
    else:
        planes = factored_planes(params, feats, Lp, ns,
                                 fmap_cfg.state_range, fmap_cfg.trans_range,
                                 fmap_cfg.use_state_bias)
        zf, zc = fdt_logZ_pair(*planes, labels, lengths, ns, clamp_ns,
                               boundaries)
    return zf - zc, zf, zc


def fdt_posteriors(state, selfp, advp, crossp, lengths, ns: int,
                   boundaries: bool = True):
    """(B, T, L') frame posteriors over the factored frame-dependent
    lattice: forward and backward factored loops, gamma = alpha + beta -
    logZ, zero at frames past each length."""
    B, T, Lp = state.shape
    lengths = lengths.to(state.device)
    state = _boundary_state(state, lengths, ns, boundaries)
    st = torch.arange(Lp, device=state.device) % ns
    alphas = [state[:, 0]]
    for t in range(1, T):
        f_t = selfp[:, t] if ns > 1 else None
        a_t = advp[:, t] if ns > 1 else None
        cand = _factored_update(alphas[-1], f_t, a_t, crossp[:, t], ns) \
            + state[:, t]
        alphas.append(torch.where((t < lengths)[:, None], cand, alphas[-1]))
    logZ = _lse(alphas[-1], -1)
    betas = [torch.zeros((B, Lp), dtype=state.dtype, device=state.device)]
    for t in range(T - 2, -1, -1):
        x = betas[0] + state[:, t + 1]                 # planes of frame t+1
        c_n = crossp[:, t + 1]
        if ns == 1:
            nb = _lse(x[:, None, :] + c_n, dim=2)
        else:
            self_c = x + selfp[:, t + 1]
            adv_c = torch.where(st < ns - 1,
                                torch.roll(x, -1, dims=-1) + advp[:, t + 1],
                                NEG_INF)
            crossed = _lse(x[:, None, 0::ns] + c_n, dim=2)      # (B, P)
            cross_c = torch.where(st == ns - 1,
                                  torch.repeat_interleave(crossed, ns, -1),
                                  NEG_INF)
            nb = torch.logaddexp(self_c, torch.logaddexp(adv_c, cross_c))
        # frames at/after length-1 keep beta = 0 (the init)
        betas.insert(0, torch.where((t + 1 < lengths)[:, None], nb,
                                    betas[0]))
    gamma = (torch.stack(alphas, 1) + torch.stack(betas, 1)
             - logZ[:, None, None])
    post = torch.exp(torch.clamp(gamma, max=0.0))
    valid = torch.arange(T, device=state.device)[None, :] < lengths[:, None]
    return torch.where(valid[..., None], post, 0.0)
