"""Plain reference of the linear-chain CRF over an n-state left-to-right
phone topology, in float64: potentials, the training criterion, its
gradient (autograd through a loop over frames) and path scores.

The model, as the published toolkit defines it.  Labels are expanded states
``l = p * ns + s`` (phone ``p``, state ``s``).  A frame's state potential is
``x_t[state dims] @ w_state + b_state``.  A transition ``i -> j`` into frame
``t`` scores ``x_t[trans dims] @ w_trans[:, i, j] + b_trans[i, j]`` with
frame-dependent transitions, else ``b_trans[i, j]``.  With ``ns > 1`` only
three kinds of transition exist: ``l -> l``, ``l -> l + 1`` inside a phone,
and a phone's last state to any phone's first; a path starts in a first
state and ends, at the row's last frame, in a last state.  ``ns == 1``
allows every transition.  The loss of a row is ``log Z - log Z_clamp``, the
clamped lattice keeping at each frame the states of its phone label; the
batch's loss is the rows' sum over their frames' sum.

Imports nothing but torch.  Everything is computed in float64 from the
weights and frames it is given: no packed parameter, plane or table of the
program.
"""
from __future__ import annotations

import torch

NEG = -1e30
DT = torch.float64


def _edges(params: dict, L: int, ns: int):
    """The legal transitions' weights: ``(w, b)`` each a dict of ``self``
    (L), ``adv`` (L) and ``cross`` (P, P) columns (``w`` None without
    frame-dependent transitions).  ``adv`` of a phone's last state is the
    semiring zero."""
    P = L // ns
    b = params["b_trans"].to(DT)
    w = params.get("w_trans")
    w = None if w is None else w.to(DT)
    lab = torch.arange(L, device=b.device)
    last = torch.arange(P, device=b.device) * ns + (ns - 1)
    first = torch.arange(P, device=b.device) * ns
    if ns == 1:
        return ({"cross": w} if w is not None else None), {"cross": b}
    nxt = torch.clamp(lab + 1, max=L - 1)
    has_adv = (lab % ns) < ns - 1
    bb = {"self": b[lab, lab],
          "adv": torch.where(has_adv, b[lab, nxt], NEG),
          "cross": b[last][:, first]}
    if w is None:
        return None, bb
    ww = {"self": w[:, lab, lab], "adv": w[:, lab, nxt] * has_adv,
          "cross": w[:, last][:, :, first]}
    return ww, bb


def potentials(params: dict, feats, ns: int, state_range=None,
               trans_range=(0, 0)):
    """``(state (B, T, L), self, adv (B, T, L) or (L,), cross (B, T, P, P)
    or (P, P))`` in float64; ``self`` and ``adv`` None for ``ns == 1``."""
    x = feats.to(DT)
    D = x.shape[-1]
    s0, s1 = state_range or (0, D)
    state = x[..., s0:s1] @ params["w_state"].to(DT)
    if "b_state" in params:
        state = state + params["b_state"].to(DT)
    L = state.shape[-1]
    ww, bb = _edges(params, L, ns)
    out = {}
    for k, b in bb.items():
        if ww is None:
            out[k] = b
        else:
            xt = x[..., trans_range[0]:trans_range[1]]
            w = ww[k]
            prod = (xt @ w.reshape(w.shape[0], -1)).reshape(
                *xt.shape[:-1], *w.shape[1:])
            out[k] = prod + b
    if ns > 1:
        out["adv"] = torch.where((torch.arange(L, device=state.device) % ns)
                                 < ns - 1, out["adv"], NEG)
    return state, out.get("self"), out.get("adv"), out["cross"]


def _frame(x, t, shared: bool):
    """Frame ``t`` of a (B, T, ...) plane, or the shared plane itself."""
    return x if shared else x[:, t]


def _boundaries(L: int, ns: int, device):
    st = torch.arange(L, device=device) % ns
    start = torch.where(st == 0, 0.0, NEG).to(DT)
    end = torch.where(st == ns - 1, 0.0, NEG).to(DT)
    return start, end


def _step(prev, self_t, adv_t, cross_t, ns: int, reduce):
    """One semiring matvec over the legal transitions: ``prev (..., L)``
    to the candidates of each destination (before its state potential).
    ``reduce(x, dim)`` is logsumexp or max."""
    L = prev.shape[-1]
    if ns == 1:
        return reduce(prev[..., :, None] + cross_t, -2)
    st = torch.arange(L, device=prev.device) % ns
    self_c = prev + self_t
    adv_c = torch.roll(prev + adv_t, 1, dims=-1)
    adv_c = torch.where(st > 0, adv_c, NEG)
    crossed = reduce(prev[..., ns - 1::ns, None] + cross_t, -2)   # (.., P)
    cross_c = torch.where(st == 0,
                          torch.repeat_interleave(crossed, ns, dim=-1), NEG)
    return reduce(torch.stack([self_c, adv_c, cross_c]), 0)


def _lse(x, dim):
    return torch.logsumexp(x, dim)


def _max(x, dim):
    return x.amax(dim)


def log_partitions(state, self_p, adv_p, cross_p, lengths, ns: int,
                   clamp=None):
    """``log Z (B,)`` of the lattice, and of the clamped one where
    ``clamp (B, T, L)`` (0 or NEG) is given: both lattices in one loop,
    stacked on a leading axis."""
    B, T, L = state.shape
    shared = cross_p.dim() == 2
    start, end = _boundaries(L, ns, state.device)
    if ns == 1:
        start, end = torch.zeros_like(start), torch.zeros_like(end)
    lat = [torch.zeros_like(state)] + ([clamp.to(DT)] if clamp is not None
                                       else [])
    s = torch.stack([state + c for c in lat])                  # (K, B, T, L)
    alpha = s[:, :, 0] + start
    lengths = lengths.to(state.device)
    for t in range(1, T):
        f = None if self_p is None else _frame(self_p, t, shared)
        a = None if adv_p is None else _frame(adv_p, t, shared)
        c = _frame(cross_p, t, shared)
        cand = _step(alpha, f, a, c, ns, _lse) + s[:, :, t]
        alpha = torch.where((t < lengths)[None, :, None], cand, alpha)
    return torch.logsumexp(alpha + end, -1)                    # (K, B)


def clamp_of(labels, L: int, ns: int):
    """(B, T, L) 0 where a state belongs to the frame's phone, else NEG."""
    lab = torch.arange(L, device=labels.device) // ns
    return torch.where(lab == labels[..., None].long(), 0.0, NEG).to(DT)


def loss(params: dict, feats, labels, lengths, ns: int, state_range=None,
         trans_range=(0, 0)):
    """``(loss, nll (B,), frames)``: the batch's summed NLL over its
    frames' sum, differentiable in ``params``."""
    planes = potentials(params, feats, ns, state_range, trans_range)
    L = planes[0].shape[-1]
    z = log_partitions(*planes, lengths, ns,
                       clamp=clamp_of(labels, L, ns))
    live = lengths.to(z.device) > 0
    nll = torch.where(live, z[0] - z[1], 0.0)
    frames = lengths.to(torch.int64).sum().clamp(min=1)
    return nll.sum(), nll, frames


def best_scores(params: dict, feats, lengths, ns: int, state_range=None,
                trans_range=(0, 0)):
    """(B,) the best path's score (max-plus)."""
    planes = potentials(params, feats, ns, state_range, trans_range)
    state, self_p, adv_p, cross_p = planes
    B, T, L = state.shape
    shared = cross_p.dim() == 2
    start, end = _boundaries(L, ns, state.device)
    if ns == 1:
        start, end = torch.zeros_like(start), torch.zeros_like(end)
    alpha = state[:, 0] + start
    lengths = lengths.to(state.device)
    for t in range(1, T):
        f = None if self_p is None else _frame(self_p, t, shared)
        a = None if adv_p is None else _frame(adv_p, t, shared)
        cand = _step(alpha, f, a, _frame(cross_p, t, shared), ns, _max) \
            + state[:, t]
        alpha = torch.where((t < lengths)[:, None], cand, alpha)
    return (alpha + end).amax(-1)


def path_scores(params: dict, feats, paths, lengths, ns: int,
                state_range=None, trans_range=(0, 0)):
    """(B,) the score of given state paths (B, T) over each row's frames;
    an illegal transition, start or end adds NEG."""
    state, self_p, adv_p, cross_p = potentials(params, feats, ns,
                                               state_range, trans_range)
    B, T, L = state.shape
    P = L // ns
    cur = paths.to(state.device).long().clamp(0, L - 1)
    lengths = lengths.to(state.device).long()
    valid = torch.arange(T, device=state.device)[None, :] < lengths[:, None]
    s = torch.gather(state, 2, cur[..., None])[..., 0]
    prev, nxt = cur[:, :-1], cur[:, 1:]
    if cross_p.dim() == 2:
        cross = cross_p.reshape(1, 1, P * P).expand(B, T - 1, P * P)
    else:
        cross = cross_p[:, 1:].reshape(B, T - 1, P * P)
    c = torch.gather(cross, 2, ((prev // ns) * P + nxt // ns)[..., None])[
        ..., 0]
    if ns == 1:
        tr = c
    else:
        def plane(x, idx):
            if x.dim() == 1:
                return x[idx]
            return torch.gather(x[:, 1:], 2, idx[..., None])[..., 0]
        f = plane(self_p, nxt)
        a = plane(adv_p, prev)
        is_adv = (nxt == prev + 1) & (nxt % ns != 0)
        is_cross = (prev % ns == ns - 1) & (nxt % ns == 0)
        tr = torch.where(prev == nxt, f, torch.where(
            is_adv, a, torch.where(is_cross, c, torch.full_like(c, NEG))))
    score = (torch.where(valid, s, 0.0).sum(1)
             + torch.where(valid[:, 1:], tr, 0.0).sum(1))
    if ns > 1:
        first_ok = cur[:, 0] % ns == 0
        end_idx = (lengths - 1).clamp(min=0)
        last_ok = cur.gather(1, end_idx[:, None])[:, 0] % ns == ns - 1
        score = score + torch.where(first_ok & last_ok, 0.0, NEG)
    return score
