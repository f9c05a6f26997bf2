"""Plain reference of the segmental CRF's training loss, in float64: the
log-partition by its definition, the gold segmentation's score from the
frame labels' runs, and the mean negative log-likelihood per real frame,
whose gradients autograd takes.

The model, as the segmental CRF of He and Fosler-Lussier defines it (the
same as ``scrf.py``'s).  A segment of label ``l`` over frames ``[s, e]``
(``e - s < Dmax``) scores the mean over its frames of ``x_t @ w_frame[:,
l]`` plus ``b_dur[e - s, l]`` and ``b_seg[l]``; consecutive segments ``l'
-> l`` add ``b_trans[l', l]``.  A segmentation covers a row's frames
exactly.  The log-partition sums over every segmentation:

    alpha[t, l] = log sum_{d, l'} exp(msg[t - d, l'] + seg[t, d, l])
    msg[s, l]   = log sum_{l'} exp(alpha[s - 1, l'] + b_trans[l', l]),
                  msg[0, l] = 0 (a segment from frame 0 has no predecessor)

with ``seg[t, d, l]`` the score of the segment of label ``l`` over frames
``[t - d, t]``; ``logZ = log sum_l exp(alpha[length - 1, l])``.  The gold
segmentation is the frame labels' maximal runs; a run longer than Dmax
scores NEG (no segmentation holds it).  The loss is the sum over the rows
with frames of ``logZ - gold``, over the real frames.

Imports nothing but torch.  The recursion runs over blocks of rows, so that
its autograd graph (some Dmax x L floats a row and frame) fits the
device's memory at the benchmark's shapes; each block's share of the loss
is differentiated on its own and the gradients summed.
"""
from __future__ import annotations

import torch

NEG = -1e30
DT = torch.float64
BLOCK_BYTES = 4e9           # the autograd graph a block of rows may hold


def _bias(params: dict, Dmax: int, L: int, device):
    bias = torch.zeros((Dmax, L), dtype=DT, device=device)
    if "b_dur" in params:
        bias = bias + params["b_dur"].to(DT)
    if "b_seg" in params:
        bias = bias + params["b_seg"].to(DT)
    return bias


def _prefix(params: dict, feats):
    """(B, T + 1, L) prefix sums of the frame scores, in float64."""
    frame = feats.to(DT) @ params["w_frame"].to(DT)
    zero = torch.zeros_like(frame[:, :1])
    return torch.cat([zero, frame.cumsum(1)], 1)


def log_partition(params: dict, feats, lengths, Dmax: int):
    """(B,) logZ: the alpha recursion over end frames t, durations d and
    the previous segment's label."""
    cs = _prefix(params, feats)
    B, T1, L = cs.shape
    T = T1 - 1
    dev = cs.device
    bias = _bias(params, Dmax, L, dev)
    trans = params["b_trans"].to(DT)
    msgs = [torch.zeros((B, L), dtype=DT, device=dev)]    # msg[0] = 0
    alphas = []
    for t in range(T):
        n = min(t + 1, Dmax)                  # durations d < n start >= 0
        starts = [t - d for d in range(n)]
        inv = 1.0 / torch.arange(1, n + 1, dtype=DT, device=dev)
        seg = ((cs[:, t + 1, None, :] - cs[:, starts]) * inv[None, :, None]
               + bias[:n])                              # (B, n, L)
        msg = torch.stack([msgs[s] for s in starts], 1)
        alpha = torch.logsumexp(msg + seg, 1)
        alphas.append(alpha)
        msgs.append(torch.logsumexp(alpha[:, :, None] + trans, 1))
    alphas = torch.stack(alphas, 1)                     # (B, T, L)
    last = (lengths.to(dev).long() - 1).clamp(min=0)
    return torch.logsumexp(alphas[torch.arange(B, device=dev), last], -1)


def gold_scores(params: dict, feats, labels, lengths, Dmax: int):
    """(B,) the score of the segmentation into the frame labels' maximal
    runs; NEG is added for each run longer than Dmax."""
    cs = _prefix(params, feats)
    B, T1, L = cs.shape
    dev = cs.device
    bias = _bias(params, Dmax, L, dev)
    trans = params["b_trans"].to(DT)
    lab = labels.to(dev).long()
    n = lengths.to(dev).long()[:, None]
    t = torch.arange(T1 - 1, device=dev)[None, :]
    valid = t < n
    prev = torch.cat([lab[:, :1], lab[:, :-1]], 1)
    first = valid & ((t == 0) | (lab != prev))          # a run starts
    nxt = torch.cat([first[:, 1:], torch.ones_like(first[:, :1])], 1)
    last = valid & ((t == n - 1) | nxt)                 # a run ends
    start = torch.where(first, t, 0).cummax(1).values
    dur = t - start + 1
    total = cs[:, 1:] - cs.gather(1, start[..., None].expand(-1, -1, L))
    pooled = total.gather(2, lab[..., None])[..., 0] / dur
    fits = dur <= Dmax
    seg = pooled + bias[(dur - 1).clamp(max=Dmax - 1), lab]
    seg = torch.where(fits, seg, NEG)
    tr = trans[prev, lab]
    return (torch.where(last, seg, 0.0).sum(1)
            + torch.where(first & (t > 0), tr, 0.0).sum(1))


def loss_and_grads(params: dict, feats, labels, lengths, Dmax: int):
    """``(loss, grads)``: the mean negative log-likelihood per real frame of
    the batch and its gradient with respect to each parameter (float64),
    the recursion run over blocks of rows."""
    p = {k: v.detach().to(DT) for k, v in params.items()}
    B, T = labels.shape
    L = p["b_trans"].shape[0]
    frames = int(lengths.sum())
    rows = max(1, min(B, int(BLOCK_BYTES // (8 * 8 * T * Dmax * L))))
    loss = 0.0
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    for a in range(0, B, rows):
        n = lengths[a:a + rows]
        if int(n.max()) <= 0:
            continue
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        f = feats[a:a + rows]
        nll = torch.where(n.to(f.device) > 0,
                          log_partition(leaves, f, n, Dmax)
                          - gold_scores(leaves, f, labels[a:a + rows], n,
                                        Dmax), 0.0).sum() / max(frames, 1)
        got = torch.autograd.grad(nll, list(leaves.values()),
                                  allow_unused=True)
        for k, g in zip(leaves, got):
            if g is not None:
                grads[k] += g
        loss += float(nll.detach())
    return loss, grads
