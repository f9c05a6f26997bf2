"""Plain reference of the segmental CRF, in float64: segment scores, the
best segmentation's score, and the score of a given segmentation.

The model, as the segmental CRF of He and Fosler-Lussier defines it.  A
segment of label ``l`` over frames ``[s, e]`` (``e - s < Dmax``) scores the
mean over its frames of ``x_t @ w_frame[:, l]`` plus ``b_dur[e - s, l]`` and
``b_seg[l]``; consecutive segments ``l' -> l`` add ``b_trans[l', l]``.  A
segmentation covers a row's frames exactly, the first segment starting at
frame 0 and the last ending at the row's last frame.

Imports nothing but torch; the frame sums are prefix sums in float64.
"""
from __future__ import annotations

import torch

NEG = -1e30
DT = torch.float64


def _prefix(params: dict, feats):
    """(B, T + 1, L) prefix sums of the frame scores."""
    frame = feats.to(DT) @ params["w_frame"].to(DT)
    zero = torch.zeros_like(frame[:, :1])
    return torch.cat([zero, frame.cumsum(1)], 1)


def _bias(params: dict, Dmax: int, L: int, device):
    bias = torch.zeros((Dmax, L), dtype=DT, device=device)
    if "b_dur" in params:
        bias = bias + params["b_dur"].to(DT)
    if "b_seg" in params:
        bias = bias + params["b_seg"].to(DT)
    return bias


def best_scores(params: dict, feats, lengths, Dmax: int):
    """(B,) the best segmentation's score (a max-plus loop over frames,
    every duration of every frame)."""
    cs = _prefix(params, feats)
    B, T1, L = cs.shape
    T = T1 - 1
    dev = cs.device
    bias = _bias(params, Dmax, L, dev)
    trans = params["b_trans"].to(DT)
    # best[:, t + 1] = the best score of frames [0, t]; best[:, 0] = 0
    best = torch.full((B, T + 1, L), NEG, dtype=DT, device=dev)
    msg = torch.full((B, T + 1, L), NEG, dtype=DT, device=dev)
    msg[:, 0] = 0.0               # a segment from frame 0 has no predecessor
    d = torch.arange(Dmax, device=dev)
    for t in range(T):
        s = t - d                                       # starts (Dmax,)
        ok = s >= 0
        sc = s.clamp(min=0)
        seg = (cs[:, t + 1, None, :] - cs[:, sc]) / (d + 1.0)[None, :, None]
        cand = msg[:, sc] + seg + bias                  # (B, Dmax, L)
        cand = torch.where(ok[None, :, None], cand, NEG)
        best[:, t + 1] = cand.amax(1)
        if t + 1 <= T - 1:
            msg[:, t + 1] = (best[:, t + 1, :, None] + trans).amax(1)
    idx = lengths.to(dev).long().clamp(min=1)
    return best[torch.arange(B, device=dev), idx].amax(-1)


def segmentation_scores(params: dict, feats, starts, labels, n_segs,
                        lengths, Dmax: int):
    """(B,) the score of given segmentations (``starts``, ``labels`` (B, K),
    the first ``n_segs`` entries live); NEG is added where one does not
    tile the row's frames in segments of 1 to ``Dmax`` frames."""
    cs = _prefix(params, feats)
    B, T1, L = cs.shape
    dev = cs.device
    bias = _bias(params, Dmax, L, dev)
    trans = params["b_trans"].to(DT)
    starts = starts.to(dev).long()
    labels = labels.to(dev).long()
    n = n_segs.to(dev).long()
    lengths = lengths.to(dev).long()
    K = starts.shape[1]
    k = torch.arange(K, device=dev)
    live = k[None, :] < n[:, None]
    nxt = torch.cat([starts[:, 1:], starts[:, -1:]], 1)
    ends = torch.where(k[None, :] == (n - 1)[:, None], lengths[:, None] - 1,
                       nxt - 1)
    dur = ends - starts + 1
    lab = labels.clamp(0, L - 1)
    s_c = starts.clamp(0, T1 - 1)
    e_c = (ends + 1).clamp(0, T1 - 1)
    sums = (cs.gather(1, e_c[..., None].expand(-1, -1, L))
            - cs.gather(1, s_c[..., None].expand(-1, -1, L)))
    seg = sums.gather(2, lab[..., None])[..., 0] / dur.clamp(min=1)
    seg = seg + bias[(dur - 1).clamp(0, Dmax - 1), lab]
    tr = trans[lab[:, :-1], lab[:, 1:]]
    score = (torch.where(live, seg, 0.0).sum(1)
             + torch.where(live[:, 1:], tr, 0.0).sum(1))
    valid = ((dur >= 1) & (dur <= Dmax) & (lab == labels.to(dev))) | ~live
    valid = valid.all(1) & (starts[:, 0] == 0) & (n >= 1) & (n <= lengths)
    return score + torch.where(valid, 0.0, NEG)
