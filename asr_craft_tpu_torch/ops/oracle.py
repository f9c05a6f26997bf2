"""Pure-NumPy float64 oracles for every DP recursion.

The reference binaries cannot be run in this environment (empty mount —
SURVEY.md §0), so parity is defined against these independently-written
O(T*L^2) Python loops (SURVEY.md §4.2): the jnp scans, Pallas kernels, and
distributed paths are all held allclose (fp32) to this module, and this
module is itself held to brute-force path enumeration on tiny problems
(tests/oracle/test_enumeration.py).

Everything here is deliberately loop-based, float64, and dependency-free —
clarity over speed.
"""
from __future__ import annotations

import numpy as np

NEG_INF = -1e30


def _lse(xs):
    xs = np.asarray(xs, dtype=np.float64)
    m = max(xs.max(), NEG_INF)
    return m + np.log(np.sum(np.exp(xs - m)))


def _trans_at(trans, t):
    trans = np.asarray(trans, dtype=np.float64)
    return trans if trans.ndim == 2 else trans[t]


def forward_np(state, trans, length):
    """Alpha pass. Returns (alphas (length, L) float64, logZ)."""
    state = np.asarray(state, dtype=np.float64)
    L = state.shape[1]
    alphas = np.zeros((length, L))
    alphas[0] = state[0]
    for t in range(1, length):
        tr = _trans_at(trans, t)
        for l in range(L):
            alphas[t, l] = _lse(alphas[t - 1] + tr[:, l]) + state[t, l]
    return alphas, _lse(alphas[length - 1])


def backward_np(state, trans, length):
    """Beta pass. Returns betas (length, L) float64."""
    state = np.asarray(state, dtype=np.float64)
    L = state.shape[1]
    betas = np.zeros((length, L))
    for t in range(length - 2, -1, -1):
        tr = _trans_at(trans, t + 1)
        for l in range(L):
            betas[t, l] = _lse(tr[l, :] + state[t + 1] + betas[t + 1])
    return betas


def posteriors_np(state, trans, length):
    alphas, logZ = forward_np(state, trans, length)
    betas = backward_np(state, trans, length)
    return np.exp(alphas + betas - logZ)


def expected_counts_np(state, trans, length):
    """Expected state occupancy (length, L) and transition counts (L, L).

    The reference accumulates these in ``CRF_StateNode::computeExpF``; here
    they exist only to verify the jax.grad identity
    d logZ / d state[t,l] = gamma[t,l] and d logZ / d trans[p,l] = sum_t
    xi[t,p,l] (tests/oracle/test_grad_identity.py).
    """
    state = np.asarray(state, dtype=np.float64)
    L = state.shape[1]
    alphas, logZ = forward_np(state, trans, length)
    betas = backward_np(state, trans, length)
    gamma = np.exp(alphas + betas - logZ)
    xi = np.zeros((L, L))
    for t in range(1, length):
        tr = _trans_at(trans, t)
        for p in range(L):
            for l in range(L):
                xi[p, l] += np.exp(
                    alphas[t - 1, p] + tr[p, l] + state[t, l]
                    + betas[t, l] - logZ
                )
    return gamma, xi


def viterbi_np(state, trans, length):
    """Exact Viterbi. Returns (path list[int], score float)."""
    state = np.asarray(state, dtype=np.float64)
    L = state.shape[1]
    delta = state[0].copy()
    bps = np.zeros((length, L), dtype=np.int64)
    for t in range(1, length):
        tr = _trans_at(trans, t)
        new = np.zeros(L)
        for l in range(L):
            cand = delta + tr[:, l]
            bps[t, l] = int(np.argmax(cand))
            new[l] = cand[bps[t, l]] + state[t, l]
        delta = new
    last = int(np.argmax(delta))
    score = float(delta[last])
    path = [last]
    for t in range(length - 1, 0, -1):
        path.append(int(bps[t, path[-1]]))
    return path[::-1], score


def path_score_np(state, trans, labels, length):
    state = np.asarray(state, dtype=np.float64)
    s = state[0, labels[0]]
    for t in range(1, length):
        tr = _trans_at(trans, t)
        s += tr[labels[t - 1], labels[t]] + state[t, labels[t]]
    return float(s)


def enumerate_logZ_np(state, trans, length):
    """Brute-force logZ by summing over all L**length paths."""
    L = np.asarray(state).shape[1]
    import itertools
    scores = [path_score_np(state, trans, list(p), length)
              for p in itertools.product(range(L), repeat=length)]
    return _lse(scores)


def enumerate_viterbi_np(state, trans, length):
    """Brute-force best path by enumeration."""
    L = np.asarray(state).shape[1]
    import itertools
    best, best_p = -np.inf, None
    for p in itertools.product(range(L), repeat=length):
        s = path_score_np(state, trans, list(p), length)
        if s > best:
            best, best_p = s, list(p)
    return best_p, best


# --- Segmental (SCRF) oracles — SURVEY.md §3.4 --------------------------------

def segmental_forward_np(seg_score, trans, length, max_dur):
    """SCRF alpha pass over segmentations.

    ``seg_score[t, d, l]``: log score of a segment of label ``l`` covering
    frames ``[t - d, t]`` inclusive (duration ``d + 1``, so ``d`` indexes
    duration-1 and ``d <= min(t, max_dur - 1)``).  ``trans[p, l]`` scores
    adjacent segment labels.  Returns logZ over all (segmentation, labeling)
    pairs of the first ``length`` frames.
    """
    seg_score = np.asarray(seg_score, dtype=np.float64)
    L = seg_score.shape[2]
    # alpha[t, l]: log sum of scores of all segmentations of frames [0, t]
    # whose last segment has label l.
    alpha = np.full((length, L), NEG_INF)
    for t in range(length):
        for l in range(L):
            acc = []
            for d in range(min(t + 1, max_dur)):
                start = t - d
                sc = seg_score[t, d, l]
                if start == 0:
                    acc.append(sc)
                else:
                    tr = _trans_at(trans, start)
                    for p in range(L):
                        acc.append(alpha[start - 1, p] + tr[p, l] + sc)
            alpha[t, l] = _lse(acc) if acc else NEG_INF
    return alpha, _lse(alpha[length - 1])


def segmental_viterbi_np(seg_score, trans, length, max_dur):
    """Best (segmentation, labeling). Returns (segments, score) where
    segments is a list of (start, end_inclusive, label)."""
    seg_score = np.asarray(seg_score, dtype=np.float64)
    L = seg_score.shape[2]
    delta = np.full((length, L), NEG_INF)
    back = {}  # (t, l) -> (start, prev_label or None)
    for t in range(length):
        for l in range(L):
            for d in range(min(t + 1, max_dur)):
                start = t - d
                sc = seg_score[t, d, l]
                if start == 0:
                    if sc > delta[t, l]:
                        delta[t, l] = sc
                        back[(t, l)] = (start, None)
                else:
                    tr = _trans_at(trans, start)
                    for p in range(L):
                        s = delta[start - 1, p] + tr[p, l] + sc
                        if s > delta[t, l]:
                            delta[t, l] = s
                            back[(t, l)] = (start, p)
    l = int(np.argmax(delta[length - 1]))
    score = float(delta[length - 1, l])
    segs, t = [], length - 1
    while True:
        start, p = back[(t, l)]
        segs.append((start, t, l))
        if p is None:
            break
        t, l = start - 1, p
    return segs[::-1], score


def enumerate_segmental_logZ_np(seg_score, trans, length, max_dur):
    """Brute-force SCRF logZ: enumerate all segmentations x labelings."""
    seg_score = np.asarray(seg_score, dtype=np.float64)
    L = seg_score.shape[2]
    import itertools

    def segmentations(n):
        # yield lists of (start, end_inclusive) covering [0, n-1]
        if n == 0:
            yield []
            return
        for d in range(1, min(n, max_dur) + 1):
            for rest in segmentations(n - d):
                yield rest + [(n - d, n - 1)]

    scores = []
    for segs in segmentations(length):
        for labs in itertools.product(range(L), repeat=len(segs)):
            s = 0.0
            for i, ((a, b), l) in enumerate(zip(segs, labs)):
                s += seg_score[b, b - a, l]
                if i > 0:
                    s += _trans_at(trans, a)[labs[i - 1], l]
            scores.append(s)
    return _lse(scores)
