"""The partition of K7's and K8's frame (``csrc/viterbi.cu``
``vit_dense_fwd_kernel``, ``vit_nstate_fwd_kernel``: the recursion frame of
the forward-backward kernels and K12, in the max-plus semiring with the
argmax kept), modelled in plain PyTorch on the CPU and held BIT FOR BIT to
the plain version ``ops/viterbi.viterbi_forward``.

A group of four lanes owns a destination (K7) or a phone (K8).  Lane ``g``
holds the contiguous quarter ``[4 QV g, 4 QV (g + 1))`` of the weights that
reach it, padded with ``-inf`` (K7: the column of trans; K8: the cross
column ``w_cross[:, q]``), takes the first argmax over its ascending quarter
of the pruned row and the group merges the four by ``take_better`` in the
shuffles' butterfly order (xor 1, then xor 2).  The frame shares one row,
the raw (unpruned) new scores; each lane applies the beam on read against
the frame's cut: ``max - thr`` for the threshold, the ``bw``-th largest of
the thresholded row for the beam width (as each warp takes it: a count of
the values above each value on short rows, a radix select on the floats'
order keys, two bits a round, on longer ones), a value surviving iff it is
``>=`` the larger of the two.  K8 takes the cross over the phones'
last-state row, self and advance inside the phone, and re-scans a dead
destination's dense column, lane ``g`` taking its contiguous quarter of the
row padded to ``16 QVr`` (``QVr`` odd) against a destination-major copy of
trans.

Also the host's choice of layout by width (``kernels.viterbi.dense_frame``,
``nstate_frame``).
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch.kernels import viterbi as KV
from asr_craft_tpu_torch.models.topology import Topology
from asr_craft_tpu_torch.ops import viterbi as V
from asr_craft_tpu_torch.ops.semiring import NEG_INF

GROUP = 4
DEAD_FLOOR = np.float32(0.5) * np.float32(NEG_INF)
BIG = 2 ** 31 - 1
MODES = {"exact": (None, None), "threshold": (2.0, None),
         "topk": (None, 4), "both": (1.0, 3), "top1": (None, 1)}


def _take_better(a, b):
    """The larger value, then the lower index, elementwise on (v, i)."""
    (v, i), (v2, i2) = a, b
    take = (v2 > v) | ((v2 == v) & (i2 < i))
    return torch.where(take, v2, v), torch.where(take, i2, i)


def _group(x):
    """The shuffles' butterfly over the four lanes of x[g]: xor 1, then 2;
    every lane ends with the same pair."""
    x = [_take_better(x[g], x[g ^ 1]) for g in range(GROUP)]
    x = [_take_better(x[g], x[g ^ 2]) for g in range(GROUP)]
    assert all(torch.equal(p[0], x[0][0]) and torch.equal(p[1], x[0][1])
               for p in x)
    return x[0]


def _lane_first(sums, idx):
    """A lane's first argmax over its predecessors (last axis, ascending):
    strict '>' keeps the first; -inf everywhere gives (-inf, BIG)."""
    best = torch.full(sums.shape[:-1], -np.inf)
    frm = torch.full(sums.shape[:-1], BIG, dtype=torch.int64)
    for k in range(sums.shape[-1]):
        take = sums[..., k] > best
        best = torch.where(take, sums[..., k], best)
        frm = torch.where(take, idx[k], frm)
    return best, frm


def _quarter_argmax(x, F):
    """The group's first argmax of x[p] + F[d, p] over the lanes'
    contiguous quarters of the padded axis: x (B, Lq), F (D, Lq)."""
    Lq = F.shape[-1]
    n = Lq // GROUP
    sums = x[:, None, :] + F[None]                       # (B, D, Lq)
    lanes = [_lane_first(sums[..., g * n:(g + 1) * n],
                         torch.arange(g * n, (g + 1) * n))
             for g in range(GROUP)]
    return _group(lanes)


def _padded(x, n, pad):
    out = torch.full(x.shape[:-1] + (n,), pad, dtype=x.dtype)
    out[..., :x.shape[-1]] = x
    return out


def _ukey(v):
    """The floats' order keys as unsigned integers (int64 here)."""
    b = v.view(torch.int32).to(torch.int64)
    key = torch.where(b >= 0, b, b ^ 0x7FFFFFFF)
    return (key + 2 ** 31) & 0xFFFFFFFF


def _kth_count(x, bw):
    """The bw-th largest of x (B, L) as a warp takes it from short rows:
    the smallest value with fewer than bw values strictly greater."""
    above = (x[:, None, :] > x[:, :, None]).sum(-1)        # (B, L)
    return torch.where(above < bw, x, np.inf).amin(-1)


def _kth_radix(x, bw):
    """The bw-th largest of x (B, L) as a warp takes it from longer rows: a
    radix select, two bits a round from the top, counting the keys with
    the prefix and a digit >= 1, >= 2 and == 3."""
    keys = _ukey(x)
    prefix = torch.zeros(x.shape[0], dtype=torch.int64)
    hi = 0
    k = torch.full((x.shape[0],), bw, dtype=torch.int64)
    for s in range(30, -1, -2):
        match = (keys & hi) == prefix[:, None]
        digit = (keys >> s) & 3
        n1, n2, n3 = (((digit >= d) & match).sum(-1) for d in (1, 2, 3))
        d = torch.where(n3 >= k, 3, torch.where(
            n2 >= k, 2, torch.where(n1 >= k, 1, 0)))
        k = k - torch.where(d == 3, 0, torch.where(
            d == 2, n3, torch.where(d == 1, n2, n1)))
        prefix = prefix | (d << s)
        hi |= 3 << s
    key = (prefix - 2 ** 31).to(torch.int32)
    b = torch.where(key >= 0, key, key ^ 0x7FFFFFFF)
    return b.view(torch.float32)


def _kth_largest(x, bw, nk):
    """The kernels' select: counting while a lane holds at most 3 of the
    row's values (``nk``), the radix select beyond."""
    return _kth_count(x, bw) if nk <= 3 else _kth_radix(x, bw)


def _cut(raw, L, thr, bw, nk):
    """The frame's cut of raw rows (B, >= L): -inf with no beam; ``nk``
    the row's values a lane holds."""
    row = raw[:, :L]
    cut = torch.full((raw.shape[0],), -np.inf)
    if thr is not None:
        cut = torch.sub(row.amax(-1), np.float32(thr))
    if bw is not None and bw < L:
        t1 = torch.where(row >= cut[:, None], row, NEG_INF)
        cut = torch.maximum(cut, _kth_largest(t1, bw, nk))
    return cut


def _pruned(x, cut):
    return torch.where(x >= cut[:, None], x, NEG_INF)


def _final(raw, L, cut):
    """The first argmax of the pruned last row, by one warp: lane k takes
    l = k, k + 32, ..., then a butterfly (any order gives it)."""
    row = _pruned(raw[:, :L], cut)
    v, i = _lane_first(row, torch.arange(L))
    return v, i.to(torch.int32)


def dense_model(state, trans, lengths, thr, bw):
    """K7's frame: (bp, last, scores)."""
    B, T, L = state.shape
    qv, _ = KV.dense_frame(L)
    Lq, nk = 16 * qv, (qv + 1) // 2
    F = _padded(trans.T, Lq, -np.inf)                   # F[l, p] = trans[p, l]
    bp = torch.arange(L, dtype=torch.int32).repeat(B, T, 1)
    raw = _padded(state[:, 0], Lq, -np.inf)
    cut = _cut(raw, L, thr, bw, nk)
    for t in range(1, T):
        x = _pruned(raw, cut)
        best, frm = _quarter_argmax(x, F)
        new = _padded(best + state[:, t], Lq, -np.inf)
        live = t < lengths
        raw = torch.where(live[:, None], new, raw)
        cut = torch.where(live, _cut(raw, L, thr, bw, nk), cut)
        bp[:, t] = torch.where(live[:, None], frm.to(torch.int32), bp[:, t])
    scores, last = _final(raw, L, cut)
    return bp, last, scores


def nstate_model(state, trans, lengths, ns, thr, bw):
    """K8's frame: (bp, last, scores, dead), ``dead`` the re-scans taken."""
    B, T, L = state.shape
    P = L // ns
    qv = KV.nstate_frame(P, ns)
    Pq, nk = 16 * qv, 2 * qv * -(-ns // GROUP)
    w_self, w_adv, w_cross = KV.factored_weights(trans, P, ns)
    W = _padded(w_cross.T, Pq, -np.inf)                 # W[q, q'] (-inf pads)
    Lr = 16 * (-(-L // 16) | 1)                         # the row, QVr odd
    F = _padded(trans.T, Lr, -np.inf)                   # F[l, p] = trans[p, l]
    lab = torch.arange(L)
    s, q = lab % ns, lab // ns
    bp = torch.arange(L, dtype=torch.int32).repeat(B, T, 1)
    raw = state[:, 0].clone()
    cut = _cut(raw, L, thr, bw, nk)
    dead_total = 0
    for t in range(1, T):
        dp = _pruned(raw, cut)
        # cross into each phone over the last-state row, pads -inf
        last = _pruned(_padded(raw[:, ns - 1::ns], Pq, -np.inf), cut)
        cm, ca = _quarter_argmax(last, W)               # (B, P)
        cm, ca = cm[:, q], ca[:, q]
        self_c = dp + w_self
        adv_c = torch.cat([torch.full((B, 1), NEG_INF), dp[:, :-1]], 1) \
            + w_adv
        cross_wins = (cm > self_c) | ((cm == self_c) & (ca < q))
        first = torch.where(cross_wins, cm, self_c), \
            torch.where(cross_wins, ca * ns + ns - 1, lab)
        self_wins = self_c > adv_c
        rest = torch.where(self_wins, self_c, adv_c), \
            torch.where(self_wins, lab, lab - 1)
        best = torch.where(s == 0, first[0], rest[0])
        frm = torch.where(s == 0, first[1], rest[1])
        # a dead destination: the dense column, a contiguous quarter of the
        # row (padded to Lr) a lane, from trans destination-major
        dead = ~(best > DEAD_FLOOR)
        if dead.any():
            x = _pruned(_padded(raw, Lr, -np.inf), cut)
            dv, di = _quarter_argmax(x, F)
            best = torch.where(dead, dv, best)
            frm = torch.where(dead, di, frm)
        live = t < lengths
        dead_total += int((dead & live[:, None]).sum())
        raw = torch.where(live[:, None], best + state[:, t], raw)
        cut = torch.where(live, _cut(raw, L, thr, bw, nk), cut)
        bp[:, t] = torch.where(live[:, None], frm.to(torch.int32), bp[:, t])
    scores, last = _final(raw, L, cut)
    return bp, last, scores, dead_total


def _problem(seed, P, ns, B=5, T=17, kind="normal"):
    """The card tests' problem at a small size: ragged lengths with a full
    row, a row of length 2, a row of length 0, and a row whose potentials
    die (every state NEG_INF from frame 4 on)."""
    rng = np.random.default_rng(seed)
    L = P * ns
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L), scale=0.5).astype(np.float32)
    if kind == "zero":
        state, trans = np.zeros_like(state), np.zeros_like(trans)
    elif kind == "integer":
        state = rng.integers(0, 2, size=state.shape).astype(np.float32)
        trans = rng.integers(0, 2, size=trans.shape).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[1], lengths[2], lengths[-1] = T, 2, T, 0
    if ns > 1:
        topo = Topology(P, ns)
        trans = trans + topo.transition_penalty()
        state[:, 0] += topo.start_penalty()
        for b in range(B):
            if lengths[b] > 0:
                state[b, lengths[b] - 1] += topo.end_penalty()
    state[2, 4:] = NEG_INF
    return (torch.from_numpy(state), torch.from_numpy(trans),
            torch.from_numpy(lengths))


def _equal(got, want, label):
    for name, x, y in zip(("bp", "last", "scores"), got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), (label, name)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["normal", "zero", "integer"])
@pytest.mark.parametrize("P,ns", [(5, 1), (12, 1), (4, 3)])
def test_dense_partition_equals_plain(P, ns, kind, mode):
    thr, bw = MODES[mode]
    state, trans, lengths = _problem(P + ns, P, ns, kind=kind)
    _equal(dense_model(state, trans, lengths, thr, bw),
           V.viterbi_forward(state, trans, lengths, bw, thr),
           f"K7 P={P} ns={ns} {kind} {mode}")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["normal", "zero", "integer"])
@pytest.mark.parametrize("P,ns", [(4, 2), (5, 3), (3, 6)])
def test_nstate_partition_equals_plain(P, ns, kind, mode):
    thr, bw = MODES[mode]
    state, trans, lengths = _problem(P * ns, P, ns, kind=kind)
    *got, dead = nstate_model(state, trans, lengths, ns, thr, bw)
    _equal(got, V.viterbi_forward(state, trans, lengths, bw, thr),
           f"K8 P={P} ns={ns} {kind} {mode}")
    # the dead row and the start penalty's dead states take the re-scan;
    # the roofline's count of them is the model's
    assert dead > 0
    assert KV.nstate_rescans(state, trans, lengths, ns, thr, bw) == dead


def test_nstate_rescans_where_the_start_penalty_kills():
    """Exact decode, no dead row: the re-scans are the states s >= 2 at
    frames 1 ... ns - 2 of every row long enough (P each a state and
    frame), and no more."""
    P, ns, T = 3, 5, 12
    _, trans, _ = _problem(1, P, ns)
    state = torch.randn(3, T, P * ns, generator=torch.Generator()
                        .manual_seed(1))
    state[:, 0] += torch.from_numpy(Topology(P, ns).start_penalty())
    lengths = torch.tensor([T, T, T], dtype=torch.int32)
    *got, dead = nstate_model(state, trans, lengths, ns, None, None)
    _equal(got, V.viterbi_forward(state, trans, lengths), "K8 exact")
    # frame t (1 <= t <= ns - 2) kills states t + 1 ... ns - 1 of a phone
    assert dead == 3 * P * sum(ns - 1 - t for t in range(1, ns - 1))


@pytest.mark.parametrize("seed", range(4))
def test_kth_largest_is_topk(seed):
    """Both selects against torch.topk, with ties and NEG_INF."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-3, 4, size=(6, 40)).astype(
        np.float32) * np.float32(0.5))
    x[0, :30] = NEG_INF
    x[1] = -x[1]
    for bw in (1, 3, 17, 40):
        want = torch.topk(x, bw, dim=-1).values[:, -1]
        assert torch.equal(_kth_count(x, bw), want), bw
        assert torch.equal(_kth_radix(x, bw), want), bw


def test_host_picks_the_frame_by_width():
    """K7: registers up to L = 144 (QV 3, 5, 9 at L <= 48, 80, 144), shared
    memory up to 232 (QV 15), the wide kernel above; K8: its cross column
    in registers at P <= 48, 80, 128, two states a lane at most."""
    for L, want in ((1, (3, False)), (48, (3, False)), (49, (5, False)),
                    (80, (5, False)), (81, (9, False)), (144, (9, False)),
                    (145, (15, True)), (232, (15, True)), (233, None),
                    (390, None)):
        assert KV.dense_frame(L) == want, L
    for P, ns, want in ((1, 2, 3), (46, 3, 3), (48, 8, 3), (49, 3, 5),
                        (80, 3, 5), (81, 3, 9), (128, 3, 9), (129, 3, None),
                        (46, 1, None), (46, 9, None)):
        assert KV.nstate_frame(P, ns) == want, (P, ns)
