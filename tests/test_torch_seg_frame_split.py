"""The partition of K10's and K12's frame (``csrc/segmental.cu``
``seg_beta_kernel``, ``seg_delta_kernel``: K9's recursion frame), modelled
in plain PyTorch on the CPU and held to the plain versions of
``kernels/segmental``.

A group of four lanes owns a destination label.  Lane ``g`` holds the
window terms of durations ``g, g + 4, ...`` a pass of 16 durations at a
time; K12 keeps a lane's first maximum over its ascending durations and
merges the group's by ``take_better``, K10 the max, then the exp-sum of the
held terms, later passes merged online, the lanes' sums added in the
shuffles' order.  The frame's one shared row (K10's z, K12's raw delta) is
read a quarter of ``4 QV`` entries a lane, padded to ``16 QV``: K10
exponentiates its quarter on read; K12 prunes its quarter by the beam on
read and takes the max-plus product with the factor's pads at ``-inf``.

Tolerances: K12's model equals the plain version bit for bit (single IEEE
operations in the plain version's order; maxima are exact in any order);
K10's within rtol 1e-5 (the same terms summed in another order).
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch.kernels import segmental as K
from asr_craft_tpu_torch.kernels.fwdbwd import backward_factors
from asr_craft_tpu_torch.ops.semiring import NEG_INF

GROUP, WIN = 4, 4
PASS = GROUP * WIN                       # durations a pass
FLOOR = 1e-38


def _qv(L):
    """The layout's float4 chunks a lane (``segmental.cu`` frame_layout):
    the factor in registers up to L = 144, in shared memory beyond."""
    return next((q for q in (3, 5, 9) if 16 * q >= L), -(-L // 16))


def _durations(g, dhi):
    """Lane g's durations, in the order it takes them: pass by pass."""
    for c in range(0, dhi + 1, PASS):
        yield c, [d for d in (c + g + GROUP * i for i in range(WIN))
                  if d <= dhi]


def _take_better(v, i, v2, i2):
    """The larger value, then the lower index, elementwise."""
    take = (v2 > v) | ((v2 == v) & (i2 < i))
    return torch.where(take, v2, v), torch.where(take, i2, i)


def _group(x, op):
    """The shuffles' butterfly over the four lanes of x[g]: xor 1, then 2."""
    x = [op(x[g], x[g ^ 1]) for g in range(GROUP)]
    return [op(x[g], x[g ^ 2]) for g in range(GROUP)]


def _padded(x, Lq, pad):
    out = torch.full(x.shape[:-1] + (Lq,), pad, dtype=x.dtype)
    out[..., :x.shape[-1]] = x
    return out


def _quarters(x):
    """(..., Lq) -> (..., 4, Lq / 4): lane g's contiguous quarter."""
    return x.reshape(x.shape[:-1] + (GROUP, x.shape[-1] // GROUP))


def viterbi_model(frame, trans, bias, lengths, mean_pool, thr):
    """K12's partition: ``(deltas, arg_d, lab0, scores)``."""
    B, T, L = frame.shape
    Dmax = bias.shape[0]
    Lq = 16 * _qv(L)
    invd = K.pool_weights(Dmax, mean_pool)
    F = _padded(trans.T, Lq, -np.inf)          # F[l, p] = trans[p, l]
    msg = torch.zeros_like(frame)              # M[u] by source frame
    cs_all = torch.zeros_like(frame)           # CS[u + 1]
    deltas = torch.full_like(frame, NEG_INF)
    arg_d = torch.zeros((B, T, L), dtype=torch.int32)
    cum = torch.zeros((B, L))
    row = torch.full((B, L), NEG_INF)
    for t in range(T):
        cum = cum + frame[:, t]
        dhi = min(t, Dmax - 1)
        best, bestd = [], []
        for g in range(GROUP):
            v = torch.full((B, L), -np.inf)
            i = torch.full((B, L), 2 ** 31 - 1, dtype=torch.int64)
            for _, ds in _durations(g, dhi):
                for d in ds:
                    zero = torch.zeros((B, L))
                    q = msg[:, t - 1 - d] if d < t else zero
                    cs = cs_all[:, t - 1 - d] if d < t else zero
                    w = torch.add(q, torch.add(
                        torch.mul(torch.sub(cum, cs), invd[d]), bias[d]))
                    take = w > v
                    v, i = torch.where(take, w, v), torch.where(take, d, i)
            best.append(v)
            bestd.append(i)
        pairs = _group(list(zip(best, bestd)),
                       lambda a, b: _take_better(*a, *b))
        dv, dd = pairs[0]
        assert all(torch.equal(p[0], dv) and torch.equal(p[1], dd)
                   for p in pairs)
        raw = _padded(dv, Lq, NEG_INF)
        if thr is not None:
            m = torch.clamp(dv.amax(-1, keepdim=True), min=NEG_INF)
            cut = torch.sub(m, np.float32(thr))
            raw = torch.where(raw >= cut, raw, NEG_INF)   # pruned on read
        # each lane's quarter of the max-plus product, then the group's max
        lane = _quarters(raw[:, None, :] + F[None]).amax(-1)   # (B, L, 4)
        mv = _group([lane[..., g] for g in range(GROUP)], torch.maximum)[0]
        live = (t < lengths)[:, None]
        deltas[:, t] = torch.where(live, raw[:, :L], NEG_INF)
        arg_d[:, t] = torch.where(live, dd, 0).to(torch.int32)
        msg[:, t], cs_all[:, t] = mv, cum
        row = torch.where((t == lengths - 1)[:, None], raw[:, :L], row)
    # the last row's best score and the lowest label reaching it
    v = torch.full((B,), -np.inf)
    i = torch.full((B,), 2 ** 31 - 1, dtype=torch.int64)
    for lab in range(L):
        v, i = _take_better(v, i, row[:, lab], torch.full((B,), lab))
    empty = lengths <= 0
    return (deltas, arg_d, torch.where(empty, 0, i).to(torch.int32),
            torch.where(empty, NEG_INF, v))


def backward_model(frame, trans, bias, lengths, mean_pool):
    """K10's partition: ``betas (B, T, L)``, walked down from each row's
    ``length - 1``."""
    B, T, L = frame.shape
    Dmax = bias.shape[0]
    Lq = 16 * _qv(L)
    invd = K.pool_weights(Dmax, mean_pool)
    tmax_r, Pt = backward_factors(trans)
    F = _padded(Pt.T, Lq, 0.0)                 # F[l, p] = Pt[p, l]
    betas = torch.full_like(frame, NEG_INF)
    r_all = torch.zeros((B, T, L))             # R[v + 1] by frame v
    rnow = torch.zeros((B, L))                 # R[t + 1]
    n = lengths[:, None]
    for t in range(T - 1, -1, -1):
        dhi = min(Dmax - 1, T - 2 - t)
        beta = torch.zeros((B, L))
        if dhi >= 0:
            valid = [(t + d + 1 < n).expand(B, L) for d in range(dhi + 1)]
            mx, sums = None, [torch.zeros((B, L)) for _ in range(GROUP)]
            for c in range(0, dhi + 1, PASS):
                held = []
                for g in range(GROUP):
                    ws = []
                    for d in (c + g + GROUP * i for i in range(WIN)):
                        if d > dhi:
                            continue
                        v = t + d + 1
                        w = ((rnow - r_all[:, v]) * invd[d] + bias[d]) \
                            + betas[:, v]
                        ws.append(torch.where(valid[d], w, -np.inf))
                    held.append(ws)
                lane_max = [torch.full((B, L), NEG_INF)] * GROUP
                for g in range(GROUP):
                    for w in held[g]:
                        lane_max[g] = torch.maximum(lane_max[g], w)
                cm = _group(lane_max, torch.maximum)[0]
                if mx is None:
                    mx = cm
                else:                          # a deeper pass: rescale
                    up = cm > mx
                    sums = [torch.where(up, s * torch.exp(mx - cm), s)
                            for s in sums]
                    mx = torch.where(up, cm, mx)
                for g in range(GROUP):
                    for w in held[g]:
                        sums[g] = sums[g] + torch.where(
                            w == -np.inf, 0.0, torch.exp(w - mx))
            total = _group(sums, torch.add)[0]
            z = mx + torch.log(torch.clamp(total, min=FLOOR))
            zm = torch.clamp(z.amax(-1, keepdim=True), min=NEG_INF)
            e = torch.exp(_padded(z, Lq, NEG_INF) - zm)   # on read
            lane = _quarters(e[:, None, :] * F[None]).sum(-1)
            acc = _group([lane[..., g] for g in range(GROUP)], torch.add)[0]
            beta = zm + tmax_r + torch.log(torch.clamp(acc, min=FLOOR))
        beta = torch.where(t == n - 1, 0.0, beta)
        betas[:, t] = torch.where(t < n, beta, NEG_INF)
        r_all[:, t] = rnow
        rnow = rnow + torch.where(t < n, frame[:, t], 0.0)
    return betas


def _problem(seed, B, T, Dmax, L, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        draw = lambda *s: rng.integers(-2, 3, size=s).astype(np.float32)
    else:
        draw = lambda *s: (0.7 * rng.normal(size=s)).astype(np.float32)
    frame, bias, trans = draw(B, T, L), draw(Dmax, L), draw(L, L)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    lengths[-1] = 0                              # an empty row
    return tuple(torch.from_numpy(a) for a in (frame, trans, bias, lengths))


# (B, T, Dmax, L): one pass, windows of two and three passes, the factor in
# registers at QV = 3 and 5 and in shared memory (QV = 10), T < Dmax
SHAPES = [(4, 23, 4, 5), (3, 40, 20, 7), (3, 36, 33, 6), (3, 25, 16, 50),
          (2, 12, 6, 150), (3, 9, 16, 4)]


@pytest.mark.parametrize("thr", [None, 8.0, 1.0])
@pytest.mark.parametrize("B,T,Dmax,L", SHAPES)
def test_viterbi_partition_equals_plain(B, T, Dmax, L, thr):
    args = _problem(B * T + Dmax, B, T, Dmax, L)
    for mean_pool in (True, False):
        got = viterbi_model(*args, mean_pool, thr)
        want = K.segmental_viterbi_plain(*args, mean_pool, thr)
        for name, x, y in zip(("deltas", "arg_d", "lab0", "scores"), got,
                              want):
            assert x.dtype == y.dtype and torch.equal(x, y), (name, thr)


@pytest.mark.parametrize("seed", [0, 1, 2, "flat"])
@pytest.mark.parametrize("thr", [None, 1.0])
def test_viterbi_partition_ties_fall_as_in_the_plain_version(seed, thr):
    """Integer potentials and sum pooling, and flat ones (every candidate
    ties): the shortest duration among equal candidates, across lanes and
    passes, and the lowest final label."""
    flat = seed == "flat"
    args = _problem(0 if flat else seed, 8, 30, 20, 5, integer=True)
    if flat:
        args = tuple(torch.zeros_like(a) for a in args[:3]) + args[3:]
    got = viterbi_model(*args, False, thr)
    want = K.segmental_viterbi_plain(*args, False, thr)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    longer = int((want[1] > 0).sum())
    if flat:
        assert longer == 0 and int(want[2].max()) == 0
    else:
        assert longer > 0                     # long segments do win


@pytest.mark.parametrize("B,T,Dmax,L", SHAPES)
def test_backward_partition_matches_plain(B, T, Dmax, L):
    args = _problem(B * T + Dmax + 1, B, T, Dmax, L)
    for mean_pool in (True, False):
        got = backward_model(*args, mean_pool)
        want = K.segmental_backward_plain(*args, mean_pool)
        assert torch.isfinite(got).all()
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), \
            float((got - want).abs().max())
