"""The stream of the two traceback kernels (``csrc/fdt_common.cuh``'s
tracebacks' stream; ``csrc/fdt_viterbi.cu`` ``fdt_vit_tb_kernel``, the
traceback of K3, K7 and K8; ``csrc/segmental.cu`` ``seg_traceback_kernel``,
K13), modelled in plain PyTorch on the CPU and held BIT FOR BIT to the plain
versions ``ops/fdt.fdt_viterbi_traceback`` and
``kernels/segmental.segmental_viterbi_traceback_plain``.

One block walks one utterance.  Its rows reach a ring of three slots in
blocks of C frames, top block first, each block copied in 16-byte pieces
from the 16-byte boundary at or below its first element (the rows sit that
many elements into the slot, the last piece cut to the block's own bytes
and zero-filled); block i goes to slot i % 3 once block i - 3 is released.
The fdt walk carries its label across block borders; frames at and past
``min(length, T) - 1`` take the final label and read no row; every label is
clamped into ``[0, L')`` before it indexes a row.  K13 holds the block of
the frame it stands on: a segment's predecessor is resolved once the block
holding ``start - 1`` has landed (the deferred resolution of the TPU
kernel), releasing each block it leaves or jumps over, by each lane's first
maximum over its ascending labels and the warp's largest order key (zeros
made +0) with the lowest index holding it.

Also the wrappers' choice of C against a block's shared memory.
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch.kernels import fdt_viterbi as V
from asr_craft_tpu_torch.kernels import segmental as K
from asr_craft_tpu_torch.kernels.wall import SMEM_LIMIT
from asr_craft_tpu_torch.ops import fdt

RING = V.TB_RING


class Ring:
    """The slots and the stream's order: ``fill`` lands the next block (at
    most RING - 1 ahead of the oldest held one), ``take(i)`` returns block
    i's slot once it has landed, ``release(i)`` frees it."""

    def __init__(self, blocks):
        self.blocks, self.slots = blocks, [None] * RING
        self.landed, self.released = 0, 0

    def fill(self):
        i = self.landed
        assert i < len(self.blocks) and i - self.released < RING
        self.slots[i % RING] = (i, self.blocks[i]())
        self.landed += 1

    def take(self, i):
        while self.landed <= i:
            self.fill()
        j, slot = self.slots[i % RING]
        assert j == i, "a slot was overwritten before it was released"
        return slot

    def release(self, i):
        assert i == self.released
        self.released += 1
        while self.landed < len(self.blocks) and \
                self.landed - self.released < RING - 1:
            self.fill()


def _copy(flat, e0, n):
    """The slot of ``n`` elements of ``flat`` from element ``e0``: the
    16-byte pieces from the boundary at or below it (the tensor's start is
    16-byte aligned), zero past the block's last element; the rows start
    ``e0 % 4`` elements in."""
    off = e0 % 4
    piece = flat[e0 - off:e0 + n].clone()
    pad = (-piece.numel()) % 4
    return torch.cat([piece, piece.new_zeros(pad)]), off


def fdt_walk(bp, last, lengths, C):
    """The fdt traceback kernel's walk: (B, T) int32 paths."""
    B, T, Lp = bp.shape
    flat = bp.reshape(-1)
    paths = torch.empty((B, T), dtype=torch.int32)
    for b in range(B):
        lst = min(max(int(last[b]), 0), Lp - 1)
        end = min(int(lengths[b]), T) - 1
        nblk = (end + C - 1) // C if end > 0 else 0
        paths[b, max(end, 0):] = lst
        f0s = [(nblk - 1 - i) * C for i in range(nblk)]

        def block(f0):
            n = min(f0 + C, end) - f0
            return lambda: _copy(flat, (b * T + f0 + 1) * Lp, n * Lp)

        ring = Ring([block(f0) for f0 in f0s])
        cur = lst
        for i, f0 in enumerate(f0s):
            slot, off = ring.take(i)
            for t in range(min(f0 + C, end) - 1, f0 - 1, -1):
                v = int(slot[off + (t - f0) * Lp + cur])
                cur = min(max(v, 0), Lp - 1)
                paths[b, t] = cur
            ring.release(i)
    return paths


def _order_key(v):
    b = np.array([v], np.float32).view(np.int32)[0]
    return int(b) if b >= 0 else int(b ^ 0x7FFFFFFF)


def _warp_argmax(row, col):
    """The lowest q maximising row[q] + col[q] (fp32 adds), as the warp
    takes it."""
    L = len(row)
    best = []
    for lane in range(32):
        v, i = -np.inf, 2 ** 31 - 1
        for q in range(lane, L, 32):
            s = np.float32(row[q]) + np.float32(col[q])
            if s > v or (s == v and q < i):
                v, i = s, q
        best.append((_order_key(np.float32(v) + np.float32(0.0)), i))
    top = max(k for k, _ in best)
    return min(min(i for k, i in best if k == top), L - 1)


def seg_walk(deltas, arg_d, trans, lab0, lengths, C):
    """K13's walk: (end_lab, end_start) (B, T) int32."""
    B, T, L = deltas.shape
    dflat, aflat = deltas.reshape(-1), arg_d.reshape(-1)
    end_lab = torch.full((B, T), -1, dtype=torch.int32)
    end_start = torch.zeros((B, T), dtype=torch.int32)
    for b in range(B):
        t0 = min(max(int(lengths[b]), 0), T) - 1
        nblk = (t0 + C) // C

        def block(f0):
            n = (min(f0 + C, t0 + 1) - f0) * L
            e0 = (b * T + f0) * L
            return lambda: (_copy(dflat, e0, n), _copy(aflat, e0, n))

        ring = Ring([block((nblk - 1 - i) * C) for i in range(nblk)])
        held, f0, rows = -1, 0, None

        def hold(u):
            nonlocal held, f0, rows
            while held < nblk - 1 - u // C:
                if held >= 0:
                    ring.release(held)
                held += 1
                rows = ring.take(held)
            f0 = (nblk - 1 - held) * C

        def row(k, u):
            slot, off = rows[k]
            return slot[off + (u - f0) * L:off + (u - f0 + 1) * L]

        t, lab = t0, min(max(int(lab0[b]), 0), L - 1)
        if t >= 0:
            hold(t)
        while t >= 0:
            start = t - max(int(row(1, t)[lab]), 0)
            end_lab[b, t], end_start[b, t] = lab, start
            if start <= 0:
                break
            t = start - 1
            if t < f0:
                hold(t)
            lab = _warp_argmax(row(0, t).numpy(), trans[:, lab].numpy())
        for i in range(max(held, 0), nblk):
            if i > held:
                ring.take(i)
            ring.release(i)
    return end_lab, end_start


def _fdt_problem(B, T, Lp, seed, garbage=False):
    """Backpointers of a random walk (in range), or anything (garbage:
    out-of-range entries and final labels too); lengths 0, 1, T, T + 3 and
    ragged."""
    rng = np.random.default_rng(seed)
    lo, hi = (-3, Lp + 3) if garbage else (0, Lp)
    bp = rng.integers(lo, hi, size=(B, T, Lp)).astype(np.int32)
    last = rng.integers(lo, hi, size=B).astype(np.int32)
    lengths = rng.integers(0, T + 4, size=B).astype(np.int32)
    lengths[:4] = [0, 1, T, T + 3][:B]
    return (torch.from_numpy(bp), torch.from_numpy(last),
            torch.from_numpy(lengths))


@pytest.mark.parametrize("C", [1, 2, 5])
@pytest.mark.parametrize("dT", ["C-1", "C", "C+1", "2C+1", "C>=T"])
@pytest.mark.parametrize("Lp", [3, 6, 7])
def test_fdt_walk_equals_the_plain_traceback(C, dT, Lp):
    T = {"C-1": max(C - 1, 1), "C": C, "C+1": C + 1, "2C+1": 2 * C + 1,
         "C>=T": max(C - 2, 1)}[dT]
    bp, last, lengths = _fdt_problem(6, T, Lp, seed=T * 31 + Lp + C)
    assert torch.equal(fdt_walk(bp, last, lengths, C),
                       fdt.fdt_viterbi_traceback(bp, last, lengths))


@pytest.mark.parametrize("C", [1, 3, 8, 40])
@pytest.mark.parametrize("Lp", [5, 6])
def test_fdt_walk_clamps_garbage_backpointers(C, Lp):
    """Out-of-range backpointers and final labels (a NaN lattice's): the
    walk equals the plain traceback on the same entries clamped."""
    bp, last, lengths = _fdt_problem(7, 23, Lp, seed=C + Lp, garbage=True)
    assert int(bp.min()) < 0 and int(bp.max()) >= Lp
    want = fdt.fdt_viterbi_traceback(bp.clamp(0, Lp - 1),
                                      last.clamp(0, Lp - 1), lengths)
    assert torch.equal(fdt_walk(bp, last, lengths, C), want)


def _seg_problem(B, T, L, Dmax, seed, kind):
    """Integer deltas and trans (ties), their zeros -0.0 or 0.0 at random
    (sums of -0.0 and 0.0 tie), durations: random below Dmax, all one
    frame, or all Dmax frames."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi, shape):
        x = rng.integers(lo, hi, size=shape).astype(np.float32)
        x[x == 0] = np.where(rng.random(int((x == 0).sum())) < 0.5,
                             np.float32(-0.0), np.float32(0.0))
        return x

    deltas, trans = ints(-2, 3, (B, T, L)), ints(-1, 2, (L, L))
    t = np.arange(T)[None, :, None]
    if kind == "random":
        d = rng.integers(0, Dmax, size=(B, T, L))
    else:
        d = np.full((B, T, L), 0 if kind == "one" else Dmax - 1)
    arg_d = np.minimum(d, t).astype(np.int32)
    lab0 = rng.integers(0, L, size=B).astype(np.int32)
    lengths = rng.integers(0, T + 4, size=B).astype(np.int32)
    lengths[:4] = [0, 1, T, T + 3][:B]
    return tuple(torch.from_numpy(x) for x in (deltas, arg_d, trans, lab0,
                                               lengths))


@pytest.mark.parametrize("kind", ["random", "one", "long"])
@pytest.mark.parametrize("C,T", [(1, 7), (3, 2), (3, 3), (3, 4), (3, 7),
                                 (5, 16), (40, 21)])
@pytest.mark.parametrize("L", [3, 37])
def test_seg_walk_equals_the_plain_traceback(C, T, L, kind):
    """Segments of one frame and of Dmax frames crossing block borders
    (Dmax = 6 > C for the small C: the predecessor's frame may lie blocks
    below), tied integer scores, the lowest predecessor among equals."""
    args = _seg_problem(6, T, L, 6, seed=C * 7 + T + L, kind=kind)
    got = seg_walk(*args, C)
    want = K.segmental_viterbi_traceback_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_seg_walk_on_a_decode():
    """The max-plus pass's own deltas and duration argmaxes, the deferred
    predecessor in the next block whenever a segment starts at a border."""
    rng = np.random.default_rng(4)
    B, T, L, Dmax = 5, 19, 4, 5
    frame = torch.from_numpy(rng.normal(size=(B, T, L)).astype(np.float32))
    trans = torch.from_numpy(rng.normal(size=(L, L)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(Dmax, L)).astype(np.float32))
    lengths = torch.tensor([T, 0, 1, 11, 18], dtype=torch.int32)
    deltas, arg_d, lab0, _ = K.segmental_viterbi_plain(frame, trans, bias,
                                                       lengths)
    want = K.segmental_viterbi_traceback_plain(deltas, arg_d, trans, lab0,
                                               lengths)
    for C in (1, 2, 4, 6, 19):
        got = seg_walk(deltas, arg_d, trans, lab0, lengths, C)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("Lp,C", [(42, 128), (138, 59), (144, 56), (390, 21)])
def test_fdt_block_frames_fill_the_slot_within_the_budget(Lp, C):
    """C as many frames as fill a 32 KB slot, at most 128: the widths of
    configs 3, 5, 2 (and 1, 3's n-state 144) and K7's L' = 390."""
    assert V.traceback_frames(Lp) == C
    assert V.stream_bytes(C, Lp, 1, 4 * V.TB_MAX_FRAMES) <= SMEM_LIMIT
    assert C == V.TB_MAX_FRAMES or 4 * Lp * (C + 1) > V.TB_SLOT_BYTES


def test_block_frames_shrink_to_one_then_raise():
    """Wide rows: one frame a block as long as the ring fits, then 0 (the
    wrapper raises)."""
    assert V.traceback_frames(5000) == 1
    assert V.stream_bytes(1, 19300, 1, 4 * V.TB_MAX_FRAMES) <= SMEM_LIMIT
    assert V.traceback_frames(19300) == 1
    assert V.traceback_frames(19400) == 0
    assert K.traceback_plan(15000) == (0, False)


@pytest.mark.parametrize("L,plan", [(48, (85, True)), (205, (13, True)),
                                    (229, (4, True)), (237, (1, True)),
                                    (238, (17, False))])
def test_seg_plan_stages_trans_where_it_fits(L, plan):
    """K13's blocks hold deltas and arg_d (8 L bytes a frame); trans^T is
    staged beside the ring up to L = 237, read from device memory above."""
    C, staged = plan
    assert K.traceback_plan(L) == plan
    trans = 4 * ((L * L + 3) // 4 * 4) if staged else 0
    assert V.stream_bytes(C, L, 2, trans) <= SMEM_LIMIT
    assert C == V.TB_MAX_FRAMES or (
        8 * L * (C + 1) > V.TB_SLOT_BYTES
        or V.stream_bytes(C + 1, L, 2, trans) > SMEM_LIMIT)
