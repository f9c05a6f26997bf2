"""K3's forward on two paths, on the CPU: the host's choice
(``kernels.fdt_viterbi.recursion_path``), what the wrapper hands the library
for it, and the cluster's frame modelled in plain PyTorch.

The recursion (``csrc/fdt_viterbi.cu`` ``fdt_vit_fwd_kernel<CL>``) runs an
exact decode of up to one utterance an SM on clusters of two blocks (CL = 2:
each block half of the destination phones, the plane rows multicast to
both, the last states exchanged through the peer's shared memory) and every
other decode, larger batches and beams, one block an utterance (CL = 1).
The wrapper counts each launch, with its path, in the diagnostics counter
``kernels.fdt_viterbi_fwd[<path>]``.  The library here is a
stand-in that records its arguments.

The model follows one frame of either path: a block's destinations
``[p0, p1)``, the predecessors cut into H slices of K consecutive phones,
each slice's first argmax by a tree that keeps the index order
(``take_right``: the right side only if strictly larger) over chunks of 8
candidates read at once (one past its slice read as a copy of the slice's
last, which never beats it; a NaN counts as -inf), the slices merged in
order (past H: a copy of the last slice's), and the start (-inf, 0) left of
all.  It is held BIT FOR BIT to the plain ``ops/fdt.fdt_viterbi_forward``.
"""
import contextlib

import numpy as np
import pytest
import torch

from asr_craft_tpu_torch.kernels import fdt_viterbi as V
from asr_craft_tpu_torch.ops import fdt
from asr_craft_tpu_torch.utils import diagnostics

CHUNK = 8
THREADS = {1: 384, 2: 192}          # csrc/fdt_viterbi.cu fwd_threads


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B", [1, 64, 66, 67, 114, 115, 132, 133, 191])
def test_recursion_path_rule(monkeypatch, sms, B):
    """Cluster up to one utterance an SM (2 B blocks, two an SM), one block
    an utterance beyond; beams always take one block an utterance."""
    monkeypatch.setattr(V, "_sm_count", lambda device: sms)
    want = "cluster" if B <= sms else "block"
    assert V.recursion_path(B, "cuda") == want
    assert V.recursion_path(B, "cuda", beams=True) == "block"


class _Library:
    """A stand-in for the kernels' library: the forward's shared memory
    (the C layout's size for a ring of ``stages`` rows of R4 floats, or a
    fixed size), and each fdt_viterbi_fwd call's arguments."""

    def __init__(self, fixed=None):
        self.calls, self.fixed = [], fixed

    def fdt_viterbi_fwd_smem_bytes(self, ns, P, stages, cluster):
        if self.fixed is not None:
            return self.fixed
        R4 = (3 * ns * P + P * P + 3) // 4 * 4
        return 4 * (stages * R4 + 4 * ns * P + 3 * ns * P + 2 * P + 4096)

    def fdt_viterbi_fwd(self, *args):
        self.calls.append(args)
        return 0


def _stand_ins(monkeypatch, lib, sms=132):
    def check_tensor(name, t, dtype, ndim, device):
        assert t.dtype == dtype and t.dim() == ndim and t.is_contiguous()

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(V, "_library", lambda: lib)
    monkeypatch.setattr(V, "_sm_count", lambda device: sms)
    monkeypatch.setattr(V._build, "check_tensor", check_tensor)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())


def _buffers(B, T, ns, P):
    R4 = (3 * ns * P + P * P + 3) // 4 * 4
    return (torch.zeros((B, T, R4)), torch.full((B,), T, dtype=torch.int32),
            torch.empty((B, T, ns * P), dtype=torch.int32),
            torch.empty((B,), dtype=torch.int32), torch.empty((B,)))


@pytest.mark.parametrize("B,beams,path", [
    (64, {}, "cluster"),                 # the decode cell
    (132, {}, "cluster"),
    (133, {}, "block"),                  # the decode CLI's larger sub-batches
    (191, {}, "block"),
    (64, {"beam_threshold": 8.0}, "block"),
    (64, {"beam_width": 4}, "block"),
    (64, {"beam_width": 144}, "cluster")])   # a width of L' prunes nothing
def test_forward_wrapper_passes_and_counts_the_path(monkeypatch, B, beams,
                                                    path):
    """Each launch hands the library the path's cluster size and the ring's
    stages, and counts one launch in ``kernels.fdt_viterbi_fwd[<path>]``."""
    lib = _Library()
    _stand_ins(monkeypatch, lib)
    ns, P = 3, 48
    with diagnostics.held_launches() as ran:
        V.viterbi_forward_planes_cuda(*_buffers(B, 4, ns, P), ns=ns, P=P,
                                      **beams)
    (args,) = lib.calls
    assert args[5:9] == (B, 4, ns, P)
    assert args[-3:-1] == (V.VIT_RING, 2 if path == "cluster" else 1)
    assert ran == {f"kernels.fdt_viterbi_fwd[{path}]": 1}


def test_forward_wrapper_shrinks_the_ring_and_refuses_two_rows(monkeypatch):
    """Rows that do not fit VIT_RING times take fewer stages (P = 128:
    70 KB a row); where two rows do not fit a block, the wrapper raises
    before any launch."""
    lib = _Library()
    _stand_ins(monkeypatch, lib)
    ns, P = 3, 128
    V.viterbi_forward_planes_cuda(*_buffers(2, 3, ns, P), ns=ns, P=P)
    stages = lib.calls[-1][-3]
    assert 2 <= stages < V.VIT_RING
    assert lib.fdt_viterbi_fwd_smem_bytes(ns, P, stages, 2) <= V.SMEM_LIMIT
    assert lib.fdt_viterbi_fwd_smem_bytes(ns, P, stages + 1,
                                          2) > V.SMEM_LIMIT
    big = _Library(fixed=V.SMEM_LIMIT + 1)
    _stand_ins(monkeypatch, big)
    with pytest.raises(ValueError, match="shared memory"):
        V.viterbi_forward_planes_cuda(*_buffers(2, 3, ns, P), ns=ns, P=P)
    assert not big.calls


def test_forward_wrapper_counts_nothing_for_no_utterances(monkeypatch):
    lib = _Library()
    _stand_ins(monkeypatch, lib)
    with diagnostics.held_launches() as ran:
        V.viterbi_forward_planes_cuda(*_buffers(0, 4, 3, 5), ns=3, P=5)
    assert not lib.calls and ran == {}


# --- the frame, modelled ---------------------------------------------------

def cross_shape(P, CL):
    """The twin of csrc/fdt_viterbi.cu cross_shape: (jpad, H, K)."""
    jpad = ((P + CL - 1) // CL + 31) // 32 * 32
    H = min(THREADS[CL] // jpad, P)
    return jpad, H, -(-P // H)


def _take_right(left, right):
    (v, i), (v2, i2) = left, right
    r = v2 > v
    return torch.where(r, v2, v), torch.where(r, i2, i)


def _chunk(v, ix):
    """The tree over CHUNK (value, index) pairs on axis 1, in order."""
    vs = [v[:, k] for k in range(CHUNK)]
    ixs = [ix[:, k] for k in range(CHUNK)]
    w = 1
    while w < CHUNK:
        for k in range(0, CHUNK - w, 2 * w):
            vs[k], ixs[k] = _take_right((vs[k], ixs[k]),
                                        (vs[k + w], ixs[k + w]))
        w *= 2
    return vs[0], ixs[0]


def _block_cross(dlast, cross, p0, p1, H, K):
    """(max, first argmax) over pi of dlast[pi] + cross[pi, pj] for the
    block's destinations pj in [p0, p1): dlast (B, P), cross (B, P, P)."""
    B, P = dlast.shape
    nd = p1 - p0
    ninf = torch.full((B, nd), -np.inf)
    zero = torch.zeros((B, nd), dtype=torch.int64)
    slices = []
    for h in range(H):
        lo, hi = min(h * K, P), min(h * K + K, P)
        acc = (ninf, zero)
        for pi0 in range(lo, hi, CHUNK):
            ks = torch.arange(pi0, pi0 + CHUNK)
            pi = ks.clamp(max=hi - 1)
            v = torch.fmax(dlast[:, pi, None] + cross[:, pi, p0:p1],
                           torch.tensor(-np.inf))
            ix = ks[None, :, None].expand(B, CHUNK, nd)
            acc = _take_right(acc, _chunk(v, ix))
        slices.append(acc)
    acc = (ninf, zero)
    for h0 in range(0, H, CHUNK):
        hs = [min(h0 + k, H - 1) for k in range(CHUNK)]
        v = torch.stack([slices[h][0] for h in hs], 1)
        ix = torch.stack([slices[h][1] for h in hs], 1)
        acc = _take_right(acc, _chunk(v, ix))
    return acc


def model_forward(state, selfp, advp, crossp, lengths, ns, CL):
    """The exact forward as the kernel's blocks compute it, with
    boundaries: (bp, last, scores)."""
    B, T, Lp = state.shape
    P = Lp // ns
    state = fdt._boundary_state(state, lengths, ns, True)
    half = -(-P // CL)
    _, H, K = cross_shape(P, CL)
    lab = torch.arange(Lp, dtype=torch.int32)
    st = lab % ns
    bp = torch.empty((B, T, Lp), dtype=torch.int32)
    bp[:, 0] = lab
    delta = state[:, 0]
    for t in range(1, T):
        best = torch.empty_like(delta)
        bpt = torch.empty((B, Lp), dtype=torch.int32)
        for rank in range(CL):
            p0, p1 = min(rank * half, P), min(rank * half + half, P)
            if p0 == p1:
                continue
            cm, ca = _block_cross(delta[:, ns - 1::ns], crossp[:, t], p0, p1,
                                  H, K)
            ls = slice(ns * p0, ns * p1)
            cm = torch.repeat_interleave(cm, ns, dim=-1)
            ca = torch.repeat_interleave(ca.to(torch.int32), ns, dim=-1)
            if ns == 1:
                best[:, ls], bpt[:, ls] = cm, ca
                continue
            self_c = delta[:, ls] + selfp[:, t, ls]
            adv_c = torch.roll(delta + advp[:, t], 1, dims=-1)[:, ls]
            adv_c = torch.where(st[ls] > 0, adv_c, fdt.NEG_INF)
            cross_c = torch.where(st[ls] == 0, cm, fdt.NEG_INF)
            b = torch.fmax(torch.fmax(self_c, adv_c), cross_c)
            best[:, ls] = b
            bpt[:, ls] = torch.where(
                self_c == b, lab[ls],
                torch.where(adv_c == b, lab[ls] - 1, ca * ns + ns - 1))
        valid = (t < lengths)[:, None]
        delta = torch.where(valid, best + state[:, t], delta)
        bp[:, t] = torch.where(valid, bpt, lab)
    scores, last = fdt.first_argmax(delta, dim=-1)
    return bp, last, scores


def _planes(B, T, ns, P, kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, 3 * ns * P + P * P)).astype(np.float32)
    if kind == "integer":
        x = np.round(x * 2)
    elif kind == "dead":
        x[rng.random(x.shape) < 0.3] = -np.inf
        x[:, :, 3 * ns * P:3 * ns * P + P] = -np.inf    # rows of pi = 0
    planes = torch.from_numpy(x)
    lengths = torch.from_numpy(rng.integers(1, T + 1, size=B)
                               .astype(np.int32))
    lengths[0] = T
    return planes, lengths


@pytest.mark.parametrize("kind", ["normal", "integer", "dead"])
@pytest.mark.parametrize("CL", [1, 2])
@pytest.mark.parametrize("P,ns", [(5, 3), (47, 3), (48, 3), (48, 1),
                                  (128, 1)])
def test_modelled_frame_equals_plain(P, ns, CL, kind):
    """Both paths' frame, unequal halves included (P = 5, 47), bit for bit:
    backpointers, the final label and score; with ties and with dead
    (-inf) predecessors, whose slices keep the start (-inf, 0)."""
    planes, lengths = _planes(3, 9, ns, P, kind, seed=7 * P + ns + CL)
    blocks = V.plane_blocks(planes, ns, P)
    want = fdt.fdt_viterbi_forward(*blocks, lengths, ns, True)
    got = model_forward(*blocks, lengths, ns, CL)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))


@pytest.mark.parametrize("P", [5, 47, 48, 128])
def test_cross_shapes_cover_every_predecessor(P):
    """The slices cut [0, P) in order, none past it; a block's destinations
    fit its padded lanes; H slices of jpad lanes fit the block."""
    for CL in (1, 2):
        jpad, H, K = cross_shape(P, CL)
        cut = [pi for h in range(H) for pi in range(min(h * K, P),
                                                    min(h * K + K, P))]
        assert cut == list(range(P))
        assert -(-P // CL) <= jpad and H * jpad <= THREADS[CL]
