"""The K3 CUDA kernels (the plane kernel, the recursion, the traceback)
against their plain PyTorch versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these tests skip on a
host without an NVIDIA GPU.  On one, from the repository root (the JAX-free
port needs no conftest, and the GPU machine may have no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Paths must be equal (exact-arithmetic tie cases) or equal up to the
near-tie rule; scores allclose at rtol=1e-5, atol=1e-4 (the plane kernel
sums in 3xTF32, in another order than cuBLAS's fp32 product).  The
recursion alone on the plane kernel's planes against its plain version on
the same planes: paths equal and scores within rtol=1e-6 (the same fp32
additions in the same order).

K3's recursion has two paths (``kernels.fdt_viterbi.recursion_path``): a
cluster of two blocks an utterance for exact decodes of up to one utterance
an SM, one block an utterance otherwise.  The fixture ``path`` forces either
(a beam always takes one block); the two give the same bits as each other
and as the plain recursion on the same planes, and each launch counts one
``kernels.fdt_viterbi_fwd[<path>]``.
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch.kernels import fdt_viterbi as V
from asr_craft_tpu_torch.kernels.fdt_train import fdt_planes_cuda
from asr_craft_tpu_torch.kernels.fdt_viterbi import (fdt_viterbi_cuda,
                                                     fdt_viterbi_wall_torch)
from asr_craft_tpu_torch.kernels.wall import build_wall, wall_planes
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.ops import fdt
from asr_craft_tpu_torch.utils import diagnostics
from launch_counts import moved, ran

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-4)
MODES = {"exact": {}, "threshold": {"beam_threshold": 2.0},
         "topk": {"beam_width": 4},
         "both": {"beam_threshold": 1.0, "beam_width": 3}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(params=["cluster", "block"])
def path(request, monkeypatch):
    """K3's recursion forced onto one path (beams: one block)."""
    forced = request.param
    monkeypatch.setattr(
        V, "recursion_path",
        lambda B, device, beams=False: "block" if beams else forced)
    return forced


def _problem(dev, P, ns, B=5, T=33, D=12, seed=0, integer=False):
    cfg = CrfConfig(num_labels=P, feat_dim=D, num_states=ns,
                    state_range=(0, D - 2), trans_range=(2, D))
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s, scale=0.3).astype(np.float32)
              for k, s in cfg.fmap.param_shapes().items()}
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    if integer:
        params = {k: np.round(v / 0.3) for k, v in params.items()}
        feats = np.round(feats)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = T, 0
    params = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    Wall, u0, u1, dims = build_wall(params, cfg.fmap, ns)
    return (Wall, torch.from_numpy(feats).to(dev),
            torch.from_numpy(lengths).to(dev),
            dict(u0=u0, u1=u1, ns=ns, P=P))


def _compare(Wall, feats, lengths, kw, beams, exact_paths):
    before = diagnostics.launches()
    paths, scores = fdt_viterbi_cuda(Wall, feats, lengths, **kw, **beams)
    ref_paths, ref_scores = fdt_viterbi_wall_torch(Wall, feats, lengths,
                                                   **kw, **beams)
    torch.cuda.synchronize()
    assert ran(before) == {"fdt_viterbi_plane": 1, "fdt_viterbi_fwd": 1,
                           "fdt_viterbi_traceback": 1}
    torch.testing.assert_close(scores, ref_scores, **TOL)
    diff = (paths != ref_paths).any(dim=1)
    if exact_paths or not bool(diff.any()):
        assert torch.equal(paths, ref_paths)
        return
    planes = wall_planes(Wall, feats, kw["u0"], kw["u1"], kw["ns"], kw["P"])
    rescored = fdt.path_score(*planes, paths, lengths, kw["ns"])
    torch.testing.assert_close(rescored[diff], ref_scores[diff], **TOL)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P,ns", [(5, 1), (5, 3), (8, 3), (128, 1),
                                  (128, 3)])
def test_kernel_matches_plain(dev, path, P, ns, mode):
    Wall, feats, lengths, kw = _problem(dev, P, ns, seed=P + ns)
    _compare(Wall, feats, lengths, kw, MODES[mode], exact_paths=False)


@pytest.mark.parametrize("integer", [False, True], ids=["zero", "integer"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ns", [1, 3])
def test_kernel_tie_order(dev, path, ns, mode, integer):
    Wall, feats, lengths, kw = _problem(dev, 5, ns, seed=ns, integer=integer)
    if not integer:
        Wall = torch.zeros_like(Wall)
    _compare(Wall, feats, lengths, kw, MODES[mode], exact_paths=True)


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "integer"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P,ns", [(5, 1), (5, 3), (8, 3), (128, 3)])
def test_recursion_matches_plain_on_the_same_planes(dev, path, P, ns, mode,
                                                    integer):
    """K3's recursion and traceback on the plane kernel's planes against
    the plain planes-in version on the same planes; the empty last row
    still takes its frame-0 argmax."""
    Wall, feats, lengths, kw = _problem(dev, P, ns, seed=3 * P + ns,
                                        integer=integer)
    planes = fdt_planes_cuda(Wall, feats, u0=kw["u0"], u1=kw["u1"])
    B, T, _ = feats.shape
    bp = torch.empty((B, T, ns * P), dtype=torch.int32, device=dev)
    last = torch.empty((B,), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    before = diagnostics.launches()
    V.viterbi_forward_planes_cuda(planes, lengths, bp, last, scores, ns=ns,
                                  P=P, **MODES[mode])
    paths = V.viterbi_traceback_cuda(bp, last, lengths)
    torch.cuda.synchronize()
    assert ran(before) == {"fdt_viterbi_fwd": 1, "fdt_viterbi_traceback": 1}
    ref_paths, ref_scores = V.fdt_viterbi_planes_torch(
        planes, lengths, ns=ns, P=P, **MODES[mode])
    assert torch.equal(paths, ref_paths)
    torch.testing.assert_close(scores, ref_scores, rtol=1e-6, atol=0.0)
    assert int(lengths[-1]) == 0 and int(paths[-1].min()) == \
        int(paths[-1].max()) == int(last[-1])


@pytest.mark.parametrize("mode", list(MODES))
def test_sub_batches_give_one_calls_results(dev, path, mode, monkeypatch):
    """A decode split into sub-batches of at most one or two utterances'
    planes (PLANE_BUDGET set small): one plane launch and one recursion a
    sub-batch, and the paths and scores of one call."""
    Wall, feats, lengths, kw = _problem(dev, 8, 3, seed=5)
    B, T, _ = feats.shape
    R4 = (Wall.shape[0] + 3) // 4 * 4
    one = fdt_viterbi_cuda(Wall, feats, lengths, **kw, **MODES[mode])
    for budget in (1, 2 * 4 * T * R4):
        plan = V.sub_batches(B, T, Wall.shape[0], budget)
        assert len(plan) > 1
        before = diagnostics.launches()
        monkeypatch.setattr(V, "PLANE_BUDGET", budget)
        split = fdt_viterbi_cuda(Wall, feats, lengths, **kw, **MODES[mode])
        torch.cuda.synchronize()
        assert ran(before) == {"fdt_viterbi_plane": len(plan),
                               "fdt_viterbi_fwd": len(plan),
                               "fdt_viterbi_traceback": 1}
        assert torch.equal(split[0], one[0]) and torch.equal(split[1], one[1])


def _planes(dev, B, T, ns, P, seed, integer=False, lengths="cell"):
    """Random plane rows in the plane kernel's (B, T, R4) layout and
    lengths: the cell's (T times a lognormal, one row at T), or edges."""
    R4 = (3 * ns * P + P * P + 3) // 4 * 4
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, R4)).astype(np.float32)
    if integer:
        x = np.round(x * 2)
    if lengths == "cell":
        ln = np.clip(np.round(T * np.exp(rng.normal(-0.35, 0.27, B))), 1, T)
        ln[0] = T
    else:
        ln = rng.integers(0, T + 1, size=B)
        ln[:4] = [0, 1, T, T - 1][:B]
    return (torch.from_numpy(x).to(dev),
            torch.from_numpy(ln.astype(np.int32)).to(dev))


def _forward_both(planes, lengths, ns, P, monkeypatch):
    """K3's recursion and traceback on each path: {path: (bp, last, scores,
    paths)}, each launch's counter checked."""
    B, T, _ = planes.shape
    out = {}
    for forced in ("cluster", "block"):
        monkeypatch.setattr(V, "recursion_path",
                            lambda B, device, beams=False: forced)
        bp = torch.empty((B, T, ns * P), dtype=torch.int32,
                         device=planes.device)
        last = torch.empty((B,), dtype=torch.int32, device=planes.device)
        scores = torch.empty((B,), dtype=torch.float32, device=planes.device)
        before = diagnostics.launches()
        V.viterbi_forward_planes_cuda(planes, lengths, bp, last, scores,
                                      ns=ns, P=P)
        paths = V.viterbi_traceback_cuda(bp, last, lengths)
        torch.cuda.synchronize()
        assert moved(before) == {f"kernels.fdt_viterbi_fwd[{forced}]": 1,
                                 "kernels.fdt_viterbi_traceback": 1}
        out[forced] = (bp, last, scores, paths)
    return out


def _assert_bits(got, want):
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "integer"])
def test_paths_agree_at_the_decode_cells_shape(dev, integer, monkeypatch):
    """B=64, T=512, P=48, ns=3 with the cell's lengths: both paths give the
    plain recursion's bits (bp, last, scores, paths) on the same planes."""
    ns, P = 3, 48
    planes, lengths = _planes(dev, 64, 512, ns, P, seed=64, integer=integer)
    out = _forward_both(planes, lengths, ns, P, monkeypatch)
    bp, last, scores = fdt.fdt_viterbi_forward(
        *V.plane_blocks(planes, ns, P), lengths, ns, True)
    paths = fdt.fdt_viterbi_traceback(bp, last, lengths)
    for got in out.values():
        _assert_bits(got, (bp, last, scores, paths))


@pytest.mark.parametrize("B,T,lengths", [(1, 40, "cell"), (6, 40, "edges"),
                                         (1, 1, "cell")])
@pytest.mark.parametrize("P,ns", [(5, 3), (47, 3), (47, 1), (128, 3),
                                  (128, 1)])
def test_paths_agree_on_unequal_halves_and_edges(dev, P, ns, B, T, lengths,
                                                 monkeypatch):
    """Unequal halves (P = 5, 47), P = 128 (a ring of fewer stages), B = 1,
    lengths 0, 1, T - 1 and T: both paths give the plain bits."""
    planes, ln = _planes(dev, B, T, ns, P, seed=P * 8 + ns + B,
                         integer=True, lengths=lengths)
    out = _forward_both(planes, ln, ns, P, monkeypatch)
    bp, last, scores = fdt.fdt_viterbi_forward(
        *V.plane_blocks(planes, ns, P), ln, ns, True)
    paths = fdt.fdt_viterbi_traceback(bp, last, ln)
    for got in out.values():
        _assert_bits(got, (bp, last, scores, paths))


def test_each_launch_counts_its_path(dev):
    """The rule's own choice: B=64 on the cluster, one utterance more than
    the card's SMs on one block an utterance, a beam on one block; one
    counter a launch."""
    ns, P = 3, 8
    over = V._sm_count(dev) + 1
    for B, beams, want in ((64, {}, "cluster"), (over, {}, "block"),
                           (64, {"beam_width": 4}, "block")):
        planes, lengths = _planes(dev, B, 12, ns, P, seed=B)
        bp = torch.empty((B, 12, ns * P), dtype=torch.int32, device=dev)
        last = torch.empty((B,), dtype=torch.int32, device=dev)
        scores = torch.empty((B,), dtype=torch.float32, device=dev)
        before = diagnostics.launches()
        V.viterbi_forward_planes_cuda(planes, lengths, bp, last, scores,
                                      ns=ns, P=P, **beams)
        torch.cuda.synchronize()
        assert moved(before) == {f"kernels.fdt_viterbi_fwd[{want}]": 1}


def test_traceback_kernel_exact_on_plain_backpointers(dev):
    from asr_craft_tpu_torch.kernels.fdt_viterbi import (
        viterbi_traceback_cuda)
    Wall, feats, lengths, kw = _problem(dev, 6, 3, seed=9)
    bp, last, _ = fdt.fdt_viterbi_forward(
        *wall_planes(Wall, feats, kw["u0"], kw["u1"], 3, 6), lengths, 3)
    got = viterbi_traceback_cuda(bp, last, lengths)
    assert torch.equal(got, fdt.fdt_viterbi_traceback(bp, last, lengths))


def _backpointers(dev, B, T, Lp, seed, garbage=False):
    """Random backpointers and final labels (garbage: out of range too),
    lengths 0, 1, T, T + 3 and ragged."""
    rng = np.random.default_rng(seed)
    lo, hi = (-7, Lp + 7) if garbage else (0, Lp)
    bp = rng.integers(lo, hi, size=(B, T, Lp)).astype(np.int32)
    last = rng.integers(lo, hi, size=B).astype(np.int32)
    lengths = rng.integers(0, T + 4, size=B).astype(np.int32)
    lengths[:4] = [0, 1, T, T + 3]
    return tuple(torch.from_numpy(x).to(dev) for x in (bp, last, lengths))


@pytest.mark.parametrize("garbage", [False, True], ids=["walk", "garbage"])
@pytest.mark.parametrize("dT", ["C-1", "C", "C+1", "2C+1"])
@pytest.mark.parametrize("Lp", [42, 138, 144, 390])
def test_traceback_stream_borders(dev, Lp, dT, garbage):
    """The traceback's stream blocks of C frames (56 at L' = 144): T just
    below, at and above one block and two, lengths 0, 1, T, T + 3; out of
    range backpointers and final labels are clamped (the plain version on
    the clamped entries).  One launch, paths EQUAL."""
    C = V.traceback_frames(Lp)
    T = {"C-1": max(C - 1, 1), "C": C, "C+1": C + 1, "2C+1": 2 * C + 1}[dT]
    bp, last, lengths = _backpointers(dev, 9, T, Lp, seed=Lp + T,
                                      garbage=garbage)
    before = diagnostics.launches()
    got = V.viterbi_traceback_cuda(bp, last, lengths)
    want = fdt.fdt_viterbi_traceback(bp.clamp(0, Lp - 1),
                                     last.clamp(0, Lp - 1), lengths)
    torch.cuda.synchronize()
    assert moved(before) == {"kernels.fdt_viterbi_traceback": 1}
    assert torch.equal(got, want)


@pytest.mark.parametrize("skip", [1, 2, 3])
def test_traceback_of_rows_off_a_16_byte_boundary(dev, skip):
    """Backpointers that start 4, 8 or 12 bytes past a 16-byte boundary (a
    view into a larger buffer): every block copied from the boundary below
    it, the last piece cut to the block."""
    Lp, T = 137, 61
    bp, last, lengths = _backpointers(dev, 6, T, Lp, seed=skip)
    buf = torch.empty(bp.numel() + skip, dtype=torch.int32, device=dev)
    view = buf[skip:].view(bp.shape)
    view.copy_(bp)
    assert view.data_ptr() % 16 == 4 * skip
    got = V.viterbi_traceback_cuda(view, last, lengths)
    assert torch.equal(got, fdt.fdt_viterbi_traceback(bp, last, lengths))


def test_traceback_frames_agree_with_the_kernel_and_raise_beyond(dev):
    lib = V._library()
    for Lp in (1, 3, 42, 138, 144, 390, 4096, 5000, 19300, 19400):
        assert lib.fdt_viterbi_traceback_frames(Lp) == V.traceback_frames(Lp)
    bp, last, lengths = _backpointers(dev, 4, 2, 19400, seed=0)
    with pytest.raises(ValueError, match="does not fit"):
        V.viterbi_traceback_cuda(bp, last, lengths)
    bp, last, lengths = _backpointers(dev, 4, 5, 19300, seed=0)
    assert torch.equal(V.viterbi_traceback_cuda(bp, last, lengths),
                       fdt.fdt_viterbi_traceback(bp, last, lengths))


def test_kernel_refuses_what_it_does_not_take(dev):
    Wall, feats, lengths, kw = _problem(dev, 5, 3)
    with pytest.raises(ValueError, match="P <= 128"):
        fdt_viterbi_cuda(Wall, feats, lengths, **{**kw, "P": 129})
    with pytest.raises(ValueError, match="int32"):
        fdt_viterbi_cuda(Wall, feats, lengths.long(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fdt_viterbi_cuda(Wall, feats.transpose(0, 1).contiguous()
                         .transpose(0, 1), lengths, **kw)
