"""The K7 and K8 CUDA kernels (shared-transition Viterbi) against their
plain PyTorch version, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these tests skip on a
host without an NVIDIA GPU.  On one, from the repository root:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_cuda_viterbi.py -q

The kernels do the plain version's fp32 adds and maxes in its order and
break ties as it does, so backpointers, final labels, scores and paths
must be EQUAL, also on tied (all-zero, integer) inputs, on rows that end
dead and on rows of length 0.
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import fdt_viterbi
from asr_craft_tpu_torch.kernels import viterbi as KV
from asr_craft_tpu_torch.models import crf
from asr_craft_tpu_torch.models.topology import Topology
from asr_craft_tpu_torch.ops import fdt
from asr_craft_tpu_torch.ops import viterbi as V
from asr_craft_tpu_torch.utils import diagnostics
from launch_counts import ran

pytestmark = pytest.mark.cuda
MODES = {"exact": (None, None), "threshold": (2.0, None),
         "topk": (None, 4), "both": (1.0, 3), "top1": (None, 1)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, P, ns, B=6, T=29, seed=0, kind="normal"):
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
    if B >= 3:
        lengths[0], lengths[1], lengths[-1] = T, 2, 0
    if ns > 1:
        topo = Topology(P, ns)
        trans = trans + topo.transition_penalty()
        state[:, 0] += topo.start_penalty()
        for b in range(B):
            if lengths[b] > 0:
                state[b, lengths[b] - 1] += topo.end_penalty()
    return (torch.from_numpy(state).to(dev), torch.from_numpy(trans).to(dev),
            torch.from_numpy(lengths).to(dev))


def _compare(fwd, state, trans, lengths, thr, bw, name):
    before = diagnostics.launches()
    bp, last, scores = fwd(thr, bw)
    rbp, rlast, rscores = V.viterbi_forward(state, trans, lengths, bw, thr)
    torch.cuda.synchronize()
    assert ran(before) == ({name: 1} if state.shape[0] > 0 else {})
    assert torch.equal(scores, rscores)
    assert torch.equal(last, rlast)
    assert torch.equal(bp, rbp)
    paths = KV.viterbi_traceback(bp, last, lengths)
    assert torch.equal(paths, fdt.fdt_viterbi_traceback(rbp, rlast, lengths))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["normal", "zero", "integer"])
@pytest.mark.parametrize("P,ns", [(5, 1), (48, 1), (4, 3), (46, 3)])
def test_dense_kernel_matches_plain(dev, P, ns, kind, mode):
    thr, bw = MODES[mode]
    state, trans, lengths = _problem(dev, P, ns, seed=P + ns, kind=kind)
    _compare(lambda t, w: KV.viterbi_dense_fwd(state, trans, lengths, t, w),
             state, trans, lengths, thr, bw, "viterbi_dense_fwd")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["normal", "zero", "integer"])
@pytest.mark.parametrize("P,ns", [(4, 2), (5, 3), (46, 3), (128, 3), (7, 5)])
def test_nstate_kernel_matches_plain(dev, P, ns, kind, mode):
    thr, bw = MODES[mode]
    state, trans, lengths = _problem(dev, P, ns, seed=P * ns, kind=kind)
    _compare(lambda t, w: KV.viterbi_nstate_fwd(state, trans, lengths, ns, t,
                                                w),
             state, trans, lengths, thr, bw, "viterbi_nstate_fwd")


@pytest.mark.parametrize("mode", ["exact", "threshold", "topk"])
def test_dense_kernel_above_shared_memory(dev, mode):
    """L' = 390 (P = 130, ns = 3): trans (608 KB) is read from global
    memory."""
    thr, bw = MODES[mode]
    state, trans, lengths = _problem(dev, 130, 3, B=3, T=12, seed=7)
    _compare(lambda t, w: KV.viterbi_dense_fwd(state, trans, lengths, t, w),
             state, trans, lengths, thr, bw, "viterbi_dense_fwd")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("L", [144, 145, 232, 233])
def test_dense_kernel_at_the_layout_boundaries(dev, L, mode):
    """The widest register layout (L = 144), the shared-memory one (145,
    232) and the wide kernel (233)."""
    thr, bw = MODES[mode]
    state, trans, lengths = _problem(dev, L, 1, B=4, T=16, seed=L)
    _compare(lambda t, w: KV.viterbi_dense_fwd(state, trans, lengths, t, w),
             state, trans, lengths, thr, bw, "viterbi_dense_fwd")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P", [48, 49, 80, 81, 128])
def test_nstate_kernel_at_the_layout_boundaries(dev, P, mode):
    """The cross column's register layouts end at P = 48, 80, 128."""
    thr, bw = MODES[mode]
    state, trans, lengths = _problem(dev, P, 3, B=4, T=16, seed=P)
    _compare(lambda t, w: KV.viterbi_nstate_fwd(state, trans, lengths, 3, t,
                                                w),
             state, trans, lengths, thr, bw, "viterbi_nstate_fwd")


@pytest.mark.parametrize("beams", [(None, None), (8.0, None), (None, 16)],
                         ids=["exact", "threshold8", "width16"])
@pytest.mark.parametrize("P,ns", [(48, 1), (46, 3)])
def test_kernels_on_a_ragged_decode_batch(dev, P, ns, beams):
    """B = 64, T = 512 with ragged lengths (a full row, a row of 2, an
    empty row): K7 at config 1's width, K8 at config 5's."""
    thr, bw = beams
    state, trans, lengths = _problem(dev, P, ns, B=64, T=512, seed=P + 64)
    if ns > 1:
        fwd = lambda t, w: KV.viterbi_nstate_fwd(state, trans, lengths, ns,
                                                 t, w)
    else:
        fwd = lambda t, w: KV.viterbi_dense_fwd(state, trans, lengths, t, w)
    _compare(fwd, state, trans, lengths, thr, bw,
             "viterbi_nstate_fwd" if ns > 1 else "viterbi_dense_fwd")


@pytest.mark.parametrize("beams", [(None, None), (8.0, None), (None, 16)],
                         ids=["exact", "threshold8", "width16"])
@pytest.mark.parametrize("dT", ["C-1", "C", "C+1", "2C+1"])
@pytest.mark.parametrize("P,ns", [(48, 1), (46, 3), (130, 3)])
def test_traceback_stream_borders_after_each_forward(dev, P, ns, dT, beams):
    """The traceback (K3's, one block an utterance, blocks of C frames
    streamed through shared memory) on K7's backpointers at config 1's
    width and at L' = 390 (the wide kernel), K8's at config 5's: T just
    below, at and above one block and two; paths EQUAL."""
    thr, bw = beams
    C = fdt_viterbi.traceback_frames(P * ns)
    T = {"C-1": max(C - 1, 1), "C": C, "C+1": C + 1, "2C+1": 2 * C + 1}[dT]
    state, trans, lengths = _problem(dev, P, ns, B=5, T=T, seed=T + P)
    if ns > 1 and P <= 128:
        fwd = lambda t, w: KV.viterbi_nstate_fwd(state, trans, lengths, ns,
                                                 t, w)
        name = "viterbi_nstate_fwd"
    else:
        fwd = lambda t, w: KV.viterbi_dense_fwd(state, trans, lengths, t, w)
        name = "viterbi_dense_fwd"
    before = diagnostics.launches()
    _compare(fwd, state, trans, lengths, thr, bw, name)
    assert ran(before) == {name: 1, "viterbi_traceback": 1}


@pytest.mark.parametrize("L", [48, 138, 390])
def test_traceback_clamps_garbage_backpointers(dev, L):
    """Out-of-range backpointers and final labels, as a lattice of NaN
    scores leaves them: the plain traceback on the same entries clamped
    into [0, L')."""
    rng = np.random.default_rng(L)
    B, T = 6, 2 * fdt_viterbi.traceback_frames(L) + 1
    bp = torch.from_numpy(rng.integers(-L, 2 * L, size=(B, T, L)).astype(
        np.int32)).to(dev)
    last = torch.tensor([-5, L, 2 * L, 0, L - 1, 3], dtype=torch.int32,
                        device=dev)
    lengths = torch.tensor([T, T + 3, 1, 0, T - 1, 7], dtype=torch.int32,
                           device=dev)
    got = KV.viterbi_traceback(bp, last, lengths)
    want = fdt.fdt_viterbi_traceback(bp.clamp(0, L - 1), last.clamp(0, L - 1),
                                     lengths)
    assert torch.equal(got, want)


def test_many_states_a_phone_go_to_the_dense_kernel(dev):
    """K8 takes at most 8 states a phone; the dispatch sends more to K7."""
    state, trans, lengths = _problem(dev, 3, 9, B=3, T=10)
    with pytest.raises(ValueError, match="at most 8"):
        KV.viterbi_nstate_fwd(state, trans, lengths, 9)
    before = diagnostics.launches()
    paths, scores = KV.viterbi_shared(state, trans, lengths, 9)
    assert ran(before) == {"viterbi_dense_fwd": 1, "viterbi_traceback": 1}
    want, wscores = V.viterbi_batch(state, trans, lengths)
    assert torch.equal(paths, want) and torch.equal(scores, wscores)


def test_empty_batch_launches_nothing(dev):
    state, trans, lengths = _problem(dev, 4, 3, B=0, T=5)
    before = diagnostics.launches()
    bp, last, scores = KV.viterbi_nstate_fwd(state, trans, lengths, 3)
    assert bp.shape == (0, 5, 12) and last.shape == scores.shape == (0,)
    assert KV.viterbi_traceback(bp, last, lengths).shape == (0, 5)
    assert diagnostics.launches() == before


@pytest.mark.parametrize("P,ns", [(6, 1), (5, 3), (130, 3)])
def test_decode_runs_the_kernels_and_matches_plain(dev, P, ns):
    cfg = crf.CrfConfig(num_labels=P, feat_dim=9, num_states=ns)
    rng = np.random.default_rng(P)
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              .to(dev) for k, s in cfg.fmap.param_shapes().items()}
    feats = torch.from_numpy(rng.normal(size=(5, 21, 9)).astype(
        np.float32)).to(dev)
    lengths = torch.tensor([21, 3, 17, 9, 0], dtype=torch.int32, device=dev)
    before = diagnostics.launches()
    got = crf.decode(cfg, params, feats, lengths, beam_width=5)
    kind = ("viterbi_nstate_fwd" if ns > 1 and P <= 128
            else "viterbi_dense_fwd")
    assert ran(before) == {kind: 1, "viterbi_traceback": 1}
    kernels.set_backend("torch")
    try:
        want = crf.decode(cfg, params, feats, lengths, beam_width=5)
    finally:
        kernels.set_backend("auto")
    assert ran(before) == {kind: 1, "viterbi_traceback": 1}
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernels_refuse_what_they_do_not_take(dev):
    state, trans, lengths = _problem(dev, 5, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        KV.viterbi_dense_fwd(state.cpu(), trans, lengths)
    with pytest.raises(ValueError, match="int32"):
        KV.viterbi_dense_fwd(state, trans, lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        KV.viterbi_dense_fwd(state.transpose(0, 1).contiguous()
                             .transpose(0, 1), trans, lengths)
    with pytest.raises(ValueError, match="shared transition"):
        KV.viterbi_dense_fwd(state, trans[:-1], lengths)
    with pytest.raises(ValueError, match="ns >= 2"):
        KV.viterbi_nstate_fwd(state, trans, lengths, 1)
    big, btrans, blen = _problem(dev, 130, 3, B=2, T=4)
    with pytest.raises(ValueError, match="P <= 128"):
        KV.viterbi_nstate_fwd(big, btrans, blen, 3)
    kernels.set_backend("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensor"):
            KV.viterbi_shared(state.cpu(), trans.cpu(), lengths.cpu(), 3)
    finally:
        kernels.set_backend("auto")


# --- K3's planes at the bf16x3 and default precisions ----------------------

@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("P,ns,B,T,D", [(5, 3, 5, 33, 12),
                                        (48, 3, 64, 512, 144),  # flagship
                                        (128, 3, 2, 24, 16)])
def test_fdt_decode_planes_at_each_precision_match_plain(dev, precision, P,
                                                         ns, B, T, D):
    """K3 (the plane kernel, counted as fdt_viterbi_plane, then the
    recursion and the traceback) at bf16x3 and default against
    fdt_viterbi_wall_torch at the same precision: scores within rtol 1e-5,
    atol 1e-4; paths equal or, where they differ, the kernel's path scores
    the plain best under the plain planes (the near-tie rule)."""
    from asr_craft_tpu_torch.kernels.fdt_train import fdt_planes_torch
    from asr_craft_tpu_torch.kernels.wall import plane_blocks
    cfg = crf.CrfConfig(num_labels=P, feat_dim=D, num_states=ns,
                        trans_range=(0, D), precision=precision)
    g = np.random.default_rng(P + T)
    params = {k: torch.from_numpy(g.normal(size=s, scale=0.1).astype(
        np.float32)).to(dev) for k, s in cfg.fmap.param_shapes().items()}
    feats = torch.from_numpy(g.normal(size=(B, T, D)).astype(
        np.float32)).to(dev)
    lengths = torch.from_numpy(g.integers(1, T + 1, size=B).astype(
        np.int32)).to(dev)
    lengths[0] = T
    from asr_craft_tpu_torch.kernels.wall import build_wall
    Wall, u0, u1, _ = build_wall(params, cfg.fmap, ns)
    kw = dict(u0=u0, u1=u1, ns=ns, P=P, precision=precision)
    before = diagnostics.launches()
    paths, scores = fdt_viterbi.fdt_viterbi_cuda(Wall, feats, lengths, **kw)
    ref_paths, ref_scores = fdt_viterbi.fdt_viterbi_wall_torch(
        Wall, feats, lengths, **kw)
    torch.cuda.synchronize()
    assert ran(before)["fdt_viterbi_plane"] > 0
    torch.testing.assert_close(scores, ref_scores, rtol=1e-5, atol=1e-4)
    diff = (paths != ref_paths).any(dim=1)
    if bool(diff.any()):
        planes = plane_blocks(fdt_planes_torch(Wall, feats, u0=u0, u1=u1,
                                               precision=precision), ns, P)
        rescored = fdt.path_score(*planes, paths, lengths, ns)
        torch.testing.assert_close(rescored[diff], ref_scores[diff],
                                   rtol=1e-5, atol=1e-4)
