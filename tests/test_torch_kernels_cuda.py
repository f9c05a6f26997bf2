"""The K3 CUDA kernels against their plain PyTorch version, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these tests skip on a
host without an NVIDIA GPU.  On one, from the repository root (the JAX-free
port needs no conftest, and the GPU machine may have no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Paths must be equal (exact-arithmetic tie cases) or equal up to the
near-tie rule; scores allclose at rtol=1e-5, atol=1e-4 (the kernel's
sequential fp32 FMAs sum the planes in another order than cuBLAS).
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch.kernels.fdt_viterbi import (fdt_viterbi_cuda,
                                                     fdt_viterbi_wall_torch,
                                                     launches)
from asr_craft_tpu_torch.kernels.wall import build_wall, wall_planes
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.ops import fdt

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
    before = dict(launches)
    paths, scores = fdt_viterbi_cuda(Wall, feats, lengths, **kw, **beams)
    ref_paths, ref_scores = fdt_viterbi_wall_torch(Wall, feats, lengths,
                                                   **kw, **beams)
    torch.cuda.synchronize()
    assert launches["fdt_viterbi_fwd"] == before["fdt_viterbi_fwd"] + 1
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
def test_kernel_matches_plain(dev, P, ns, mode):
    Wall, feats, lengths, kw = _problem(dev, P, ns, seed=P + ns)
    _compare(Wall, feats, lengths, kw, MODES[mode], exact_paths=False)


@pytest.mark.parametrize("integer", [False, True], ids=["zero", "integer"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ns", [1, 3])
def test_kernel_tie_order(dev, ns, mode, integer):
    Wall, feats, lengths, kw = _problem(dev, 5, ns, seed=ns, integer=integer)
    if not integer:
        Wall = torch.zeros_like(Wall)
    _compare(Wall, feats, lengths, kw, MODES[mode], exact_paths=True)


def test_traceback_kernel_exact_on_plain_backpointers(dev):
    from asr_craft_tpu_torch.kernels.fdt_viterbi import (
        viterbi_traceback_cuda)
    Wall, feats, lengths, kw = _problem(dev, 6, 3, seed=9)
    bp, last, _ = fdt.fdt_viterbi_forward(
        *wall_planes(Wall, feats, kw["u0"], kw["u1"], 3, 6), lengths, 3)
    got = viterbi_traceback_cuda(bp, last, lengths)
    assert torch.equal(got, fdt.fdt_viterbi_traceback(bp, last, lengths))


def test_kernel_refuses_what_it_does_not_take(dev):
    Wall, feats, lengths, kw = _problem(dev, 5, 3)
    with pytest.raises(ValueError, match="P <= 128"):
        fdt_viterbi_cuda(Wall, feats, lengths, **{**kw, "P": 129})
    with pytest.raises(ValueError, match="int32"):
        fdt_viterbi_cuda(Wall, feats, lengths.long(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fdt_viterbi_cuda(Wall, feats.transpose(0, 1).contiguous()
                         .transpose(0, 1), lengths, **kw)
