"""The K15 CUDA kernel (the in-kernel elementwise calibration) against its
plain PyTorch version, on the card.

Marked ``cuda``: the kernel has no CPU mode, so these tests skip on a host
without an NVIDIA GPU.  On one, from the repository root:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_cuda_calibrate.py -q

Tolerance.  nvcc contracts ``z * 0.999 + 1e-4`` into one fused multiply-add
where PyTorch rounds twice, and the two ``expf`` may differ in the last
place: a few 1e-8 relative an operation on values in (0, 1].  The chain is a
contraction (eight operations shrink a difference by more than half), so the
gap stays at that size whatever the chain's length: atol 2e-6.
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import calibrate as K
from asr_craft_tpu_torch.utils import diagnostics

pytestmark = pytest.mark.cuda
ATOL = 2e-6
# (Dmax, Ls, Bk, passes, steps)
SHAPES = [(1, 1, 1, 1, 1), (16, 48, 128, 16, 2), (8, 48, 128, 16, 64),
          (3, 5, 7, 9, 4), (16, 48, 4, 7, 3), (2, 300, 3, 16, 2),
          (16, 48, 128, 16, 0), (4, 12, 2, 0, 5), (64, 205, 2, 8, 3)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _x(dev, Ls, Bk, seed=0):
    x = np.random.default_rng(seed).uniform(0.0, 1.0, size=(Ls, Bk))
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def _count():
    """K15's launches so far: its counter, ``kernels.calibrate``."""
    return diagnostics.launches().get(K.COUNTER, 0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain(dev, shape):
    Dmax, Ls, Bk, passes, steps = shape
    x = _x(dev, Ls, Bk)
    before = _count()
    got = K.calibrate_chain_cuda(x, Dmax, passes, steps)
    torch.cuda.synchronize()
    assert _count() == before + 1
    want = K.calibrate_chain_plain(x, Dmax, passes, steps)
    assert got.shape == (Dmax, Ls, Bk) and torch.isfinite(got).all()
    assert torch.allclose(got, want, rtol=0.0, atol=ATOL), \
        float((got - want).abs().max())
    # every slot was worked on, and all alike
    assert torch.equal(got, got[:1].expand_as(got))
    if steps == 0 or passes == 0:
        assert torch.equal(got[0], x)


def test_long_chain_settles_where_the_plain_version_does(dev):
    """The default chain's length (8192 steps) on a narrow window, where the
    plain version is still affordable at 256 steps: both have settled on the
    chain's fixed cycle by then."""
    x = _x(dev, 48, 2, seed=1)
    got = K.calibrate_chain_cuda(x, 4, 16, 8192)
    want = K.calibrate_chain_plain(x, 4, 16, 256)
    assert torch.allclose(got, want, rtol=0.0, atol=ATOL)
    assert float(got.max() - got.min()) < ATOL


def test_dispatch_and_refusals(dev):
    x = _x(dev, 48, 8)
    before = _count()
    out = K.calibrate_chain(x, 16, 16, 2)                     # auto: kernel
    assert out.is_cuda and _count() == before + 1
    kernels.set_backend("torch")
    try:
        plain = K.calibrate_chain(x, 16, 16, 2)
    finally:
        kernels.set_backend("auto")
    assert _count() == before + 1
    assert torch.allclose(out, plain, rtol=0.0, atol=ATOL)
    with pytest.raises(ValueError, match="shared memory"):
        K.calibrate_chain_cuda(_x(dev, 4000, 2), 16, 16, 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.calibrate_chain_cuda(_x(dev, 8, 48).T, 16, 16, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.calibrate_chain_cuda(x.cpu(), 16, 16, 1)
    assert _count() == before + 1


def test_measure_runs_the_kernel(dev):
    """A short calibration: the record names the kernel, counts its
    launches, and the rate follows from the time it reports."""
    before = _count()
    rec = K.measure(grid_n=4, frames=8, reps=2, device=dev)
    assert rec["calibration"] == "kernel" and rec["steps"] == 32
    assert rec["launches"] == _count() - before == \
        K.LO_N + K.HI_N + 2 * (K.LO_N + K.HI_N)
    want = 32 * 16 * 16 * 48 * 128 / (rec["ms_per_launch"] / 1e3) / 1e9
    assert rec["geps"] == pytest.approx(want)
    assert 0.0 < rec["geps"] < 33500.0
