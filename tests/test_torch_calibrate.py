"""K15 on the CPU: the plain version of the calibration chain against a
numpy float32 loop of the TPU kernel's body
(``asr_craft_tpu/utils/roofline.py``, the inner ``kernel`` of
``measure_vpu_geps_pallas``) written out here.  The JAX function itself
returns None on a CPU before it builds its kernel, which is asserted too.

Tolerance.  numpy and PyTorch both round the multiply and the add
separately in float32; their ``exp`` may differ in the last place (6e-8
relative on values in (0, 1]), and the chain is a contraction, so the gap
never grows: atol 5e-7.
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu.utils import roofline as jrl
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import calibrate as K
from asr_craft_tpu_torch.utils import roofline as rl
from asr_craft_tpu_torch.utils import diagnostics

ATOL = 5e-7


def _body(x, Dmax, passes, steps):
    """The TPU kernel's body: a (Dmax, Ls, Bk) buffer filled from x, then
    per step, per pass, ``exp(z * -0.5)`` on every eighth pass and ``z *
    0.999 + 1e-4`` otherwise."""
    buf = np.broadcast_to(x, (Dmax,) + x.shape).astype(np.float32).copy()
    for _ in range(steps):
        z = buf
        for p in range(passes):
            if p % 8 == 7:
                z = np.exp(z * np.float32(-0.5), dtype=np.float32)
            else:
                z = z * np.float32(0.999) + np.float32(1e-4)
        buf = z
    return buf


@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 1), (4, 6, 5, 16, 2),
                                   (16, 48, 8, 16, 2), (3, 5, 7, 9, 40),
                                   (2, 4, 3, 7, 3), (5, 2, 2, 0, 4),
                                   (5, 2, 2, 16, 0)], ids=str)
def test_plain_matches_the_tpu_body(shape):
    Dmax, Ls, Bk, passes, steps = shape
    x = np.random.default_rng(0).uniform(0, 1, size=(Ls, Bk)).astype(
        np.float32)
    got = K.calibrate_chain_plain(torch.from_numpy(x), Dmax, passes, steps)
    want = _body(x, Dmax, passes, steps)
    assert got.shape == (Dmax, Ls, Bk) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert torch.equal(got, got[:1].expand_as(got))     # every slot alike
    # the dispatcher takes the plain version for a CPU tensor
    before = diagnostics.launches()
    again = K.calibrate_chain(torch.from_numpy(x), Dmax, passes, steps)
    assert torch.equal(again, got) and diagnostics.launches() == before


def test_the_chain_is_a_contraction():
    """Eight operations shrink a difference by more than half, so two
    roundings of the same chain cannot drift apart."""
    a = torch.tensor([[0.05, 0.9]])
    b = a + 1e-3
    fa, fb = (K.calibrate_chain_plain(v, 1, 8, 1) for v in (a, b))
    assert float((fa - fb).abs().max()) < 0.5e-3
    settled = K.calibrate_chain_plain(a, 1, 16, 40)
    assert float(settled.max() - settled.min()) < ATOL


def test_jax_function_returns_none_on_a_cpu():
    assert jrl.measure_vpu_geps_pallas() is None


def test_cuda_backend_on_a_cpu_tensor_raises():
    x = torch.full((4, 3), 0.1)
    before = diagnostics.launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.calibrate_chain_cuda(x, 2, 8, 1)
    kernels.set_backend("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensor"):
            K.calibrate_chain(x, 2, 8, 1)
        with pytest.raises(ValueError, match="CUDA tensor"):
            K.measure(Dmax=2, Ls=4, Bk=3, device="cpu")
        with pytest.raises(ValueError, match="CUDA tensor"):
            rl.measure_vpu_geps_pallas(Dmax=2, Ls=4, Bk=3, device="cpu")
    finally:
        kernels.set_backend("auto")
    assert diagnostics.launches() == before


def test_measure_on_the_cpu_says_plain():
    """On the CPU the record names the plain version and the short chain it
    timed; the rate follows from that time and is never called a kernel's."""
    rec = K.measure(Dmax=4, Ls=6, Bk=5, passes=16, device="cpu",
                    plain_steps=3)
    assert rec["calibration"] == "plain" and rec["launches"] == 0
    assert rec["steps"] == 3 and rec["device"] == "cpu"
    want = 3 * 16 * 4 * 6 * 5 / (rec["ms_per_launch"] / 1e3) / 1e9
    assert rec["geps"] == pytest.approx(want) and rec["geps"] > 0
    assert rl.measure_vpu_geps_pallas(Dmax=4, Ls=6, Bk=5, device="cpu") > 0


def test_window_must_fit_shared_memory():
    assert 4 * 16 * 48 < K.SMEM_LIMIT == 232448
    assert (K.LO_N, K.HI_N) == (2, 6)          # the JAX function's lo_n, hi_n
