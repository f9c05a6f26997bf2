"""The K9-K13 CUDA kernels (the segmental CRF recursions) against their plain
PyTorch versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these tests skip on a
host without an NVIDIA GPU.  On one, from the repository root:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_cuda_segmental.py -q

Tolerances.  The log-semiring kernels split each sum over four lanes, may
fuse a multiply-add and take ``expf`` / ``logf`` where the plain version
takes a cuBLAS product and ``torch.exp`` / ``torch.log``: alphas, betas and
logZ (magnitude up to ~1e3 at T = 512, fp32 ulp 6e-5 there) within rtol
1e-5, atol 2e-3; A and S (posteriors scaled by |g| <= 1.5, each the exp of
a difference of such sums) within atol 1e-3; gd and gt within 1e-4 of their
largest entry plus rtol 1e-3.  The max-plus kernel computes single IEEE
operations in the plain version's order: deltas, duration argmaxes, scores,
labels and segment markers are equal bit for bit.
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch import flagship, kernels
from asr_craft_tpu_torch.kernels import segmental as K
from asr_craft_tpu_torch.models import segmental as M
from asr_craft_tpu_torch.ops import segmental_stream as S

pytestmark = pytest.mark.cuda
Z_TOL = dict(rtol=1e-5, atol=2e-3)
G_ATOL = 1e-3
# (B, T, Dmax, L)
SHAPES = [(3, 9, 4, 3), (3, 5, 8, 4), (2, 6, 6, 2), (4, 1, 2, 3),
          (5, 23, 8, 12), (6, 40, 1, 5), (8, 64, 16, 12), (128, 512, 16, 48),
          (3, 70, 16, 144), (3, 37, 5, 7)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, B, T, Dmax, L, seed=0, scale=0.7, integer=False):
    """Frame scores, bias, transitions and ragged lengths: row 0 full, the
    last row (of three or more) empty."""
    rng = np.random.default_rng(seed)
    if integer:
        draw = lambda *s: rng.integers(-2, 3, size=s).astype(np.float32)
    else:
        draw = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    frame, bias, trans = draw(B, T, L), draw(Dmax, L), draw(L, L)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    if B > 2:
        lengths[-1] = 0
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (frame, trans, bias, lengths))


def _close(got, want, **tol):
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, **tol), float((got - want).abs().max())


def _rel(got, want):
    _close(got, want, rtol=1e-3, atol=1e-4 * max(float(want.abs().max()),
                                                 1e-30))


@pytest.mark.parametrize("mean_pool", [True, False])
@pytest.mark.parametrize("B,T,Dmax,L", SHAPES)
def test_log_semiring_kernels_match_plain(dev, B, T, Dmax, L, mean_pool):
    args = _problem(dev, B, T, Dmax, L)
    before = dict(K.launches)
    alphas, logZ = K.segmental_forward_cuda(*args, mean_pool)
    betas = K.segmental_backward_cuda(*args, mean_pool)
    ra, rz = K.segmental_forward_plain(*args, mean_pool)
    rb = K.segmental_backward_plain(*args, mean_pool)
    _close(alphas, ra, **Z_TOL)
    _close(logZ, rz, **Z_TOL)
    _close(betas, rb, **Z_TOL)
    g = torch.from_numpy(np.random.default_rng(1).uniform(
        -1.5, 1.5, B).astype(np.float32)).to(dev)
    grad_in = (ra.contiguous(), rb.contiguous(), rz.contiguous(), g)
    out = K.segmental_grad_cuda(*args, *grad_in, mean_pool)
    again = K.segmental_grad_cuda(*args, *grad_in, mean_pool)
    torch.cuda.synchronize()
    assert K.launches["segmental_forward"] == before["segmental_forward"] + 1
    assert K.launches["segmental_backward"] == \
        before["segmental_backward"] + 1
    assert K.launches["segmental_grad"] == before["segmental_grad"] + 2
    rA, rS, rgd, rgt = K.segmental_grad_plain(*args, *grad_in, mean_pool)
    _close(out[0], rA, rtol=0.0, atol=G_ATOL)
    _close(out[1], rS, rtol=0.0, atol=G_ATOL)
    _rel(out[2], rgd)
    _rel(out[3], rgt)
    # the same bits on every run: no atomics, a fixed summation order
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    # the empty row has no gradient
    if B > 2:
        assert float(out[0][-1].abs().max()) == 0.0
        assert float(out[1][-1].abs().max()) == 0.0


@pytest.mark.parametrize("thr", [None, 8.0, 1.0])
@pytest.mark.parametrize("mean_pool", [True, False])
@pytest.mark.parametrize("B,T,Dmax,L", SHAPES)
def test_max_plus_kernels_equal_plain(dev, B, T, Dmax, L, mean_pool, thr):
    args = _problem(dev, B, T, Dmax, L, seed=2)
    before = dict(K.launches)
    got = K.segmental_viterbi_cuda(*args, mean_pool, thr)
    want = K.segmental_viterbi_plain(*args, mean_pool, thr)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    trans, lengths = args[1], args[3]
    tb = K.segmental_viterbi_traceback_cuda(got[0], got[1], trans, got[2],
                                            lengths)
    rtb = K.segmental_viterbi_traceback_plain(want[0], want[1], trans,
                                              want[2], lengths)
    torch.cuda.synchronize()
    assert K.launches["segmental_viterbi"] == before["segmental_viterbi"] + 1
    assert K.launches["segmental_viterbi_traceback"] == \
        before["segmental_viterbi_traceback"] + 1
    assert torch.equal(tb[0], rtb[0]) and torch.equal(tb[1], rtb[1])
    for x, y in zip(S._pack_segment_markers(*tb),
                    S._pack_segment_markers(*rtb)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ties_fall_as_in_the_plain_version(dev, seed):
    """Integer potentials and sum pooling: the shortest duration among equal
    candidates, the lowest predecessor, the lowest final label."""
    args = _problem(dev, 16, 30, 4, 5, seed=seed, integer=True)
    got = K.segmental_viterbi_cuda(*args, False, 1.0)
    want = K.segmental_viterbi_plain(*args, False, 1.0)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    tb = K.segmental_viterbi_traceback_cuda(got[0], got[1], args[1], got[2],
                                            args[3])
    rtb = K.segmental_viterbi_traceback_plain(want[0], want[1], args[1],
                                              want[2], args[3])
    assert torch.equal(tb[0], rtb[0]) and torch.equal(tb[1], rtb[1])


@pytest.mark.parametrize("L,Dmax", [(1, 1), (48, 16), (144, 16), (145, 16),
                                    (205, 16), (206, 16), (48, 64),
                                    (48, 300), (160, 100)])
def test_kernels_take_the_widths_they_state(dev, L, Dmax):
    """At Dmax = 16: K9, K10 and K12 up to L = 205 (the factor and the
    windows fit shared memory), K11 up to L = 144 (its tiles cover the
    partial); a window too deep is refused as well."""
    ps = L + ((8 - L % 32) + 32) % 32
    small = 4 * (L * ps + 3 * Dmax * L + Dmax + 3 * L)
    big = 4 * (L * ps + 7 * Dmax * L + 2 * Dmax + 3 * L)
    for name in ("segmental_forward", "segmental_viterbi",
                 "segmental_backward"):
        n = K.smem_bytes(name, L, Dmax)
        assert n == (small if small <= 232448 else 0)
    n = K.smem_bytes("segmental_grad", L, Dmax)
    assert n == (big if big <= 232448 and L <= 144 else 0)
    assert (K.smem_bytes("segmental_forward", L, 16) > 0) == (L <= 205)


def test_widest_lattices_match_plain_and_wider_ones_raise(dev):
    args = _problem(dev, 3, 20, 16, 205, seed=3)
    alphas, logZ = K.segmental_forward_cuda(*args)
    ra, rz = K.segmental_forward_plain(*args)
    _close(alphas, ra, **Z_TOL)
    _close(logZ, rz, **Z_TOL)
    _close(K.segmental_backward_cuda(*args),
           K.segmental_backward_plain(*args), **Z_TOL)
    for x, y in zip(K.segmental_viterbi_cuda(*args),
                    K.segmental_viterbi_plain(*args)):
        assert torch.equal(x, y)
    before = dict(K.launches)
    with pytest.raises(ValueError, match="L <= 144"):
        K.segmental_grad_cuda(*args, ra, ra, rz, rz)
    wide = _problem(dev, 2, 8, 16, 206)
    for fn in (K.segmental_forward_cuda, K.segmental_backward_cuda,
               K.segmental_viterbi_cuda):
        with pytest.raises(ValueError, match="L <= 205"):
            fn(*wide)
    assert K.launches == before


@pytest.mark.parametrize("pooling", ["mean", "sum"])
def test_scrf_loss_gradients_kernel_vs_plain(dev, pooling):
    """scrf_loss_fused end to end: the K9-K11 path against the plain path
    (backend 'torch') on every parameter gradient."""
    cfg = M.SegCrfConfig(num_labels=48, feat_dim=144, max_dur=16,
                         pooling=pooling)
    batch = flagship.scrf_batch(cfg, 16, 128, 3, dev, ragged=True)
    params = cfg.init_params(torch.Generator().manual_seed(3), 0.05, dev)
    out = {}
    for backend in ("auto", "torch"):
        kernels.set_backend(backend)
        try:
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            loss, aux = M.scrf_loss_fused(cfg, p, batch["feats"],
                                          batch["labels"], batch["lengths"])
            loss.backward()
            out[backend] = (loss.detach(), {k: v.grad for k, v in p.items()})
        finally:
            kernels.set_backend("auto")
    (lk, gk), (lp, gp) = out["auto"], out["torch"]
    assert 0.0 < float(lk) < 1e3
    _close(lk, lp, rtol=1e-5, atol=0.0)
    for k in gk:
        _rel(gk[k], gp[k])


def test_decode_on_the_card_equals_the_plain_decode(dev):
    cfg = flagship.scrf()
    batch = flagship.scrf_batch(cfg, 16, 128, 4, dev, ragged=True)
    params = cfg.init_params(torch.Generator().manual_seed(4), 0.05, dev)
    before = dict(K.launches)
    got = M.scrf_decode(cfg, params, batch["feats"], batch["lengths"])
    assert K.launches["segmental_viterbi"] == before["segmental_viterbi"] + 1
    assert K.launches["segmental_viterbi_traceback"] == \
        before["segmental_viterbi_traceback"] + 1
    kernels.set_backend("torch")
    try:
        want = M.scrf_decode(cfg, params, batch["feats"], batch["lengths"])
    finally:
        kernels.set_backend("auto")
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert int(got[2][-1]) == 0 and int(got[2][0]) > 0


def test_cpu_tensor_raises_in_the_kernel_wrappers(dev):
    args = _problem(torch.device("cpu"), 2, 8, 3, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.segmental_forward_cuda(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.segmental_viterbi_cuda(*args)
