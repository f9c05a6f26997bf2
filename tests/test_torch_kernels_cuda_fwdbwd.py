"""The K4, K5, K6a, K6b and K14 CUDA kernels (shared-transition
forward-backward) against their plain PyTorch versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these tests skip on a
host without an NVIDIA GPU.  On one, from the repository root:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_cuda_fwdbwd.py -q

Tolerances.  The kernels split each sum over four lanes and take ``expf`` /
``logf`` where the plain version takes a cuBLAS product and ``torch.exp``
/ ``torch.log``: alphas, betas and logZ (magnitude up to ~1e3 at T = 512,
fp32 ulp 6e-5 there) within rtol 1e-5, atol 2e-3; g_state (posteriors
scaled by |w| <= 1.5, each the exp of a difference of such sums, so ~1e-4
relative at worst) within atol 1e-3; UV within 1e-4 of its largest entry
plus rtol 1e-3.
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import fwdbwd as K
from asr_craft_tpu_torch.models import crf
from asr_craft_tpu_torch.models.topology import Topology
from asr_craft_tpu_torch.ops import mxu

pytestmark = pytest.mark.cuda
Z_TOL = dict(rtol=1e-5, atol=2e-3)
G_ATOL = 1e-3
SHAPES = [(5, 1, 6, 29), (48, 1, 8, 64), (42, 1, 128, 512), (4, 3, 6, 29),
          (23, 3, 5, 33), (46, 3, 128, 512), (48, 3, 3, 20)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, P, ns, B, T, seed=0, state_labels=False, scale=1.0):
    """Potentials with the topology folded in, topology-legal labels (phone
    runs of 4 frames, or their state walks), ragged lengths: row 0 full,
    row 1 cut inside a run (for ns > 1 its clamped lattice is dead), the
    last row empty, and row 2 labelled with a phone no state admits."""
    rng = np.random.default_rng(seed)
    L = P * ns
    state = (scale * rng.normal(size=(B, T, L))).astype(np.float32)
    trans = rng.normal(size=(L, L), scale=0.5).astype(np.float32)
    lengths = (rng.integers(1, T // 4 + 1, size=B) * 4).astype(np.int32)
    lengths[0], lengths[1], lengths[-1] = T, 6, 0
    labels = np.repeat(rng.integers(0, P, size=(B, T // 4 + 1)), 4,
                       axis=1)[:, :T]
    if B > 2:
        labels[2] = P + 3
    if state_labels:
        labels = labels * ns + np.tile([0] * (4 - ns) + list(range(ns)),
                                       T // 4 + 1)[None, :T]
    if ns > 1:
        topo = Topology(P, ns)
        trans = trans + topo.transition_penalty()
        state[:, 0] += topo.start_penalty()
        for b in range(B):
            if lengths[b] > 0:
                state[b, lengths[b] - 1] += topo.end_penalty()
    to = lambda a: torch.from_numpy(a).to(dev)
    return (to(state), to(trans), to(labels.astype(np.int32)), to(lengths))


def _close(got, want, **tol):
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, **tol), float((got - want).abs().max())


@pytest.mark.parametrize("P,ns,B,T", SHAPES)
def test_single_lattice_kernels_match_plain(dev, P, ns, B, T):
    state, trans, _, lengths = _problem(dev, P, ns, B, T)
    before = dict(K.launches)
    alphas, z = K.forward_cuda(state, trans, lengths)
    betas = K.backward_cuda(state, trans, lengths)
    torch.cuda.synchronize()
    assert K.launches["forward"] == before["forward"] + 1
    assert K.launches["backward"] == before["backward"] + 1
    ra, rz = K.forward_plain(state, trans, lengths)
    _close(alphas, ra, **Z_TOL)
    _close(z, rz, **Z_TOL)
    _close(betas, K.backward_plain(state, trans, lengths), **Z_TOL)


@pytest.mark.parametrize("state_labels", [False, True])
@pytest.mark.parametrize("P,ns,B,T", SHAPES)
def test_dual_kernels_match_plain(dev, P, ns, B, T, state_labels):
    state, trans, labels, lengths = _problem(dev, P, ns, B, T, 1,
                                             state_labels)
    cns = 1 if state_labels else ns
    args = (state, trans, labels, lengths)
    before = dict(K.launches)
    af, ac, zf, zc = K.forward_dual_cuda(*args, cns)
    bf, bc = K.backward_dual_cuda(*args, cns)
    raf, rac, rzf, rzc = K.forward_dual_plain(*args, cns)
    rbf, rbc = K.backward_dual_plain(*args, cns)
    for got, want in ((af, raf), (ac, rac), (zf, rzf), (zc, rzc), (bf, rbf),
                      (bc, rbc)):
        _close(got, want, **Z_TOL)
    # row 2's label admits no state: its clamped lattice is dead
    assert float(zc[2]) < -1e29 < float(zf[2])
    rng = np.random.default_rng(2)
    wf = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32)).to(dev)
    wc = -torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32)).to(
        dev)
    grad_in = (raf.contiguous(), rac.contiguous(), rzf.contiguous(),
               rzc.contiguous(), wf, wc)
    g_state, UV = K.backward_dual_grad_cuda(*args, *grad_in, cns)
    g_again, UV_again = K.backward_dual_grad_cuda(*args, *grad_in, cns)
    torch.cuda.synchronize()
    for name in ("forward_dual", "backward_dual"):
        assert K.launches[name] == before[name] + 1
    assert K.launches["backward_dual_grad"] == \
        before["backward_dual_grad"] + 2
    rg, rUV = K.backward_dual_grad_plain(*args, *grad_in, cns)
    _close(g_state, rg, rtol=0.0, atol=G_ATOL)
    _close(UV, rUV, rtol=1e-3, atol=1e-4 * float(rUV.abs().max()))
    # the same bits on every run: no atomics, a fixed summation order
    assert torch.equal(UV, UV_again) and torch.equal(g_state, g_again)
    # the empty row has no gradient
    assert float(g_state[-1].abs().max()) == 0.0


def test_dead_clamped_lattice_gives_zero_gradient(dev):
    """A row whose labels no state admits, weighted on the clamped lattice
    alone: g_state and UV are exactly zero, and nothing is NaN."""
    state, trans, labels, lengths = _problem(dev, 46, 3, 4, 64)
    one = lambda x: x[2:3].contiguous()
    args = (one(state), trans, one(labels), one(lengths))
    af, ac, zf, zc = K.forward_dual_cuda(*args, 3)
    g_state, UV = K.backward_dual_grad_cuda(
        *args, af, ac, zf, zc, torch.zeros_like(zf), torch.ones_like(zf), 3)
    torch.cuda.synchronize()
    assert float(zc) < -1e29
    assert float(g_state.abs().max()) == 0.0 and float(UV.abs().max()) == 0.0


@pytest.mark.parametrize("L", [1, 48, 138, 144, 145, 232, 233, 390])
def test_kernels_take_the_widths_they_state(dev, L):
    """Every kernel up to L = 232 (the factor fits shared memory), the fused
    gradient up to L = 144 (its register tiles cover the partial)."""
    for n_lat in (1, 2):
        for forward in (True, False):
            n = K.smem_bytes(L, n_lat, False, forward)
            assert (0 < n <= 232448) if L <= 232 else n == 0
    n = K.smem_bytes(L, 2, True, False)
    assert (0 < n <= 232448) if L <= 144 else n == 0


def test_widest_lattices_match_plain_and_wider_ones_raise(dev):
    state, trans, labels, lengths = _problem(dev, 232, 1, 3, 12)
    args = (state, trans, labels, lengths)
    alphas, z = K.forward_cuda(state, trans, lengths)
    ra, rz = K.forward_plain(state, trans, lengths)
    _close(alphas, ra, **Z_TOL)
    _close(z, rz, **Z_TOL)
    _close(K.backward_cuda(state, trans, lengths),
           K.backward_plain(state, trans, lengths), **Z_TOL)
    af, ac, zf, zc = K.forward_dual_cuda(*args, 1)
    for got, want in zip((af, ac, zf, zc), K.forward_dual_plain(*args, 1)):
        _close(got, want, **Z_TOL)
    for got, want in zip(K.backward_dual_cuda(*args, 1),
                         K.backward_dual_plain(*args, 1)):
        _close(got, want, **Z_TOL)
    before = dict(K.launches)
    with pytest.raises(ValueError, match="L <= 144"):
        K.backward_dual_grad_cuda(*args, af, ac, zf, zc, zf, zc, 1)
    wide = _problem(dev, 233, 1, 2, 8)
    with pytest.raises(ValueError, match="L <= 232"):
        K.forward_cuda(wide[0], wide[1], wide[3])
    with pytest.raises(ValueError, match="L <= 232"):
        K.backward_dual_cuda(*wide, 1)
    assert K.launches == before


@pytest.mark.parametrize("kind", ["phone", "state"])
@pytest.mark.parametrize("P,ns", [(48, 1), (42, 1), (46, 3)])
def test_crf_loss_gradients_kernel_vs_plain(dev, P, ns, kind):
    """The shared crf_loss end to end: the K4/K5 path against the plain
    path (backend 'torch') on every parameter gradient."""
    if kind == "state" and ns == 1:
        pytest.skip("state labels are phone labels for one state")
    cfg = crf.CrfConfig(num_labels=P, feat_dim=P * 3, num_states=ns)
    B, T = 16, 128
    rng = np.random.default_rng(3)
    params = {k: torch.from_numpy(rng.normal(size=s, scale=0.1).astype(
        np.float32)).to(dev) for k, s in cfg.fmap.param_shapes().items()}
    feats = torch.from_numpy(rng.normal(size=(B, T, P * 3)).astype(
        np.float32)).to(dev)
    _, _, labels, lengths = _problem(dev, P, ns, B, T, 4, kind == "state")
    labels[2] = labels[3]
    lengths[1] = 8
    out = {}
    for backend in ("auto", "torch"):
        kernels.set_backend(backend)
        try:
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            loss, aux = crf.crf_loss(cfg, p, feats, labels, lengths,
                                     label_kind=kind)
            loss.backward()
            out[backend] = (loss.detach(), {k: v.grad for k, v in p.items()})
        finally:
            kernels.set_backend("auto")
    (lk, gk), (lp, gp) = out["auto"], out["torch"]
    assert abs(float(lk)) < 1e3
    _close(lk, lp, rtol=1e-5, atol=0.0)
    for k in gk:
        _close(gk[k], gp[k], rtol=1e-3,
               atol=1e-4 * float(gp[k].abs().max()))


def test_posteriors_and_log_partition_on_the_card(dev):
    state, trans, _, lengths = _problem(dev, 46, 3, 8, 64, 5)
    post = mxu.posteriors_mxu(state, trans, lengths)
    kernels.set_backend("torch")
    try:
        ref = mxu.posteriors_mxu(state, trans, lengths)
    finally:
        kernels.set_backend("auto")
    _close(post, ref, rtol=0.0, atol=1e-3)
    sums = post.sum(-1)
    valid = (torch.arange(64, device=dev)[None, :] < lengths[:, None])
    assert torch.allclose(sums[valid], torch.ones_like(sums[valid]),
                          atol=1e-3)
    s = state.clone().requires_grad_(True)
    tr = trans.clone().requires_grad_(True)
    before = dict(K.launches)
    mxu.log_partition_mxu(s, tr, lengths).sum().backward()
    assert K.launches["forward"] == before["forward"] + 1
    assert K.launches["backward"] == before["backward"] + 1
    assert torch.isfinite(s.grad).all() and torch.isfinite(tr.grad).all()


def test_cpu_tensor_raises_in_the_kernel_wrappers(dev):
    state, trans, labels, lengths = _problem(torch.device("cpu"), 4, 1, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.forward_cuda(state, trans, lengths)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.backward_dual_cuda(state, trans, labels, lengths, 1)
