"""The K1/K2 training kernels against their plain PyTorch versions, on the
card.

Marked ``cuda``: the kernels have no CPU mode, so these tests skip on a
host without an NVIDIA GPU.  On one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda_train.py -q

Tolerances: ``zf``/``zc`` at rtol=1e-5, atol=1e-4 (log-partitions summed
over up to 33 frames; the kernel forms planes with sequential fp32 FMAs
and takes a three-way lse where the plain loop chains logaddexp).
``dWall``/``dfeats`` at rtol=1e-4, atol=1e-4 (sums of posteriors times
features over B*T frames, accumulated in another order by the
contraction kernel than by cuBLAS).
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch.kernels import fdt_train as K
from asr_craft_tpu_torch.kernels.wall import build_wall
from asr_craft_tpu_torch.models.crf import CrfConfig

pytestmark = pytest.mark.cuda
Z_TOL = dict(rtol=1e-5, atol=1e-4)
G_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, P, ns, clamp_ns, B=5, T=33, D=12, seed=0):
    """Ragged lengths with a full first and an empty last row, topology-
    legal labels (phone runs of ns+1 frames; at clamp_ns=1 the state walk
    [0, 0, 1, .., ns-1] of each run), and row 1 cut to 2 frames inside its
    first run, so with boundaries its clamped lattice is dead."""
    cfg = CrfConfig(num_labels=P, feat_dim=D, num_states=ns,
                    state_range=(0, D - 2), trans_range=(2, D))
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s, scale=0.3).astype(np.float32)
              for k, s in cfg.fmap.param_shapes().items()}
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    run = ns + 1
    labels = np.repeat(rng.integers(0, P, size=(B, T // run + 1)), run,
                       axis=1)[:, :T]
    if clamp_ns == 1:
        steps = np.asarray([0] + list(range(ns)))
        labels = labels * ns + np.tile(steps, T // run + 1)[None, :T]
    lengths = rng.integers(ns + 1, T + 1, size=B)
    lengths[0], lengths[1], lengths[-1] = T, 2, 0
    params = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    Wall, u0, u1, dims = build_wall(params, cfg.fmap, ns)
    kw = dict(u0=u0, u1=u1, ns=ns, P=P, clamp_ns=clamp_ns, boundaries=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (Wall.contiguous(), t(feats), t(labels.astype(np.int32)),
            t(lengths.astype(np.int32)), kw)


@pytest.mark.parametrize("clamp", ["phone", "state"])
@pytest.mark.parametrize("P,ns", [(5, 1), (5, 3), (8, 3), (128, 3)])
def test_kernels_match_plain(dev, P, ns, clamp):
    clamp_ns = ns if clamp == "phone" else 1
    Wall, feats, labels, lengths, kw = _problem(dev, P, ns, clamp_ns,
                                                seed=P + ns)
    before = dict(K.launches)
    alphas, zf, zc = K.fdt_forward_cuda(Wall, feats, labels, lengths, **kw)
    ra, rzf, rzc = K.fdt_forward_wall_torch(Wall, feats, labels, lengths,
                                            **kw)
    torch.testing.assert_close(zf, rzf, **Z_TOL)
    torch.testing.assert_close(zc, rzc, **Z_TOL)
    if ns > 1:
        assert zc[1] < -1e29                 # the dead clamped lattice
    wf = torch.linspace(0.5, 1.5, len(zf), device=dev)
    wc = -torch.linspace(1.0, 2.0, len(zf), device=dev)
    dW, dX = K.fdt_backward_grad_cuda(Wall, feats, labels, lengths, alphas,
                                      zf, zc, wf, wc, **kw,
                                      want_dfeats=True)
    rdW, rdX = K.fdt_backward_grad_wall_torch(Wall, feats, labels, lengths,
                                              ra, rzf, rzc, wf, wc, **kw,
                                              want_dfeats=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(dW, rdW, **G_TOL)
    torch.testing.assert_close(dX, rdX, **G_TOL)
    assert float(dX[-1].abs().max()) == 0.0          # the empty row
    assert K.launches["fdt_train_fwd"] == before["fdt_train_fwd"] + 1
    assert K.launches["fdt_train_bwd"] == before["fdt_train_bwd"] + 1
    assert (K.launches["fdt_train_contract"]
            == before["fdt_train_contract"] + 2)


def test_dead_lattice_gets_zero_gradient(dev):
    """A row whose both lattices are dead contributes nothing."""
    Wall, feats, labels, lengths, kw = _problem(dev, 5, 3, 3)
    alphas, zf, zc = K.fdt_forward_cuda(Wall, feats, labels, lengths, **kw)
    dead = torch.full_like(zf, -1e30)
    dW = K.fdt_backward_grad_cuda(Wall, feats, labels, lengths, alphas,
                                  dead, dead, torch.ones_like(zf),
                                  torch.ones_like(zf), **kw)
    assert float(dW.abs().max()) == 0.0


def test_autograd_function_matches_plain(dev):
    """FdtNllDual on CUDA tensors (kernels) vs the same Function on the
    same inputs moved to the CPU (plain versions)."""
    Wall, feats, labels, lengths, kw = _problem(dev, 6, 3, 3, seed=3)
    grads = []
    for d in (dev, torch.device("cpu")):
        W = Wall.detach().to(d).requires_grad_(True)
        x = feats.detach().to(d).requires_grad_(True)
        zf, zc = K.fdt_nll_dual_wall(W, x, labels.to(d), lengths.to(d),
                                     **kw, grad_feats=True)
        (2.0 * zf.sum() - zc[zc > -1e29].sum()).backward()
        grads.append((W.grad.cpu(), x.grad.cpu()))
    torch.testing.assert_close(grads[0][0], grads[1][0], **G_TOL)
    torch.testing.assert_close(grads[0][1], grads[1][1], **G_TOL)


@pytest.mark.parametrize("N", [4095, 3 * 4096 + 17, 20 * 4096])
def test_contraction_chunks_sum_to_the_product(dev, N):
    """dWall's split of the frames (1, 3 and the cap of 16 chunks) gives
    dplane^T [x; 1], the same on every run.  Held to the float64 product
    within 1e-5 of the sum of the terms' magnitudes, which a lost or
    doubled chunk exceeds many times over."""
    g = torch.Generator().manual_seed(N)
    R, D, u0, Du = 300, 20, 2, 15
    dplane = torch.randn((1, N, R), generator=g).to(dev)
    feats = torch.randn((1, N, D), generator=g).to(dev)
    outs = []
    for _ in range(2):
        before = K.launches["fdt_train_contract"]
        out = torch.full((R, Du + 1), float("nan"), device=dev)
        outs.append(K.contract_cuda(dplane, feats, out, mode=0, D=D, u0=u0,
                                    Du=Du))
        assert K.launches["fdt_train_contract"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    ref = K.contract_wall_torch(dplane.double(), feats.double(), mode=0,
                                u0=u0, u1=u0 + Du)
    mag = K.contract_wall_torch(dplane.double().abs(), feats.double().abs(),
                                mode=0, u0=u0, u1=u0 + Du)
    assert bool(((outs[0].double() - ref).abs() <= 1e-5 * mag).all())


def test_kernels_refuse_what_they_do_not_take(dev):
    Wall, feats, labels, lengths, kw = _problem(dev, 5, 3, 3)
    with pytest.raises(ValueError, match="P <= 128"):
        K.fdt_forward_cuda(Wall, feats, labels, lengths, **{**kw, "P": 129})
    with pytest.raises(ValueError, match="int32"):
        K.fdt_forward_cuda(Wall, feats, labels.long(), lengths, **kw)
    with pytest.raises(ValueError, match="float32"):
        K.fdt_forward_cuda(Wall, feats.double(), labels, lengths, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        K.fdt_forward_cuda(Wall, feats.transpose(0, 1).contiguous()
                           .transpose(0, 1), labels, lengths, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fdt_forward_cuda(Wall, feats.cpu(), labels, lengths, **kw)
    with pytest.raises(ValueError, match="Wall shape"):
        K.fdt_forward_cuda(Wall[:-1].contiguous(), feats, labels, lengths,
                           **kw)
    with pytest.raises(ValueError, match="clamp_ns"):
        K.fdt_forward_cuda(Wall, feats, labels, lengths,
                           **{**kw, "clamp_ns": 2})
    alphas, zf, zc = K.fdt_forward_cuda(Wall, feats, labels, lengths, **kw)
    with pytest.raises(ValueError, match="alphas"):
        K.fdt_backward_grad_cuda(Wall, feats, labels, lengths,
                                 alphas[:, :-1].contiguous(), zf, zc, zf,
                                 zc, **kw)
