"""The K1/K2 training kernels against their plain PyTorch versions, on the
card: the plane kernel, K1's recursion, K2's recursion and contraction.

Marked ``cuda``: the kernels have no CPU mode, so these tests skip on a
host without an NVIDIA GPU.  On one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda_train.py -q

Tolerances: ``zf``/``zc`` and alphas at rtol=1e-5, atol=1e-4
(log-partitions summed over up to 33 frames; the plane kernel sums in
3xTF32 where the plain version takes cuBLAS's fp32 product, and the
recursion takes a three-way lse and a shuffle tree where the plain loop
chains logaddexp).
``dWall``/``dfeats`` and K2's ``dplane`` at rtol=1e-4, atol=1e-4 (sums
of posteriors times features over B*T frames, accumulated in another order
by the contraction kernel than by cuBLAS; the posteriors, gated by exp(s -
z), s - z a difference of two such sums).  At the ``triphone-train``
cell's shape (B=128, T=512) ``dplane`` at atol=1e-3, ``chip_smoke.py``'s
bar there: s and z are sums over up to 512 frames of ~2.5e3 magnitude.
The tensor-core products (planes, dWall, dfeats; 3xTF32) against the float64 product within 1e-5 of the sum
of the terms' magnitudes: 3xTF32 keeps ~2^-21 of each term, and a lost
or doubled tile or chunk exceeds the bar many times over.
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch.kernels import fdt_train as K
from asr_craft_tpu_torch.kernels.wall import SMEM_LIMIT, build_wall
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.utils import diagnostics
from launch_counts import moved, ran

pytestmark = pytest.mark.cuda
Z_TOL = dict(rtol=1e-5, atol=1e-4)
G_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, P, ns, clamp_ns, B=5, T=33, D=12, seed=0, lengths=None):
    """Ragged lengths with a full first and an empty last row, topology-
    legal labels (phone runs of ns+1 frames; at clamp_ns=1 the state walk
    [0, 0, 1, .., ns-1] of each run), and row 1 cut to 2 frames inside its
    first run, so with boundaries its clamped lattice is dead; or the
    ``lengths`` given."""
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
    if lengths is None:
        lengths = rng.integers(ns + 1, T + 1, size=B)
        lengths[0], lengths[1], lengths[-1] = T, 2, 0
    lengths = np.asarray(lengths)
    params = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    Wall, u0, u1, dims = build_wall(params, cfg.fmap, ns)
    kw = dict(u0=u0, u1=u1, ns=ns, P=P, clamp_ns=clamp_ns, boundaries=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (Wall.contiguous(), t(feats), t(labels.astype(np.int32)),
            t(lengths.astype(np.int32)), kw)


@pytest.mark.parametrize("clamp", ["phone", "state"])
@pytest.mark.parametrize("P,ns", [(5, 1), (5, 3), (8, 3), (128, 3), (128, 1),
                                  (48, 3)])
def test_kernels_match_plain(dev, P, ns, clamp):
    clamp_ns = ns if clamp == "phone" else 1
    Wall, feats, labels, lengths, kw = _problem(dev, P, ns, clamp_ns,
                                                seed=P + ns)
    before = diagnostics.launches()
    alphas, zf, zc, planes = K.fdt_forward_cuda(Wall, feats, labels,
                                                lengths, **kw)
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
                                      want_dfeats=True, planes=planes)
    rdW, rdX = K.fdt_backward_grad_wall_torch(Wall, feats, labels, lengths,
                                              ra, rzf, rzc, wf, wc, **kw,
                                              want_dfeats=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(dW, rdW, **G_TOL)
    torch.testing.assert_close(dX, rdX, **G_TOL)
    assert float(dX[-1].abs().max()) == 0.0          # the empty row
    assert ran(before) == {"fdt_train_fwd": 1, "fdt_train_plane": 1,
                            "fdt_train_bwd": 1, "fdt_train_contract": 2}


def test_dead_lattice_gets_zero_gradient(dev):
    """A row whose both lattices are dead contributes nothing."""
    Wall, feats, labels, lengths, kw = _problem(dev, 5, 3, 3)
    alphas, zf, zc, _ = K.fdt_forward_cuda(Wall, feats, labels, lengths,
                                           **kw)
    dead = torch.full_like(zf, -1e30)
    dW = K.fdt_backward_grad_cuda(Wall, feats, labels, lengths, alphas,
                                  dead, dead, torch.ones_like(zf),
                                  torch.ones_like(zf), **kw)
    assert float(dW.abs().max()) == 0.0


def test_autograd_function_matches_plain(dev):
    """FdtNllDual on CUDA tensors (kernels) vs the same Function on the
    same inputs moved to the CPU (plain versions); on the card a forward
    and backward forms the planes once."""
    Wall, feats, labels, lengths, kw = _problem(dev, 6, 3, 3, seed=3)
    grads = []
    for d in (dev, torch.device("cpu")):
        W = Wall.detach().to(d).requires_grad_(True)
        x = feats.detach().to(d).requires_grad_(True)
        before = diagnostics.launches()
        zf, zc = K.fdt_nll_dual_wall(W, x, labels.to(d), lengths.to(d),
                                     **kw, grad_feats=True)
        (2.0 * zf.sum() - zc[zc > -1e29].sum()).backward()
        grads.append((W.grad.cpu(), x.grad.cpu()))
        assert ran(before) == ({"fdt_train_fwd": 1, "fdt_train_plane": 1,
                                 "fdt_train_bwd": 1, "fdt_train_contract": 2}
                                if d == dev else {})
    torch.testing.assert_close(grads[0][0], grads[1][0], **G_TOL)
    torch.testing.assert_close(grads[0][1], grads[1][1], **G_TOL)


def _dplane_twice(grad_args, kw, planes):
    """Two calls of K2's recursion, each into memory the allocator last
    held as NaN (an entry the kernel leaves unwritten shows), and what they
    moved of the launch counters."""
    B, T, _ = planes.shape
    shape = (B, T, grad_args[0].shape[0])
    before = diagnostics.launches()
    outs = []
    for _ in range(2):
        torch.full(shape, float("nan"), device=planes.device)
        outs.append(K.fdt_dplane_cuda(*grad_args, **kw, planes=planes))
    torch.cuda.synchronize()
    return outs, moved(before)


@pytest.mark.parametrize("lengths", ["ragged", "empty", "one", "full"])
@pytest.mark.parametrize("clamp", ["phone", "state"])
@pytest.mark.parametrize("P,ns", [(5, 1), (5, 3), (8, 3), (128, 3), (128, 1)])
def test_backward_recursion_matches_plain(dev, P, ns, clamp, lengths):
    """K2's recursion on the plane kernel's planes against its plain
    version, on ragged rows (T; 2, its clamped lattice dead; drawn; 0) and
    on rows all of length 0, 1 or T; at P=128, ns=3 through the shallowest
    ring (two rows).  Two calls give the same bits, each one launch counted
    with its ring's depth."""
    clamp_ns = ns if clamp == "phone" else 1
    T = 33
    given = {"ragged": None, "empty": [0] * 5, "one": [1] * 5,
             "full": [T] * 5}[lengths]
    Wall, feats, labels, lens, kw = _problem(dev, P, ns, clamp_ns, T=T,
                                             seed=3 * P + ns,
                                             lengths=given)
    ra, rzf, rzc = K.fdt_forward_wall_torch(Wall, feats, labels, lens, **kw)
    wf = torch.linspace(0.5, 1.5, len(rzf), device=dev)
    wc = -torch.linspace(1.0, 2.0, len(rzf), device=dev)
    grad_args = (Wall, feats, labels, lens, ra, rzf, rzc, wf, wc)
    planes = K.fdt_planes_cuda(Wall, feats, u0=kw["u0"], u1=kw["u1"])
    (d1, d2), counts = _dplane_twice(grad_args, kw, planes)
    stages = K.backward_stages(K._library(), ns, P)
    assert stages == 2 if (P, ns) == (128, 3) else stages > 2
    assert counts == {f"kernels.fdt_train_bwd[ring{stages}]": 2}
    assert torch.equal(d1, d2)
    torch.testing.assert_close(d1, K.fdt_dplane_wall_torch(*grad_args, **kw),
                               **G_TOL)


@pytest.mark.parametrize("clamp", ["phone", "state"])
def test_backward_recursion_at_the_cell_shape(dev, clamp):
    """K2 at ``triphone-train``'s widest batches: B=128, T=512, P=48, ns=3,
    rows of 257-512 frames as the T=512 bucket holds them, and a full row,
    a row of one frame, row 1 of 5 frames (its last frame opens a phone
    run, so its clamped lattice is dead) and three empty rows (a bucket's
    last batch is filled with them), against
    the plain version; the same bits on two calls; frames past a row's
    length and frame 0's transitions exactly zero."""
    B, T, P, ns = 128, 512, 48, 3
    clamp_ns = ns if clamp == "phone" else 1
    lengths = np.random.default_rng(5).integers(257, T + 1, size=B)
    lengths[0], lengths[1], lengths[2] = T, 5, 1
    lengths[-3:] = 0
    Wall, feats, labels, lens, kw = _problem(dev, P, ns, clamp_ns, B=B, T=T,
                                             seed=11, lengths=lengths)
    ra, rzf, rzc = K.fdt_forward_wall_torch(Wall, feats, labels, lens, **kw)
    assert float(rzc[1]) < -1e29 < float(rzf[1])     # one lattice dead
    wf = torch.linspace(0.5, 1.5, B, device=dev)
    wc = -torch.linspace(1.0, 2.0, B, device=dev)
    grad_args = (Wall, feats, labels, lens, ra, rzf, rzc, wf, wc)
    planes = K.fdt_planes_cuda(Wall, feats, u0=kw["u0"], u1=kw["u1"])
    (d1, d2), counts = _dplane_twice(grad_args, kw, planes)
    assert counts == {f"kernels.fdt_train_bwd[ring{K.BWD_RING}]": 2}
    assert torch.equal(d1, d2)
    Lp = ns * P
    assert not d1[:, 0, Lp:].any()
    for b, n in enumerate(lengths):
        assert not d1[b, n:].any()
    ref = K.fdt_dplane_wall_torch(*grad_args, **kw)
    torch.testing.assert_close(d1, ref, rtol=0.0, atol=1e-3)


def test_backward_stages_fit_every_width(dev):
    """The ring's rule against the kernel's own layout: between two rows
    and BWD_RING, within a block's shared memory, and as deep as it
    allows, for every P <= 128 and ns <= 8."""
    lib = K._library()
    for P in range(1, 129):
        for ns in range(1, 9):
            stages = K.backward_stages(lib, ns, P)
            assert 2 <= stages <= K.BWD_RING, (P, ns)
            assert lib.fdt_train_bwd_smem_bytes(ns, P, stages) <= SMEM_LIMIT
            if stages < K.BWD_RING:
                assert lib.fdt_train_bwd_smem_bytes(ns, P, stages + 1) \
                    > SMEM_LIMIT


@pytest.mark.parametrize("clamp", ["phone", "state"])
@pytest.mark.parametrize("P,ns", [(5, 1), (5, 3), (8, 3), (128, 3)])
def test_forward_recursion_matches_plain_on_the_same_planes(dev, P, ns,
                                                            clamp):
    """K1's recursion alone against its plain planes-in version on the
    plane kernel's planes: only the recursion's arithmetic differs.  The
    empty last row still reports the lse of its frame 0."""
    clamp_ns = ns if clamp == "phone" else 1
    Wall, feats, labels, lengths, kw = _problem(dev, P, ns, clamp_ns,
                                                seed=2 * P + ns)
    planes = K.fdt_planes_cuda(Wall, feats, u0=kw.pop("u0"), u1=kw.pop("u1"))
    before = diagnostics.launches()
    alphas, zf, zc = K.fdt_forward_planes_cuda(planes, labels, lengths, **kw)
    torch.cuda.synchronize()
    assert ran(before) == {"fdt_train_fwd": 1}
    ra, rzf, rzc = K.fdt_forward_planes_torch(planes, labels, lengths, **kw)
    torch.testing.assert_close(alphas, ra, **Z_TOL)
    torch.testing.assert_close(zf, rzf, **Z_TOL)
    torch.testing.assert_close(zc, rzc, **Z_TOL)
    assert int(lengths[-1]) == 0 and torch.isfinite(zf[-1])
    # a length-0 row carries its frame-0 alpha to every frame
    assert torch.equal(alphas[-1], alphas[-1, :1].expand_as(alphas[-1]))


def _within(got, want, mag):
    """|got - want| <= 1e-5 of the terms' magnitude, everywhere."""
    return bool(((got.double() - want).abs() <= 1e-5 * mag).all())


@pytest.mark.parametrize("B,T,D,u0,u1,P,ns", [
    (5, 33, 12, 2, 12, 5, 3),       # B T = 165: part tiles; 4-byte copies
    (3, 50, 20, 4, 17, 8, 3),       # Du = 13 (a part depth step), u0 = 4
    (2, 64, 144, 0, 144, 48, 3),    # the flagship's widths
    (1, 24, 16, 0, 16, 128, 3),     # P = 128: R = 17,536
    (4, 7, 9, 1, 8, 6, 1)])         # ns = 1, R = 54 (a padded row)
def test_plane_kernel_matches_plain(dev, B, T, D, u0, u1, P, ns):
    """Every frame's plane, in rows of R4 = R rounded up to 4 (pad 0)."""
    g = torch.Generator().manual_seed(B * T + P)
    R = 3 * ns * P + P * P
    Wall = torch.randn((R, u1 - u0 + 1), generator=g).to(dev)
    feats = torch.randn((B, T, D), generator=g).to(dev)
    before = diagnostics.launches()
    planes = K.fdt_planes_cuda(Wall, feats, u0=u0, u1=u1)
    torch.cuda.synchronize()
    assert ran(before) == {"fdt_train_plane": 1}
    assert planes.shape == (B, T, -(-R // 4) * 4)
    ref = K.fdt_planes_torch(Wall.double(), feats.double(), u0=u0, u1=u1)
    mag = K.fdt_planes_torch(Wall.double().abs(), feats.double().abs(),
                             u0=u0, u1=u1)
    assert _within(planes[..., :R], ref, mag)
    assert not planes[..., R:].any()


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("N", [4095, 3 * 4096 + 17, 20 * 4096])
def test_contraction_chunks_sum_to_the_product(dev, N, mode):
    """dWall's split of the frames (1, 3 and the cap of 16 chunks) gives
    dplane^T [x; 1], the same bits on every run (mode 0); dfeats =
    dplane Wall[:, :Du] lands in columns u0..u0+Du alone (mode 1).  Held
    to the float64 product within 1e-5 of the sum of the terms'
    magnitudes, which a lost or doubled chunk exceeds many times over."""
    g = torch.Generator().manual_seed(N)
    R, D, u0, Du = 300, 20, 2, 15
    dplane = torch.randn((1, N, R), generator=g).to(dev)
    feats = torch.randn((1, N, D), generator=g).to(dev)
    Wall = torch.randn((R, Du + 1), generator=g).to(dev)
    src = feats if mode == 0 else Wall
    outs = []
    for _ in range(2):
        before = diagnostics.launches()
        out = (torch.full((R, Du + 1), float("nan"), device=dev) if mode == 0
               else torch.zeros_like(feats))
        outs.append(K.contract_cuda(dplane, src, out, mode=mode, D=D, u0=u0,
                                    Du=Du))
        assert ran(before) == {"fdt_train_contract": 1}
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    d64 = lambda x: x.double()
    a64 = lambda x: x.double().abs()
    ref, mag = (K.contract_wall_torch(f(dplane), f(feats) if mode == 0
                                      else (f(Wall), f(feats)), mode=mode,
                                      u0=u0, u1=u0 + Du) for f in (d64, a64))
    assert _within(outs[0], ref, mag)


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
    alphas, zf, zc, _ = K.fdt_forward_cuda(Wall, feats, labels, lengths,
                                           **kw)
    with pytest.raises(ValueError, match="alphas"):
        K.fdt_backward_grad_cuda(Wall, feats, labels, lengths,
                                 alphas[:, :-1].contiguous(), zf, zc, zf,
                                 zc, **kw)


# --- the bf16x3 and default precisions -------------------------------------
# The plain versions (ops.precision.kernel_matmul) round the operands as the
# kernels do, so every product of the two is exact in fp32 and the two
# differ only in the order of their fp32 sums: each is held to the float64
# sum of the same rounded products within 1e-5 of the terms' magnitudes.

PRECISIONS = ["bf16x3", "default"]


def _rounded(x, precision):
    """The fp32 operand terms the kernel multiplies: [x] (highest: x itself,
    3xTF32 keeping fp32's accuracy; default: tf32(x)), or for bf16x3 (hi,
    lo) with the pairs hi.hi + hi.lo + lo.hi."""
    from asr_craft_tpu_torch.ops import precision as prec
    if precision == "highest":
        return [x]
    if precision == "default":
        return [prec.round_tf32(x)]
    return list(prec.split_bf16(x))


def _ref64(fn, a, b, precision):
    """(float64 sum of the rounded products, float64 sum of their
    magnitudes) of the bilinear ``fn``."""
    ra, rb = _rounded(a, precision), _rounded(b, precision)
    pairs = ([(0, 0)] if precision in ("default", "highest")
             else [(0, 0), (0, 1), (1, 0)])
    ref = sum(fn(ra[i].double(), rb[j].double()) for i, j in pairs)
    mag = sum(fn(ra[i].double().abs(), rb[j].double().abs())
              for i, j in pairs)
    return ref, mag


@pytest.mark.parametrize("precision", ["highest"] + PRECISIONS)
@pytest.mark.parametrize("B,T,D,u0,u1,P,ns", [
    (5, 33, 12, 2, 12, 5, 3),       # part tiles; 4-byte copies
    (3, 50, 20, 4, 17, 8, 3),       # Du = 13: a depth not a multiple of 16
    (128, 512, 144, 0, 144, 48, 3),     # the flagship step's planes
    (1, 24, 16, 0, 16, 128, 3),     # P = 128: R = 17,536
    (64, 512, 144, 0, 144, 48, 3),      # the flagship decode's planes
    (16, 1024, 144, 0, 144, 48, 3),     # T = 1024
    (5, 41, 144, 0, 144, 48, 3),    # N = 205: a tile's second 64 frames 13
    (3, 100, 144, 0, 144, 48, 3)])  # N = 300: a tile's second 64 frames 0
def test_plane_kernel_precisions_match_plain(dev, precision, B, T, D, u0,
                                             u1, P, ns):
    """The plane kernel at highest (3xTF32), bf16x3 (bf16 products) and
    default (one TF32 pass) against the same rounded products, and the
    plain version (fdt_planes_torch) within the same bar; the same bits on
    two calls; 16-byte aligned rows of frames take the wgmma path, the
    others the mma.sync tiles (the counter
    ``kernels.fdt_train_plane[<path>]``)."""
    g = torch.Generator().manual_seed(B * T + P)
    R = 3 * ns * P + P * P
    Wall = torch.randn((R, u1 - u0 + 1), generator=g).to(dev)
    feats = torch.randn((B, T, D), generator=g).to(dev)
    before = diagnostics.launches()
    planes = K.fdt_planes_cuda(Wall, feats, u0=u0, u1=u1,
                               precision=precision)
    torch.cuda.synchronize()
    assert ran(before) == {"fdt_train_plane": 1}
    again = K.fdt_planes_cuda(Wall, feats, u0=u0, u1=u1,
                              precision=precision)
    assert torch.equal(again, planes)
    aligned = D % 4 == 0 and u0 % 4 == 0 and (u1 - u0) % 4 == 0
    path = "wgmma" if aligned else "mma_sync"
    assert moved(before) == {f"kernels.fdt_train_plane[{path}]": 2}
    xu = K.feats_xu(feats, u0, u1)
    ref, mag = _ref64(lambda a, b: a @ b.T, xu, Wall, precision)
    assert _within(planes[..., :R], ref, mag)
    assert not planes[..., R:].any()
    plain = K.fdt_planes_torch(Wall, feats, u0=u0, u1=u1,
                               precision=precision)
    assert _within(plain, ref, mag)
    if precision != "highest":
        # the mode changes the numbers: a kernel that ignored it would not
        # meet both bars
        high = K.fdt_planes_cuda(Wall, feats, u0=u0, u1=u1)
        assert not torch.equal(high[..., :R], planes[..., :R])


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("N,R,D,u0,Du", [
    (3 * 4096 + 17, 300, 20, 2, 15),
    (65536, 2736, 144, 0, 144),          # the flagship step's dplane
    (24, 17536, 16, 0, 16)])             # P = 128
def test_contraction_precisions_match_plain(dev, precision, mode, N, R, D,
                                            u0, Du):
    """dWall (mode 0, the bias column the rounded dplane's column sums) and
    dfeats (mode 1) at bf16x3 and default, against the same rounded
    products; the same bits on every run."""
    g = torch.Generator().manual_seed(N + mode)
    dplane = torch.randn((1, N, R), generator=g).to(dev)
    feats = torch.randn((1, N, D), generator=g).to(dev)
    Wall = torch.randn((R, Du + 1), generator=g).to(dev)
    outs = []
    for _ in range(2):
        out = (torch.full((R, Du + 1), float("nan"), device=dev)
               if mode == 0 else torch.zeros_like(feats))
        outs.append(K.contract_cuda(dplane, feats if mode == 0 else Wall,
                                    out, mode=mode, D=D, u0=u0, Du=Du,
                                    precision=precision))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    if mode == 0:
        ref, mag = _ref64(lambda a, b: a.T @ b, dplane[0],
                          K.feats_xu(feats, u0, u0 + Du)[0], precision)
        got = outs[0]
        src = feats
    else:
        ref, mag = _ref64(lambda a, b: a @ b, dplane[0], Wall[:, :Du],
                          precision)
        got = outs[0][0, :, u0:u0 + Du]
        src = (Wall, feats)
    assert _within(got, ref, mag)
    plain = K.contract_wall_torch(dplane, src, mode=mode, u0=u0,
                                  u1=u0 + Du, precision=precision)
    if mode == 1:
        plain = plain[0, :, u0:u0 + Du]
    assert _within(plain, ref, mag)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_train_kernels_at_each_precision_match_plain(dev, precision):
    """K1 and K2 (planes, recursions, contraction) through FdtNllDual at
    bf16x3 and default against the plain versions at the same precision:
    the tolerances of the fp32 kernels above, but for dWall at default.
    There the contraction rounds dplane to TF32, and the kernel's and the
    plain recursion's dplane differ in their last fp32 bits, so an entry
    next to a rounding boundary rounds to a neighbouring TF32 value: each
    term of dWall may move by 2^-10 of its magnitude, which bounds the
    difference (against the float64 sum of the terms' magnitudes)."""
    Wall, feats, labels, lengths, kw = _problem(dev, 8, 3, 3, seed=7)
    W1 = Wall.clone().requires_grad_(True)
    zf, zc = K.fdt_nll_dual_wall(W1, feats, labels, lengths, **kw,
                                 precision=precision)
    (zf.sum() - 0.5 * zc.sum()).backward()
    rzf, rzc = K.fdt_forward_wall_torch(Wall, feats, labels, lengths, **kw,
                                        precision=precision)[1:]
    torch.testing.assert_close(zf, rzf, **Z_TOL)
    torch.testing.assert_close(zc, rzc, **Z_TOL)
    alphas = K.fdt_forward_wall_torch(Wall, feats, labels, lengths, **kw,
                                      precision=precision)[0]
    ones = torch.ones_like(zf)
    dWall = K.fdt_backward_grad_wall_torch(
        Wall, feats, labels, lengths, alphas, rzf, rzc, ones, -0.5 * ones,
        **kw, precision=precision)
    if precision == "bf16x3":
        torch.testing.assert_close(W1.grad, dWall, **G_TOL)
        return
    dplane = K.fdt_dplane_wall_torch(Wall, feats, labels, lengths, alphas,
                                     rzf, rzc, ones, -0.5 * ones, **kw,
                                     precision=precision)
    mag = K.contract_wall_torch(dplane.double().abs(), feats.double().abs(),
                                mode=0, u0=kw["u0"], u1=kw["u1"])
    assert bool(((W1.grad.double() - dWall.double()).abs()
                 <= 2.0 ** -10 * mag + 1e-6).all())
