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
largest entry plus rtol 1e-3.  K11's parts alone, on the same inputs: E and
the messages q as alphas (E within 1e-5 absolute: values <= 1), the running
sums cs equal (the same adds in the same order), F as gt.  Rebased rows
(``scaled``) are held to the same tolerances once their offsets are added
back, in float64.  The max-plus kernel computes single IEEE
operations in the plain version's order: deltas, duration argmaxes, scores,
labels and segment markers are equal bit for bit.
"""
import ctypes

import numpy as np
import pytest
import torch

from asr_craft_tpu_torch import flagship, kernels
from asr_craft_tpu_torch.kernels import segmental as K
from asr_craft_tpu_torch.models import segmental as M
from asr_craft_tpu_torch.ops import segmental_stream as S
from asr_craft_tpu_torch.utils import diagnostics
from launch_counts import ran

pytestmark = pytest.mark.cuda
Z_TOL = dict(rtol=1e-5, atol=2e-3)
G_ATOL = 1e-3
# (B, T, Dmax, L)
SHAPES = [(3, 9, 4, 3), (3, 5, 8, 4), (2, 6, 6, 2), (4, 1, 2, 3),
          (5, 23, 8, 12), (6, 40, 1, 5), (8, 64, 16, 12), (128, 512, 16, 48),
          (3, 70, 16, 144), (3, 37, 5, 7), (3, 50, 20, 33), (3, 40, 16, 150),
          (3, 30, 6, 229)]


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
    before = diagnostics.launches()
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
    assert ran(before) == {"segmental_forward": 1, "segmental_backward": 1,
                           "segmental_grad_message": 2, "segmental_grad": 2,
                           "segmental_grad_contract": 2}
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


@pytest.mark.parametrize("mean_pool", [True, False])
@pytest.mark.parametrize("B,T,Dmax,L", SHAPES)
def test_rebased_kernels_match_plain(dev, B, T, Dmax, L, mean_pool):
    """K9 and K10 rebased (``scaled``) against their rebased plain twins:
    whole-number offsets, rows plus offsets within Z_TOL (a row maximum
    within rounding of a half may round the other way), logZ = zhat +
    off[length - 1] as the kernel adds it; K11 taking the offsets, on the
    plain twins' rows, against the plain K11."""
    args = _problem(dev, B, T, Dmax, L)
    lengths = args[3]
    sa, sz, aoff, zhat = K.segmental_forward_cuda(*args, mean_pool,
                                                  scaled=True)
    sb, boff = K.segmental_backward_cuda(*args, mean_pool, scaled=True)
    ra, rz, raoff, rzhat = K.segmental_forward_plain(*args, mean_pool,
                                                     scaled=True)
    rb, rboff = K.segmental_backward_plain(*args, mean_pool, scaled=True)
    live = (torch.arange(T, device=dev)[None, :] < lengths[:, None].long())
    for off in (aoff, boff):
        assert torch.equal(off, off.round())
    for got, off, want, woff in ((sa, aoff, ra, raoff), (sb, boff, rb,
                                                          rboff)):
        _close((got.double() + off.double()[..., None])[live],
               (want.double() + woff.double()[..., None])[live], **Z_TOL)
    _close(sz, rz, **Z_TOL)
    assert torch.equal(zhat + K.last_row(aoff[..., None], lengths)[:, 0],
                       sz)
    g = torch.from_numpy(np.random.default_rng(1).uniform(
        -1.5, 1.5, B).astype(np.float32)).to(dev)
    grad_in = (ra, rb, rzhat, g, mean_pool, raoff, rboff)
    out = K.segmental_grad_cuda(*args, *grad_in)
    want = K.segmental_grad_plain(*args, *grad_in)
    _close(out[0], want[0], rtol=0.0, atol=G_ATOL)
    _close(out[1], want[1], rtol=0.0, atol=G_ATOL)
    _rel(out[2], want[2])
    _rel(out[3], want[3])


@pytest.mark.parametrize("pooling", ["mean", "sum"])
def test_rebased_gradient_holds_fp32_over_1024_frames(dev, pooling):
    """K9, K10 and K11 rebased, at config 4's widths over 1024 frames
    (logZ ~4e3): A, S, gd and gt within 1e-4 of the float64 plain
    version's, by norm."""
    args = _problem(dev, 4, 1024, 16, 48, seed=4, scale=0.6)
    mean_pool = pooling == "mean"
    d = [x.double() if x.is_floating_point() else x for x in args]
    a64, z64 = K.segmental_forward_plain(*d, mean_pool)
    b64 = K.segmental_backward_plain(*d, mean_pool)
    g = torch.ones(4, device=dev)
    want = K.segmental_grad_plain(*d, a64, b64, z64, g.double(), mean_pool)
    sa, _, aoff, zhat = K.segmental_forward_cuda(*args, mean_pool,
                                                 scaled=True)
    sb, boff = K.segmental_backward_cuda(*args, mean_pool, scaled=True)
    got = K.segmental_grad_cuda(*args, sa, sb, zhat, g, mean_pool, aoff,
                                boff)
    for x, w, what in zip(got, want, "A S gd gt".split()):
        err = float((x.double() - w).norm() / w.norm())
        assert err < 1e-4, (what, err)


@pytest.mark.parametrize("thr", [None, 8.0, 1.0])
@pytest.mark.parametrize("mean_pool", [True, False])
@pytest.mark.parametrize("B,T,Dmax,L", SHAPES)
def test_max_plus_kernels_equal_plain(dev, B, T, Dmax, L, mean_pool, thr):
    args = _problem(dev, B, T, Dmax, L, seed=2)
    before = diagnostics.launches()
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
    assert ran(before) == {"segmental_viterbi": 1,
                           "segmental_viterbi_traceback": 1}
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


@pytest.mark.parametrize("L", [5, 150])
@pytest.mark.parametrize("seed", [0, 1, "flat"])
def test_ties_fall_as_in_the_plain_version_in_deep_windows(dev, seed, L):
    """Dmax = 20, so a lane holds several durations over two passes: integer
    and flat potentials (every candidate ties), sum pooling, exact and under
    a beam: the shortest duration among equal candidates within a lane,
    across the group and across passes, the lowest final label."""
    flat = seed == "flat"
    args = _problem(dev, 16, 40, 20, L, seed=0 if flat else seed,
                    integer=True)
    if flat:
        args = tuple(torch.zeros_like(a) for a in args[:3]) + args[3:]
    for thr in (None, 1.0):
        got = K.segmental_viterbi_cuda(*args, False, thr)
        want = K.segmental_viterbi_plain(*args, False, thr)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), thr
    if flat:
        assert int(got[1].max()) == 0 and int(got[2].max()) == 0


def _ps(L):
    return L + ((8 - L % 32) + 32) % 32


def _frame5_ok(L, Dmax):
    """The three-barrier frame: the factor, two windows and the bias."""
    return 4 * (L * _ps(L) + 3 * Dmax * L + Dmax + 3 * L) <= 232448


def _old_grad_ok(L, Dmax):
    """What K11 took before it was split (its register tiles: L <= 144)."""
    return (4 * (L * _ps(L) + 7 * Dmax * L + 2 * Dmax + 3 * L) <= 232448
            and L <= 144)


@pytest.mark.parametrize("L,Dmax", [(1, 1), (48, 16), (144, 16), (145, 16),
                                    (205, 16), (206, 16), (48, 64),
                                    (48, 300), (160, 100), (229, 6),
                                    (232, 5), (25, 321), (1, 6000)])
def test_kernels_take_the_widths_they_state(dev, L, Dmax):
    """At Dmax = 16: K9-K12 up to L = 205 (the factor and the windows fit
    shared memory), K11 included; a window too deep is refused as well.  K9,
    K10 and K12 take every width the three-barrier frame took (their own
    frame, or that one where only it fits), K11 every width it took before
    it was split."""
    for name in ("segmental_viterbi", "segmental_backward"):
        assert (K.smem_bytes(name, L, Dmax) > 0) == _frame5_ok(L, Dmax)
    fwd = K.smem_bytes("segmental_forward", L, Dmax)
    assert (fwd > 0) == _frame5_ok(L, Dmax)
    assert (K.recursion_frame(L, Dmax) >= 0) == _frame5_ok(L, Dmax)
    grad = K.smem_bytes("segmental_grad", L, Dmax)
    assert 0 <= grad <= 232448
    if _old_grad_ok(L, Dmax):
        assert grad > 0
    if grad:
        assert fwd > 0
    if Dmax == 16:
        assert (grad > 0) == (L <= 205)


WIDTHS = [(L, Dmax) for L in list(range(1, 240, 7)) + [144, 145, 205, 229,
                                                      232]
          for Dmax in (1, 2, 5, 16, 17, 40, 100, 333, 1000, 4000)]


def test_every_width_taken_before_is_taken(dev):
    """Over a grid of widths: K9, K10 and K12 wherever the three-barrier
    frame fits, K11 wherever its old kernel did."""
    for L, Dmax in WIDTHS:
        if _frame5_ok(L, Dmax):
            for name in ("segmental_forward", "segmental_backward",
                         "segmental_viterbi"):
                assert K.smem_bytes(name, L, Dmax) > 0, (name, L, Dmax)
        if _old_grad_ok(L, Dmax):
            assert K.smem_bytes("segmental_grad", L, Dmax) > 0, (L, Dmax)


def _frame_bytes(L, Dmax, qv):
    """K9's frame's shared memory in layout qv: [the factor (L, 16 qv) and
    its maxima (L), if shared][the shared row by parity (2, 16 qv)][two
    slots (Dmax, ws)], ws the padded stride where that fits, else L; 0 if
    neither fits."""
    Lq = 16 * qv
    fixed = (L * (Lq + 1) if qv >= 10 else 0) + 2 * Lq
    for ws in (_ps(L), L):
        if 4 * (fixed + 2 * Dmax * ws) <= 232448:
            return 4 * (fixed + 2 * Dmax * ws)
    return 0


def test_frame_choice_matches_smem_bytes(dev):
    """recursion_frame, the one choice of K9, K10 and K12, against each
    one's shared memory over the same grid: their own frame in the layout
    of L (the factor in registers up to L = 144, shared beyond) where its
    rows and windows fit, the three-barrier frame (its bytes) where only
    that fits, none where neither does."""
    for L, Dmax in WIDTHS:
        frame = K.recursion_frame(L, Dmax)
        qv = next((q for q in (3, 5, 9) if 16 * q >= L), -(-L // 16))
        if not _frame5_ok(L, Dmax):
            want, expect = 0, -1
        elif _frame_bytes(L, Dmax, qv):
            want, expect = _frame_bytes(L, Dmax, qv), qv
        else:
            want = 4 * (L * _ps(L) + 3 * Dmax * L + Dmax + 3 * L)
            expect = 0
        assert frame == expect, (L, Dmax, frame)
        for name in ("segmental_forward", "segmental_backward",
                     "segmental_viterbi"):
            assert K.smem_bytes(name, L, Dmax) == want, (name, L, Dmax)


def test_widest_lattices_match_plain_and_wider_ones_raise(dev):
    args = _problem(dev, 3, 20, 16, 205, seed=3)
    assert K.recursion_frame(205, 16) == 13        # the factor shared
    alphas, logZ = K.segmental_forward_cuda(*args)
    ra, rz = K.segmental_forward_plain(*args)
    _close(alphas, ra, **Z_TOL)
    _close(logZ, rz, **Z_TOL)
    rb = K.segmental_backward_plain(*args)
    _close(K.segmental_backward_cuda(*args), rb, **Z_TOL)
    for x, y in zip(K.segmental_viterbi_cuda(*args),
                    K.segmental_viterbi_plain(*args)):
        assert torch.equal(x, y)
    g = torch.ones_like(rz)
    out = K.segmental_grad_cuda(*args, ra, rb, rz, g)
    want = K.segmental_grad_plain(*args, ra, rb, rz, g)
    _close(out[0], want[0], rtol=0.0, atol=G_ATOL)
    _close(out[1], want[1], rtol=0.0, atol=G_ATOL)
    _rel(out[2], want[2])
    _rel(out[3], want[3])
    before = diagnostics.launches()
    wide = _problem(dev, 2, 8, 16, 206)
    for fn in (K.segmental_forward_cuda, K.segmental_backward_cuda,
               K.segmental_viterbi_cuda):
        with pytest.raises(ValueError, match="L <= 205"):
            fn(*wide)
    w = wide[0]
    with pytest.raises(ValueError, match="L <= 205"):
        K.segmental_grad_cuda(*wide, w, w, w[:, 0, 0], w[:, 0, 0])
    assert diagnostics.launches() == before


def _segments(dev, B, T, L, Dmax, seed, kind):
    """Tied integer deltas (zeros of either sign), integer trans, durations
    at random below Dmax, all one frame or all Dmax frames (each at most
    its frame); lengths 0, 1, T, T + 3 and ragged."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi, shape):
        x = rng.integers(lo, hi, size=shape).astype(np.float32)
        x[x == 0] = np.where(rng.random(int((x == 0).sum())) < 0.5,
                             np.float32(-0.0), np.float32(0.0))
        return x

    deltas, trans = ints(-2, 3, (B, T, L)), ints(-1, 2, (L, L))
    d = {"random": rng.integers(0, Dmax, size=(B, T, L)),
         "one": np.zeros((B, T, L), np.int64),
         "long": np.full((B, T, L), Dmax - 1)}[kind]
    arg_d = np.minimum(d, np.arange(T)[None, :, None]).astype(np.int32)
    lab0 = rng.integers(0, L, size=B).astype(np.int32)
    lengths = rng.integers(0, T + 4, size=B).astype(np.int32)
    lengths[:4] = [0, 1, T, T + 3]
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (deltas, arg_d, trans, lab0, lengths))


@pytest.mark.parametrize("kind", ["random", "one", "long"])
@pytest.mark.parametrize("dT", ["C-1", "C", "C+1", "2C+1"])
@pytest.mark.parametrize("L", [48, 205, 238])
def test_traceback_stream_borders(dev, L, dT, kind):
    """K13's stream blocks of C frames (85 at L = 48, 13 at L = 205; trans^T
    read from device memory at 238): T just below, at and above one block
    and two, one-frame segments and Dmax = 16 frames crossing the borders,
    ties, lengths 0, 1, T, T + 3.  One launch; markers EQUAL."""
    C = K.traceback_plan(L)[0]
    T = {"C-1": max(C - 1, 1), "C": C, "C+1": C + 1, "2C+1": 2 * C + 1}[dT]
    args = _segments(dev, 7, T, L, 16, seed=L + T, kind=kind)
    before = diagnostics.launches()
    got = K.segmental_viterbi_traceback_cuda(*args)
    want = K.segmental_viterbi_traceback_plain(*args)
    torch.cuda.synchronize()
    assert ran(before) == {"segmental_viterbi_traceback": 1}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("skip", [1, 2, 3])
def test_traceback_of_rows_off_a_16_byte_boundary(dev, skip):
    """deltas and arg_d that start 4, 8 or 12 bytes past a 16-byte
    boundary (views into larger buffers)."""
    args = _segments(dev, 6, 45, 23, 8, seed=skip, kind="random")
    views = []
    for x in args[:2]:
        buf = torch.empty(x.numel() + skip, dtype=x.dtype, device=dev)
        views.append(buf[skip:].view(x.shape))
        views[-1].copy_(x)
        assert views[-1].data_ptr() % 16 == 4 * skip
    got = K.segmental_viterbi_traceback_cuda(*views, *args[2:])
    want = K.segmental_viterbi_traceback_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_traceback_plan_agrees_with_the_kernel(dev):
    lib = K._library()
    staged = ctypes.c_int()
    for L in (1, 3, 48, 205, 229, 237, 238, 300, 5000, 9670, 9680):
        C = lib.seg_traceback_frames(L, ctypes.byref(staged))
        assert (C, bool(staged.value) if C else False) == \
            K.traceback_plan(L), L
    L = 9680                            # one frame of the ring: 232,464 B
    z = torch.zeros((2, 3, L), device=dev)
    i = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="does not fit"):
        K.segmental_viterbi_traceback_cuda(
            z, z.int(), torch.zeros((L, L), device=dev), i, i)


FRAMES = [(48, 16, 3), (80, 16, 5), (150, 16, 10), (205, 16, 13),
          (229, 6, 0)]


@pytest.mark.parametrize("L,Dmax,frame", FRAMES)
def test_forward_frames_match_plain(dev, L, Dmax, frame):
    """K9 in each layout: the factor in registers, in shared memory, and
    the three-barrier frame where only its footprint fits."""
    assert K.recursion_frame(L, Dmax) == frame
    args = _problem(dev, 4, 33, Dmax, L, seed=5)
    for mean_pool in (True, False):
        alphas, logZ = K.segmental_forward_cuda(*args, mean_pool)
        ra, rz = K.segmental_forward_plain(*args, mean_pool)
        _close(alphas, ra, **Z_TOL)
        _close(logZ, rz, **Z_TOL)
        assert float(logZ[-1]) <= -1e29          # the empty row


@pytest.mark.parametrize("L,Dmax,frame", FRAMES + [(48, 40, 3),
                                                   (150, 40, 10)])
def test_backward_frames_match_plain(dev, L, Dmax, frame):
    """K10 in each layout (and windows deeper than one pass of 16): betas
    within Z_TOL, 0 at length - 1, NEG_INF at and past the length and in
    the empty row, the same bits on two runs."""
    assert K.recursion_frame(L, Dmax) == frame
    args = _problem(dev, 4, 45, Dmax, L, seed=6)
    lengths = args[3].long()
    for mean_pool in (True, False):
        betas = K.segmental_backward_cuda(*args, mean_pool)
        again = K.segmental_backward_cuda(*args, mean_pool)
        _close(betas, K.segmental_backward_plain(*args, mean_pool), **Z_TOL)
        assert torch.equal(betas, again)
        for row, n in enumerate(lengths.tolist()):
            if n:
                assert float(betas[row, n - 1].abs().max()) == 0.0
            if n < betas.shape[1]:
                assert float(betas[row, n:].max()) <= -1e29


@pytest.mark.parametrize("L,Dmax,frame", FRAMES + [(48, 64, 3),
                                                   (150, 40, 10)])
def test_viterbi_frames_match_plain(dev, L, Dmax, frame):
    """K12 in each layout (and windows deeper than one pass of 16): deltas,
    arg_d, lab0 and scores equal to the plain version, exact and under two
    beams, both poolings; then K13's markers on them."""
    assert K.recursion_frame(L, Dmax) == frame
    args = _problem(dev, 4, 70, Dmax, L, seed=7)
    for mean_pool in (True, False):
        for thr in (None, 8.0, 1.0):
            got = K.segmental_viterbi_cuda(*args, mean_pool, thr)
            want = K.segmental_viterbi_plain(*args, mean_pool, thr)
            for x, y in zip(got, want):
                assert x.dtype == y.dtype and torch.equal(x, y), thr
            tb = K.segmental_viterbi_traceback_cuda(got[0], got[1], args[1],
                                                    got[2], args[3])
            rtb = K.segmental_viterbi_traceback_plain(
                want[0], want[1], args[1], want[2], args[3])
            assert torch.equal(tb[0], rtb[0]) and torch.equal(tb[1], rtb[1])
    assert float(got[3][-1]) <= -1e29 and int(got[2][-1]) == 0


def _config4(dev, pooling, seed=0):
    args = _problem(dev, 128, 512, 16, 48, seed=seed)
    mean_pool = pooling == "mean"
    ra, rz = K.segmental_forward_plain(*args, mean_pool)
    rb = K.segmental_backward_plain(*args, mean_pool)
    g = torch.from_numpy(np.random.default_rng(seed).uniform(
        -1.5, 1.5, 128).astype(np.float32)).to(dev)
    return args, mean_pool, (ra, rb, rz, g)


@pytest.mark.parametrize("pooling", ["mean", "sum"])
def test_grad_parts_match_plain_at_config4(dev, pooling):
    """K11's message pass, xi pass and contraction, each against its plain
    version on the same inputs, at B=128, T=512, L=48, Dmax=16 (ragged, an
    empty row)."""
    args, mean_pool, (ra, rb, rz, g) = _config4(dev, pooling)
    frame, trans, bias, lengths = args
    live = (torch.arange(512, device=dev)[None, :]
            < lengths[:, None].long())
    E, q, cs, m = K.segmental_grad_message_cuda(frame, trans, bias, lengths,
                                                ra)
    rE, rq, rcs, rm = K.segmental_grad_message_plain(frame, trans, bias,
                                                     lengths, ra)
    _close(E, rE, rtol=0.0, atol=1e-5)
    _close(q[live], rq[live], **Z_TOL)
    _close(m[live], rm[live], rtol=0.0, atol=0.0)
    assert torch.equal(cs[live], rcs[live])
    A, S, F, gd = K.segmental_grad_xi_cuda(rq, rcs, rm, rb, rz, g, bias,
                                           lengths, mean_pool)
    rA, rS, rF, rgd = K.segmental_grad_xi_plain(rq, rcs, rm, rb, rz, g, bias,
                                                lengths, mean_pool)
    _close(A, rA, rtol=0.0, atol=G_ATOL)
    _close(S, rS, rtol=0.0, atol=G_ATOL)
    _rel(F[..., :48], rF[..., :48])
    _rel(gd, rgd)
    gt = K.segmental_grad_contract_cuda(rE, rF, 48)
    _rel(gt, K.segmental_grad_contract_plain(rE, rF, 48))
    assert float(A[-1].abs().max()) == float(S[-1].abs().max()) == 0.0
    assert float(F[-1].abs().max()) == 0.0


@pytest.mark.parametrize("pooling", ["mean", "sum"])
def test_backward_matches_plain_at_config4(dev, pooling):
    """K10 at B=128, T=512, L=48, Dmax=16 (ragged, an empty row): one launch
    a call, betas within Z_TOL of the plain version, the same bits on two
    runs."""
    args, mean_pool, (_, rb, _, _) = _config4(dev, pooling, seed=2)
    before = diagnostics.launches()
    betas = K.segmental_backward_cuda(*args, mean_pool)
    again = K.segmental_backward_cuda(*args, mean_pool)
    assert ran(before) == {"segmental_backward": 2}
    _close(betas, rb, **Z_TOL)
    assert torch.equal(betas, again)


@pytest.mark.parametrize("L,Dmax", [(48, 16), (229, 6)])
def test_wrappers_launch_their_kernel_alone(dev, L, Dmax):
    """K9's frame forms the factor and invd inside K9, K10 and K12: each
    wrapper launches one kernel (a torch.profiler trace of its call); PR
    5's frame, at the widths only it fits, takes them from the wrapper."""
    from asr_craft_tpu_torch.bench import device_busy
    args = _problem(dev, 8, 64, Dmax, L, seed=8)
    own = K.recursion_frame(L, Dmax) > 0
    for fn in (K.segmental_forward_cuda, K.segmental_backward_cuda,
               K.segmental_viterbi_cuda):
        rec = device_busy(lambda: fn(*args), dev, 2)
        assert rec is not None, "the trace holds no device time"
        assert (rec["kernels"] == 1) == own, (fn.__name__, rec["top"])


@pytest.mark.parametrize("pooling", ["mean", "sum"])
def test_grad_and_forward_match_plain_at_config4(dev, pooling):
    """K11 whole and K9 at config 4; K11 the same bits on two runs."""
    args, mean_pool, grad_in = _config4(dev, pooling, seed=1)
    alphas, logZ = K.segmental_forward_cuda(*args, mean_pool)
    _close(alphas, grad_in[0], **Z_TOL)
    _close(logZ, grad_in[2], **Z_TOL)
    out = K.segmental_grad_cuda(*args, *grad_in, mean_pool)
    again = K.segmental_grad_cuda(*args, *grad_in, mean_pool)
    want = K.segmental_grad_plain(*args, *grad_in, mean_pool)
    _close(out[0], want[0], rtol=0.0, atol=G_ATOL)
    _close(out[1], want[1], rtol=0.0, atol=G_ATOL)
    _rel(out[2], want[2])
    _rel(out[3], want[3])
    assert all(torch.equal(x, y) for x, y in zip(out, again))


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
    before = diagnostics.launches()
    got = M.scrf_decode(cfg, params, batch["feats"], batch["lengths"])
    launched = ran(before)
    assert launched["segmental_viterbi"] == 1
    assert launched["segmental_viterbi_traceback"] == 1
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
