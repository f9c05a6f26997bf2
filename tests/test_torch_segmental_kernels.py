"""The plain versions of K9-K13 (``kernels/segmental``: what a CPU tensor
takes, and what the CUDA kernels are held to on the card) against the JAX
package's Pallas kernels in interpret mode and the stream functions they
mirror, on identical numpy-seeded inputs.  The port is batch-major, the JAX
kernels time-major: the tests transpose.

Tolerances: fp32, rtol 1e-5 / atol 1e-4 on alphas, betas, logZ, deltas and
scores; gradient pieces within 1e-4 of their largest entry; duration
argmaxes and segment markers equal (the near-tie rule would apply where a
path differs: both must score within 1e-5 relative; none does here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels import segmental_pallas as jk
from asr_craft_tpu.ops import segmental_stream as jss
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import segmental as K
from asr_craft_tpu_torch.ops import segmental_stream as tss
from asr_craft_tpu_torch.ops.semiring import NEG_INF

TOL = dict(rtol=1e-5, atol=1e-4)
# (B, T, Dmax, L): T % Dmax != 0, T < Dmax, T == Dmax, one frame, L = 12
SHAPES = [(3, 9, 4, 3), (3, 5, 8, 4), (2, 6, 6, 2), (4, 1, 2, 3),
          (5, 23, 8, 12), (6, 40, 8, 5)]


def _problem(seed, B, T, Dmax, L, scale=0.7, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        draw = lambda *s: rng.integers(-2, 3, size=s).astype(np.float32)
    else:
        draw = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    frame, bias, trans = draw(B, T, L), draw(Dmax, L), draw(L, L)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    if B > 2:
        lengths[-1] = 0                          # an empty row
    return frame, bias, trans, lengths


def _t(*arrays):
    return [torch.from_numpy(np.array(a, order="C")) for a in arrays]


def _tm(x):
    return jnp.asarray(np.moveaxis(x, 1, 0))


def _bm(x):
    return np.moveaxis(np.asarray(x), 0, 1)


def _rel(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _valid_rows(got, want, lengths, dead=NEG_INF):
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)
        if dead is not None:
            assert (got[b, n:] <= dead * 0.5).all()


@pytest.mark.parametrize("mean_pool", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_backward_plain_match_pallas_and_stream(shape, mean_pool):
    B, T, Dmax, L = shape
    frame, bias, trans, lengths = _problem(0, *shape)
    live = lengths > 0
    jl = jnp.asarray(np.maximum(lengths, 1))    # the TPU wrapper gathers
    # frame length - 1: an empty row is compared with the XLA path below
    ja, jz = jk.segmental_forward_pallas(
        _tm(frame), jnp.asarray(trans), jnp.asarray(bias), None,
        jnp.asarray(lengths) if live.all() else jl, max_dur=Dmax,
        mean_pool=mean_pool, interpret=True)
    jb = jk.segmental_backward_pallas(
        _tm(frame), jnp.asarray(trans), jnp.asarray(bias),
        jnp.asarray(lengths), max_dur=Dmax, mean_pool=mean_pool,
        interpret=True)
    f, b, tr, n = _t(frame, bias, trans, lengths)
    alphas, logZ = K.segmental_forward_plain(f, tr, b, n, mean_pool)
    betas = K.segmental_backward_plain(f, tr, b, n, mean_pool)
    np.testing.assert_allclose(logZ.numpy()[live], np.asarray(jz)[live],
                               **TOL)
    assert (logZ.numpy()[~live] <= NEG_INF * 0.5).all()
    _valid_rows(alphas.numpy()[live], _bm(ja)[live], lengths[live])
    assert (alphas.numpy()[~live] <= NEG_INF * 0.5).all()
    _valid_rows(betas.numpy(), _bm(jb), lengths)
    # the stream functions they mirror
    invd = tss._invd(Dmax, mean_pool)
    sa, sz = tss.seg_forward_stream(f.cumsum(1), b, tr, n, invd)
    sb = tss.seg_backward_stream(f.cumsum(1), b, tr, n, invd)
    np.testing.assert_allclose(logZ.numpy(), sz.numpy(), **TOL)
    np.testing.assert_allclose(alphas.numpy(), sa.numpy(), **TOL)
    np.testing.assert_allclose(betas.numpy(), sb.numpy(), **TOL)
    # the dispatch takes the plain version for a CPU tensor, under 'auto'
    before = dict(K.launches)
    da, dz = K.segmental_forward(f, tr, b, n, mean_pool)
    assert torch.equal(da, alphas) and torch.equal(dz, logZ)
    assert torch.equal(K.segmental_backward(f, tr, b, n, mean_pool), betas)
    assert K.launches == before


@pytest.mark.parametrize("with_bias", ["both", "dur", "seg", "none"])
def test_forward_bias_parts_match_pallas(with_bias):
    """K9 takes b_dur and b_seg apart in the JAX package and their sum in
    the port: ``segment_bias`` forms it."""
    B, T, Dmax, L = 3, 11, 4, 5
    frame, bias, trans, lengths = _problem(1, B, T, Dmax, L)
    lengths[-1] = 3
    dur = bias if with_bias in ("both", "dur") else None
    seg = bias[0] * 0.5 if with_bias in ("both", "seg") else None
    ja, jz = jk.segmental_forward_pallas(
        _tm(frame), jnp.asarray(trans),
        None if dur is None else jnp.asarray(dur),
        None if seg is None else jnp.asarray(seg), jnp.asarray(lengths),
        max_dur=Dmax, interpret=True)
    f, tr, n = _t(frame, trans, lengths)
    b = K.segment_bias(None if dur is None else torch.from_numpy(dur),
                       None if seg is None else torch.from_numpy(seg), Dmax,
                       L, f)
    alphas, logZ = K.segmental_forward_plain(f, tr, b, n)
    np.testing.assert_allclose(logZ.numpy(), np.asarray(jz), **TOL)
    _valid_rows(alphas.numpy(), _bm(ja), lengths)


@pytest.mark.parametrize("mean_pool", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_plain_matches_pallas_and_grad_scan(shape, mean_pool):
    B, T, Dmax, L = shape
    frame, bias, trans, lengths = _problem(2, *shape)
    g = np.random.default_rng(3).normal(size=B).astype(np.float32)
    jinvd = jss._invd(Dmax, mean_pool)
    jargs = (jnp.cumsum(_tm(frame), axis=0), jnp.asarray(bias),
             jnp.asarray(trans), jnp.asarray(lengths), jinvd)
    ja, jz = jss.seg_forward_stream(*jargs)
    jb = jss.seg_backward_stream(*jargs)
    want = {"xla": jss._grad_scan(*jargs, ja, jb, jz, jnp.asarray(g)),
            "pallas": jk.segmental_grad_pallas(
                _tm(frame), jnp.asarray(trans), jnp.asarray(bias),
                jnp.asarray(lengths), ja, jb, jz, jnp.asarray(g),
                max_dur=Dmax, mean_pool=mean_pool, interpret=True)}
    f, b, tr, n = _t(frame, bias, trans, lengths)
    a_in, b_in, z_in, g_in = _t(_bm(ja), _bm(jb), np.array(jz), g)
    A, S, gd, gt = K.segmental_grad_plain(f, tr, b, n, a_in, b_in, z_in,
                                          g_in, mean_pool)
    S_emit, acc_fin = K.emit_layout(S, Dmax)
    for name, (jA, jS, jacc, jgd, jgt) in want.items():
        _rel(A, _bm(jA), f"A {name}")
        _rel(S_emit, _bm(jS), f"S_emit {name}")
        _rel(acc_fin, _bm(jacc), f"acc_fin {name}")
        _rel(gd, jgd, f"gd {name}")
        _rel(gt, jgt, f"gt {name}")
    # rows at and past a length hold 0; the two assemblies agree
    for row, n_b in enumerate(lengths):
        assert float(A[row, n_b:].abs().max() if n_b < T else 0.0) == 0.0
        assert float(S[row, n_b:].abs().max() if n_b < T else 0.0) == 0.0
    assert torch.allclose(K.frame_grad(A, S),
                          tss._assemble_frame_grad(A, S_emit, acc_fin),
                          rtol=0, atol=0)
    before = dict(K.launches)
    out = K.segmental_grad(f, tr, b, n, a_in, b_in, z_in, g_in, mean_pool)
    assert all(torch.equal(x, y) for x, y in zip(out, (A, S, gd, gt)))
    assert K.launches == before


def _decode_jax(frame, bias, trans, lengths, Dmax, mean_pool, thr):
    d, a, l0, sc = jk.segmental_viterbi_pallas(
        _tm(frame), jnp.asarray(trans), jnp.asarray(bias), None,
        jnp.asarray(lengths), Dmax, mean_pool, thr, interpret=True)
    el, es = jk.segmental_viterbi_traceback_pallas(
        d, a, jnp.asarray(trans), l0, jnp.asarray(lengths), interpret=True)
    return d, a, l0, sc, el, es


@pytest.mark.parametrize("thr", [None, 2.0])
@pytest.mark.parametrize("mean_pool", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_viterbi_and_traceback_plain_match_pallas(shape, mean_pool, thr):
    B, T, Dmax, L = shape
    frame, bias, trans, lengths = _problem(4, *shape)
    jd, jarg, jl0, jsc, jel, jes = _decode_jax(frame, bias, trans, lengths,
                                               Dmax, mean_pool, thr)
    f, b, tr, n = _t(frame, bias, trans, lengths)
    deltas, arg_d, lab0, scores = K.segmental_viterbi_plain(f, tr, b, n,
                                                            mean_pool, thr)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jsc), **TOL)
    np.testing.assert_array_equal(lab0.numpy(), np.asarray(jl0))
    _valid_rows(deltas.numpy(), _bm(jd), lengths)
    for row, n_b in enumerate(lengths):
        np.testing.assert_array_equal(arg_d.numpy()[row, :n_b],
                                      _bm(jarg)[row, :n_b])
        assert int(arg_d[row, n_b:].abs().max() if n_b < T else 0) == 0
    end_lab, end_start = K.segmental_viterbi_traceback_plain(
        deltas, arg_d, tr, lab0, n)
    np.testing.assert_array_equal(end_lab.numpy(), _bm(jel))
    np.testing.assert_array_equal(end_start.numpy(), _bm(jes))
    assert end_lab.dtype == end_start.dtype == arg_d.dtype == torch.int32
    # packed segments == the JAX packing of the JAX markers
    js, jl, jn = jss._pack_segment_markers(jel, jes)
    ts, tl, tn = tss._pack_segment_markers(end_lab, end_start)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # and the stream function: the generic XLA scan with its own traceback
    ss, sl, sn, ssc = jss.seg_viterbi_stream(
        _tm(frame), jnp.asarray(bias), jnp.asarray(trans),
        jnp.asarray(lengths), Dmax, 1, mean_pool, thr)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ssc), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(sn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ss))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(sl))
    before = dict(K.launches)
    out = K.segmental_viterbi(f, tr, b, n, mean_pool, thr)
    assert all(torch.equal(x, y)
               for x, y in zip(out, (deltas, arg_d, lab0, scores)))
    tb = K.segmental_viterbi_traceback(deltas, arg_d, tr, lab0, n)
    assert torch.equal(tb[0], end_lab) and torch.equal(tb[1], end_start)
    assert K.launches == before


@pytest.mark.parametrize("thr", [None, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_viterbi_ties_fall_as_in_pallas(seed, thr):
    """Integer potentials and sum pooling make ties certain: the shortest
    duration among equal candidates, the lowest predecessor, the lowest
    final label; the threshold prunes after arg_d is taken."""
    B, T, Dmax, L = 6, 14, 4, 4
    frame, bias, trans, lengths = _problem(seed, B, T, Dmax, L, integer=True)
    jd, jarg, jl0, jsc, jel, jes = _decode_jax(frame, bias, trans, lengths,
                                               Dmax, False, thr)
    f, b, tr, n = _t(frame, bias, trans, lengths)
    deltas, arg_d, lab0, scores = K.segmental_viterbi_plain(f, tr, b, n,
                                                            False, thr)
    end_lab, end_start = K.segmental_viterbi_traceback_plain(
        deltas, arg_d, tr, lab0, n)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(lab0.numpy(), np.asarray(jl0))
    for row, n_b in enumerate(lengths):
        np.testing.assert_array_equal(deltas.numpy()[row, :n_b],
                                      _bm(jd)[row, :n_b])
        np.testing.assert_array_equal(arg_d.numpy()[row, :n_b],
                                      _bm(jarg)[row, :n_b])
    np.testing.assert_array_equal(end_lab.numpy(), _bm(jel))
    np.testing.assert_array_equal(end_start.numpy(), _bm(jes))
    ties = 0
    for t in range(1, T):                        # the test is about ties
        ties += int((deltas[:, t, :, None] + tr == (
            deltas[:, t, :, None] + tr).amax(1, keepdim=True)).sum(1).gt(1)
            .sum())
    assert ties > 0


def test_viterbi_zero_length_rows():
    """Length-0 rows return NEG_INF scores, label 0 and no segment, as the
    JAX kernel wrapper and the XLA streaming path do."""
    rng = np.random.default_rng(12)
    B, T, Dmax, L = 3, 11, 4, 5
    frame = rng.normal(size=(B, T, L)).astype(np.float32)
    bias = (0.4 * rng.normal(size=(Dmax, L))).astype(np.float32)
    trans = (0.4 * rng.normal(size=(L, L))).astype(np.float32)
    lengths = np.array([11, 0, 4], np.int32)
    jd, jarg, jl0, jsc, jel, jes = _decode_jax(frame, bias, trans, lengths,
                                               Dmax, True, None)
    f, b, tr, n = _t(frame, bias, trans, lengths)
    starts, labels, n_segs, scores = tss.seg_viterbi_stream(f, b, tr, n, Dmax)
    assert float(scores[1]) <= NEG_INF * 0.5 and float(jsc[1]) <= NEG_INF * .5
    np.testing.assert_allclose(scores.numpy()[[0, 2]],
                               np.asarray(jsc)[[0, 2]], **TOL)
    assert int(n_segs[1]) == 0 and int(np.asarray(jl0)[1]) == 0
    _, _, lab0, _ = K.segmental_viterbi_plain(f, tr, b, n)
    assert int(lab0[1]) == 0


def test_cuda_wrappers_and_backend_raise_on_cpu_tensors():
    """A CPU tensor never reaches a kernel: the wrappers raise, and so does
    the dispatch under the 'cuda' backend; nothing is counted."""
    frame, bias, trans, lengths = _problem(5, 2, 6, 3, 4)
    f, b, tr, n = _t(frame, bias, trans, lengths)
    before = dict(K.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.segmental_forward_cuda(f, tr, b, n)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.segmental_viterbi_traceback_cuda(f, f.to(torch.int32), tr, n, n)
    kernels.set_backend("cuda")
    try:
        for call in (lambda: K.segmental_forward(f, tr, b, n),
                     lambda: K.segmental_backward(f, tr, b, n),
                     lambda: K.segmental_grad(f, tr, b, n, f, f, f[:, 0, 0],
                                              f[:, 0, 0]),
                     lambda: K.segmental_viterbi(f, tr, b, n),
                     lambda: K.segmental_viterbi_traceback(
                         f, f.to(torch.int32), tr, n, n),
                     lambda: tss.seg_log_partition_stream(f, b, tr, n, 3),
                     lambda: tss.seg_viterbi_stream(f, b, tr, n, 3)):
            with pytest.raises(ValueError, match="CUDA tensor"):
                call()
    finally:
        kernels.set_backend("auto")
    assert K.launches == before
    assert set(K.launches) == {
        "segmental_forward", "segmental_backward", "segmental_grad",
        "segmental_viterbi", "segmental_viterbi_traceback"}
