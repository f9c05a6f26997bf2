"""The port's streaming SCRF passes (``ops/segmental_stream``) against the
JAX package's XLA path and the dense oracle's autograd, on identical
numpy-seeded inputs.  The port is batch-major ``(B, T, L)``, the JAX module
time-major: the tests transpose.

Tolerances: fp32, rtol 1e-5 / atol 1e-4 on alphas, betas and logZ (the JAX
path sums frame scores with ``jnp.cumsum``, the port sequentially); gradient
pieces and gradients within 1e-4 of their largest entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.ops import segmental_stream as jss
from asr_craft_tpu_torch.ops import segmental as tseg
from asr_craft_tpu_torch.ops import segmental_stream as tss
from asr_craft_tpu_torch.ops.semiring import NEG_INF

TOL = dict(rtol=1e-5, atol=1e-4)
SHAPES = [((3, 9, 4, 3), True), ((3, 9, 4, 3), False), ((2, 5, 8, 3), True),
          ((2, 6, 6, 2), True), ((4, 1, 2, 3), True), ((4, 23, 8, 6), True)]


def _problem(seed, B, T, Dmax, L, scale=0.7, empty=True):
    rng = np.random.default_rng(seed)
    frame = (scale * rng.normal(size=(B, T, L))).astype(np.float32)
    bias = (scale * rng.normal(size=(Dmax, L))).astype(np.float32)
    trans = (scale * rng.normal(size=(L, L))).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    if empty and B > 2:
        lengths[-1] = 0
    return frame, bias, trans, lengths


def _tm(x):
    """(B, T, ...) numpy -> time-major jnp."""
    return jnp.asarray(np.moveaxis(x, 1, 0))


def _bm(x):
    """time-major jax -> (B, T, ...) numpy."""
    return np.moveaxis(np.asarray(x), 0, 1)


def _rel(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _valid_rows(got, want, lengths):
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)
        assert (got[b, n:] <= NEG_INF * 0.5).all()


def _dense_logZ(frame, bias, trans, lengths, mean_pool):
    """The materialized (B, T, Dmax, L) path, through the port's oracle."""
    B, T, L = frame.shape
    Dmax = bias.shape[0]
    cs = torch.cat([torch.zeros_like(frame[:, :1]), frame.cumsum(1)], 1)
    ds = torch.arange(Dmax)
    start = (torch.arange(T)[:, None] - ds[None, :]).clamp(0, T)
    seg = cs[:, 1:, None, :] - cs[:, start]
    if mean_pool:
        seg = seg / (ds + 1.0)[None, None, :, None]
    return tseg.segmental_forward_batch(seg + bias, trans, lengths)[1]


@pytest.mark.parametrize("shape,mean_pool", SHAPES)
def test_forward_backward_streams_match_jax(shape, mean_pool):
    B, T, Dmax, L = shape
    frame, bias, trans, lengths = _problem(0, *shape)
    jinvd = jss._invd(Dmax, mean_pool)
    jcum = jnp.cumsum(_tm(frame), axis=0)
    ja, jz = jss.seg_forward_stream(jcum, jnp.asarray(bias),
                                    jnp.asarray(trans), jnp.asarray(lengths),
                                    jinvd)
    jb = jss.seg_backward_stream(jcum, jnp.asarray(bias), jnp.asarray(trans),
                                 jnp.asarray(lengths), jinvd)
    t = [torch.from_numpy(x) for x in (frame, bias, trans, lengths)]
    invd = tss._invd(Dmax, mean_pool)
    np.testing.assert_array_equal(invd.numpy(), np.asarray(jinvd))
    cum = t[0].cumsum(1)
    ta, tz = tss.seg_forward_stream(cum, t[1], t[2], t[3], invd)
    tb = tss.seg_backward_stream(cum, t[1], t[2], t[3], invd)
    live = lengths > 0
    np.testing.assert_allclose(tz.numpy()[live], np.asarray(jz)[live], **TOL)
    _valid_rows(ta.numpy(), _bm(ja), lengths)
    _valid_rows(tb.numpy(), _bm(jb), lengths)
    # the beta identity: lse_l(alpha + beta) is the mass of the paths with a
    # boundary after frame t: logZ at t = length - 1, never more
    ab = torch.logsumexp(ta + tb, dim=-1).numpy()
    for b, n in enumerate(lengths):
        if n:
            np.testing.assert_allclose(ab[b, n - 1], float(tz[b]), rtol=1e-5)
            assert (ab[b, :n] <= float(tz[b]) + 1e-4).all()
            assert float(tb[b, n - 1].abs().max()) == 0.0


@pytest.mark.parametrize("shape,mean_pool", SHAPES)
def test_grad_scan_pieces_match_jax(shape, mean_pool):
    B, T, Dmax, L = shape
    frame, bias, trans, lengths = _problem(1, *shape)
    g = np.random.default_rng(2).normal(size=B).astype(np.float32)
    jinvd = jss._invd(Dmax, mean_pool)
    jcum = jnp.cumsum(_tm(frame), axis=0)
    jargs = (jcum, jnp.asarray(bias), jnp.asarray(trans),
             jnp.asarray(lengths), jinvd)
    ja, jz = jss.seg_forward_stream(*jargs)
    jb = jss.seg_backward_stream(*jargs)
    jA, jS, jacc, jgd, jgt = jss._grad_scan(*jargs, ja, jb, jz,
                                            jnp.asarray(g))
    jgf = jss._assemble_frame_grad(jA, jS, jacc)
    t = [torch.from_numpy(x) for x in (frame, bias, trans, lengths)]
    invd = tss._invd(Dmax, mean_pool)
    args = (t[0].cumsum(1), t[1], t[2], t[3], invd)
    # the JAX passes' alphas, betas and logZ: the pieces alone are compared
    A, S_emit, acc_fin, gd, gt = tss._grad_scan(
        *args, torch.from_numpy(_bm(ja).copy()),
        torch.from_numpy(_bm(jb).copy()), torch.from_numpy(np.array(jz)),
        torch.from_numpy(g))
    _rel(A, _bm(jA))
    _rel(S_emit, _bm(jS))
    _rel(acc_fin, _bm(jacc))
    _rel(gd, jgd)
    _rel(gt, jgt)
    _rel(tss._assemble_frame_grad(A, S_emit, acc_fin), _bm(jgf))


@pytest.mark.parametrize("shape,mean_pool", SHAPES)
def test_log_partition_and_gradient_match_jax_and_dense(shape, mean_pool):
    """seg_log_partition_stream (the plain K9-K11 on the CPU): value and
    gradient w.r.t. frame scores, bias and trans against the JAX custom VJP
    and against autograd through the port's dense oracle."""
    B, T, Dmax, L = shape
    frame, bias, trans, lengths = _problem(3, *shape)
    w = np.random.default_rng(4).normal(size=B).astype(np.float32)
    w[lengths == 0] = 0.0                        # masked, as the model does

    def jobj(f, b, tr):
        return jnp.sum(jnp.asarray(w) * jss.seg_log_partition_stream(
            jnp.moveaxis(f, 1, 0), b, tr, jnp.asarray(lengths), Dmax,
            mean_pool))

    jz = jss.seg_log_partition_stream(_tm(frame), jnp.asarray(bias),
                                      jnp.asarray(trans),
                                      jnp.asarray(lengths), Dmax, mean_pool)
    jg = jax.grad(jobj, argnums=(0, 1, 2))(
        jnp.asarray(frame), jnp.asarray(bias), jnp.asarray(trans))
    grads = {}
    for name, fn in (("stream", lambda f, b, tr, n: tss.
                      seg_log_partition_stream(f, b, tr, n, Dmax, mean_pool)),
                     ("dense", lambda f, b, tr, n: _dense_logZ(
                         f, b, tr, n, mean_pool))):
        f, b, tr = (torch.from_numpy(x).requires_grad_(True)
                    for x in (frame, bias, trans))
        z = fn(f, b, tr, torch.from_numpy(lengths))
        (torch.from_numpy(w) * z).sum().backward()
        grads[name] = (z.detach().numpy(), f.grad, b.grad, tr.grad)
    live = lengths > 0
    for name, (z, gf, gb, gtr) in grads.items():
        np.testing.assert_allclose(z[live], np.asarray(jz)[live], **TOL,
                                   err_msg=name)
        for got, want in zip((gf, gb, gtr), jg):
            _rel(got, want)
    assert float(grads["stream"][1][~live].abs().max()
                 if (~live).any() else 0.0) == 0.0


def test_zero_length_rows_inert():
    """length-0 padding rows get zero gradient and nothing is NaN."""
    B, T, Dmax, L = 3, 6, 3, 3
    frame, bias, trans, _ = _problem(5, B, T, Dmax, L)
    lengths = torch.tensor([6, 0, 4], dtype=torch.int32)
    w = torch.tensor([1.0, 0.0, 1.0])
    f = torch.from_numpy(frame).requires_grad_(True)
    z = tss.seg_log_partition_stream(f, torch.from_numpy(bias),
                                     torch.from_numpy(trans), lengths, Dmax)
    (w * z).sum().backward()
    assert float(f.grad[1].abs().max()) == 0.0
    assert torch.isfinite(f.grad).all()
    assert float(z.detach()[1]) <= NEG_INF * 0.5
    with pytest.raises(ValueError, match="max_dur"):
        tss.seg_log_partition_stream(f, torch.from_numpy(bias),
                                     torch.from_numpy(trans), lengths, Dmax + 1)


def _ns_problem(seed, B, T, Dmax, L, ns, scale=0.6):
    rng = np.random.default_rng(seed)
    frame = (scale * rng.normal(size=(B, T, ns, L))).astype(np.float32)
    bias = (scale * rng.normal(size=(Dmax, L))).astype(np.float32)
    trans = (scale * rng.normal(size=(L, L))).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return frame, bias, trans, lengths


@pytest.mark.parametrize("mean_pool", [True, False])
@pytest.mark.parametrize("ns,shape", [(2, (3, 9, 4, 3)), (3, (3, 11, 5, 4)),
                                      (3, (2, 3, 6, 3)), (2, (2, 12, 4, 5))])
def test_nstate_trio_matches_jax(ns, shape, mean_pool):
    B, T, Dmax, L = shape
    frame, bias, trans, lengths = _ns_problem(6, *shape, ns)
    g = np.random.default_rng(7).normal(size=B).astype(np.float32)
    np.testing.assert_array_equal(tss.nstate_cuts(Dmax, ns),
                                  jss.nstate_cuts(Dmax, ns))
    jEf, jEb = jss.nstate_pool_matrices(Dmax, ns, mean_pool)
    Ef, Eb = tss.nstate_pool_matrices(Dmax, ns, mean_pool)
    np.testing.assert_array_equal(Ef, jEf)
    np.testing.assert_array_equal(Eb, jEb)
    jcums = jnp.cumsum(_tm(frame), axis=0)
    jrest = (jnp.asarray(bias), jnp.asarray(trans), jnp.asarray(lengths))
    ja, jz = jss.seg_forward_stream_ns(jcums, *jrest, jnp.asarray(jEf))
    jb = jss.seg_backward_stream_ns(jcums, *jrest, jnp.asarray(jEb))
    jemit, jacc, jgd, jgt = jss._grad_scan_ns(
        jcums, *jrest, jnp.asarray(jEf), ja, jb, jz, jnp.asarray(g))
    jgf = jss._assemble_frame_grad_ns(jemit, jacc)
    t = [torch.from_numpy(x) for x in (frame, bias, trans, lengths)]
    cums = t[0].cumsum(1)
    ta, tz = tss.seg_forward_stream_ns(cums, *t[1:], torch.from_numpy(Ef))
    tb = tss.seg_backward_stream_ns(cums, *t[1:], torch.from_numpy(Eb))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    _valid_rows(ta.numpy(), _bm(ja), lengths)
    _valid_rows(tb.numpy(), _bm(jb), lengths)
    emit, acc, gd, gt = tss._grad_scan_ns(
        cums, *t[1:], torch.from_numpy(Ef),
        torch.from_numpy(_bm(ja).copy()), torch.from_numpy(_bm(jb).copy()),
        torch.from_numpy(np.array(jz)), torch.from_numpy(g))
    _rel(emit, _bm(jemit))
    _rel(acc, _bm(jacc))
    _rel(gd, jgd)
    _rel(gt, jgt)
    _rel(tss._assemble_frame_grad_ns(emit, acc), _bm(jgf))


@pytest.mark.parametrize("ns", [2, 3])
def test_nstate_log_partition_gradient_matches_jax(ns):
    B, T, Dmax, L = 3, 10, 4, 4
    frame, bias, trans, lengths = _ns_problem(8, B, T, Dmax, L, ns)
    w = np.random.default_rng(9).normal(size=B).astype(np.float32)

    def jobj(f, b, tr):
        return jnp.sum(jnp.asarray(w) * jss.seg_log_partition_stream_ns(
            jnp.moveaxis(f, 1, 0), b, tr, jnp.asarray(lengths), Dmax, ns))

    jg = jax.grad(jobj, argnums=(0, 1, 2))(
        jnp.asarray(frame), jnp.asarray(bias), jnp.asarray(trans))
    f, b, tr = (torch.from_numpy(x).requires_grad_(True)
                for x in (frame, bias, trans))
    z = tss.seg_log_partition_stream_ns(f, b, tr, torch.from_numpy(lengths),
                                        Dmax, ns)
    (torch.from_numpy(w) * z).sum().backward()
    jz = jss.seg_log_partition_stream_ns(
        _tm(frame), jnp.asarray(bias), jnp.asarray(trans),
        jnp.asarray(lengths), Dmax, ns)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), **TOL)
    for got, want in zip((f.grad, b.grad, tr.grad), jg):
        _rel(got, want)
