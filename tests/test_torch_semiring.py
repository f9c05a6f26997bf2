"""The port's semiring ops surface against the JAX package's, on identical
numpy-seeded inputs: ``ops.semiring`` (``Semiring``, ``LOG``,
``TROPICAL``, ``get_semiring``, ``matvec``, ``matmul``), the
single-utterance ``ops.fwdbwd`` functions and the batched ones with
``semiring=``, ``ops.segmental.segmental_forward(semiring=)``, and the
re-exports of ``ops`` and ``models``.

Tolerance: rtol 1e-5, atol 1e-5 on scores (fp32 sums of up to 12 terms of
magnitude ~3, summed in the same order on both sides: the arithmetic is the
same, the libraries' exp and log differ in the last bit); tropical values
are maxima of the same fp32 sums, held equal within the same bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import asr_craft_tpu.models as jmodels
import asr_craft_tpu.ops as jops
from asr_craft_tpu.ops import fwdbwd as jfb
from asr_craft_tpu.ops import segmental as jseg
from asr_craft_tpu.ops import semiring as jsr
import asr_craft_tpu_torch.models as tmodels
import asr_craft_tpu_torch.ops as tops
from asr_craft_tpu_torch.ops import fwdbwd as tfb
from asr_craft_tpu_torch.ops import segmental as tseg
from asr_craft_tpu_torch.ops import semiring as tsr

TOL = dict(rtol=1e-5, atol=1e-5)
NEG = tsr.NEG_INF
SEMIRINGS = ["log", "tropical"]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **(tol or TOL))


def _x(seed, shape, dead_rows=False):
    """N(0, 1) values; ``dead_rows``: every other row of the last axis's
    slices all NEG_INF."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if dead_rows:
        x[..., ::2, :] = NEG
    return x


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("dim", [None, 0, -1, (0, 1)])
def test_sum_matches_jax_with_dead_rows(name, dim):
    """``sum`` over any axes, all-NEG_INF slices included: they stay at
    NEG_INF (the clamp ``m_safe = max(m, NEG_INF)``)."""
    x = _x(0, (4, 6, 5), dead_rows=True)
    got = tsr.get_semiring(name).sum(torch.from_numpy(x), dim=dim)
    want = jsr.get_semiring(name).sum(jnp.asarray(x), axis=dim)
    _close(got, want)
    keep = tsr.get_semiring(name).sum(torch.from_numpy(x), dim=-1,
                                      keepdim=True)
    assert keep.shape == (4, 6, 1)
    if dim == -1:
        assert (got[:, ::2] == NEG).all()


def test_log_sum_of_dead_slice_has_zero_gradient():
    x = torch.full((3, 4), NEG, requires_grad=True)
    out = tsr.LOG.sum(x, dim=-1)
    assert torch.equal(out, torch.full((3,), NEG))
    out.sum().backward()
    g_jax = jax.grad(lambda v: jsr.LOG.sum(v, axis=-1).sum())(
        jnp.full((3, 4), NEG, jnp.float32))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(g_jax))
    assert torch.isfinite(x.grad).all()


def test_log_sum_is_the_batched_recursions_formula():
    """``LOG.sum`` is bit for bit the clamped max-subtracted logsumexp the
    batched recursions took before (their default stays bit-identical)."""
    x = torch.from_numpy(_x(1, (3, 7, 5), dead_rows=True))
    m = torch.clamp(x.amax(dim=1, keepdim=True), min=NEG)
    old = (m + torch.log(torch.exp(x - m).sum(dim=1, keepdim=True))
           ).squeeze(1)
    assert torch.equal(tsr.LOG.sum(x, dim=1), old)


def test_semiring_objects():
    assert set(tsr.SEMIRINGS) == set(jsr.SEMIRINGS) == {"log", "tropical"}
    for name in SEMIRINGS:
        sr = tsr.get_semiring(name)
        assert tsr.get_semiring(sr) is sr
        assert sr.name == name and sr.zero == jsr.get_semiring(name).zero
        assert sr.one == 0.0
        a, b = torch.ones(3), torch.full((3,), 2.0)
        assert torch.equal(sr.prod(a, b, a), torch.full((3,), 4.0))
    assert tsr.LOG is tsr.SEMIRINGS["log"]
    assert tsr.TROPICAL is tsr.SEMIRINGS["tropical"]
    with pytest.raises(KeyError):
        tsr.get_semiring("real")


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("dead", [False, True])
def test_matvec_matmul_match_jax(name, dead):
    a, b = _x(2, (6, 6), dead), _x(3, (6, 6))
    v = _x(4, (6,))
    if dead:
        v[:3] = NEG
    tsr_, jsr_ = tsr.get_semiring(name), jsr.get_semiring(name)
    _close(tsr.matvec(tsr_, torch.from_numpy(a), torch.from_numpy(v)),
           jsr.matvec(jsr_, jnp.asarray(a), jnp.asarray(v)))
    _close(tsr.matmul(tsr_, torch.from_numpy(a), torch.from_numpy(b)),
           jsr.matmul(jsr_, jnp.asarray(a), jnp.asarray(b)))


def _problem(seed, T=9, L=5, frame_dep=False, dead_frame=False):
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(T, L)).astype(np.float32)
    if dead_frame:
        state[3] = NEG                      # an all-NEG_INF row of the lattice
    shape = (T, L, L) if frame_dep else (L, L)
    trans = rng.normal(size=shape).astype(np.float32)
    return state, trans


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("frame_dep", [False, True], ids=["shared", "fdt"])
@pytest.mark.parametrize("length", [9, 5, 1])
def test_single_utterance_fwdbwd_matches_jax(name, frame_dep, length):
    state, trans = _problem(5, frame_dep=frame_dep)
    ts, tt = torch.from_numpy(state), torch.from_numpy(trans)
    js, jt = jnp.asarray(state), jnp.asarray(trans)
    alphas, z = tfb.forward(ts, tt, length, name)
    ja, jz = jfb.forward(js, jt, length, name)
    _close(alphas, ja)
    _close(z, jz)
    _close(tfb.log_partition(ts, tt, torch.tensor(length), name), jz)
    _close(tfb.backward(ts, tt, length, name),
           jfb.backward(js, jt, length, name))
    if name == "log":
        _close(tfb.posteriors(ts, tt, length), jfb.posteriors(js, jt, length))
    labels = np.random.default_rng(6).integers(0, 5, size=9).astype(np.int32)
    _close(tfb.path_score(ts, tt, torch.from_numpy(labels), length),
           jfb.path_score(js, jt, jnp.asarray(labels), length))


@pytest.mark.parametrize("name", SEMIRINGS)
def test_dead_frame_stays_dead(name):
    """A frame whose every state is NEG_INF kills the lattice: logZ (or the
    best score) near NEG_INF on both sides, never NaN."""
    state, trans = _problem(7, dead_frame=True)
    z = tfb.log_partition(torch.from_numpy(state), torch.from_numpy(trans), 9,
                          name)
    jz = jfb.log_partition(jnp.asarray(state), jnp.asarray(trans), 9, name)
    assert torch.isfinite(z) and float(z) < -1e29
    _close(z, jz, rtol=1e-6)


def test_broadcast_trans():
    trans = torch.randn(4, 4)
    b = tfb.broadcast_trans(trans, 6)
    assert b.shape == (6, 4, 4) and b.stride(0) == 0
    assert torch.equal(b[5], trans)
    fd = torch.randn(6, 4, 4)
    assert tfb.broadcast_trans(fd, 6) is fd
    with pytest.raises(ValueError, match="T=6"):
        tfb.broadcast_trans(fd, 7)
    with pytest.raises(ValueError):
        jfb.broadcast_trans(jnp.asarray(fd.numpy()), 7)


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("frame_dep", [False, True], ids=["shared", "fdt"])
def test_batched_semiring_matches_jax(name, frame_dep):
    rng = np.random.default_rng(8)
    B, T, L = 3, 8, 4
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = rng.normal(size=(B, T, L, L) if frame_dep else (L, L)
                       ).astype(np.float32)
    lengths = np.array([8, 3, 1], np.int32)
    t_args = [torch.from_numpy(a) for a in (state, trans, lengths)]
    j_args = [jnp.asarray(a) for a in (state, trans, lengths)]
    alphas, z = tfb.forward_batch(*t_args, semiring=name)
    ja, jz = jfb.forward_batch(*j_args, semiring=name)
    _close(alphas, ja)
    _close(z, jz)
    _close(tfb.log_partition_batch(*t_args, semiring=name),
           jfb.log_partition_batch(*j_args, semiring=name))
    if name == "log":         # the default is the log semiring, bit for bit
        assert torch.equal(tfb.log_partition_batch(*t_args), z)


@pytest.mark.parametrize("name", SEMIRINGS)
def test_segmental_forward_semiring_matches_jax(name):
    rng = np.random.default_rng(9)
    T, Dmax, L = 10, 3, 4
    seg = rng.normal(size=(T, Dmax, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    for length in (10, 6):
        alphas, z = tseg.segmental_forward(torch.from_numpy(seg),
                                           torch.from_numpy(trans), length,
                                           semiring=name)
        ja, jz = jseg.segmental_forward(jnp.asarray(seg), jnp.asarray(trans),
                                        length, semiring=name)
        _close(alphas, ja)
        _close(z, jz)
        if name == "tropical":     # the best segmentation's score
            *_, score = tseg.segmental_viterbi(torch.from_numpy(seg),
                                               torch.from_numpy(trans),
                                               length)
            assert float(score) == float(z)
    _, zb = tseg.segmental_forward_batch(
        torch.from_numpy(seg)[None].expand(2, -1, -1, -1),
        torch.from_numpy(trans), torch.tensor([10, 6]), semiring=name)
    _, jzb = jseg.segmental_forward_batch(
        jnp.broadcast_to(jnp.asarray(seg), (2, T, Dmax, L)),
        jnp.asarray(trans), jnp.asarray([10, 6]), semiring=name)
    _close(zb, jzb)


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_reexports_match_jax():
    """``ops`` and ``models`` re-export the JAX names; ``ops`` leaves out
    ``viterbi`` (the name stays the submodule) and carries the submodule's
    batched decode, ``viterbi_batch``."""
    import asr_craft_tpu_torch.ops.viterbi as viterbi_module
    from asr_craft_tpu_torch.ops import viterbi

    def exported(mod):                 # bound names that are not submodules
        return {n for n in _public(mod)
                if not (isinstance(getattr(mod, n), type(np))
                        and getattr(mod, n).__name__ == f"{mod.__name__}.{n}")}

    assert exported(tops) == exported(jops) - {"viterbi"}
    assert viterbi is viterbi_module
    assert tops.viterbi_batch is viterbi_module.viterbi_batch
    assert exported(tmodels) == exported(jmodels)
    assert tmodels.weights.__name__ == "asr_craft_tpu_torch.models.weights"
