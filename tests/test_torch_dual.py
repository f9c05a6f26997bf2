"""The port's dual-lattice forward-backward — the plain versions of the K4,
K5 and K14 kernels (kernels.fwdbwd) — against the JAX package's three dual
Pallas kernels (forward_dual_pallas, backward_dual_pallas,
backward_dual_grad_pallas) in interpret mode, on identical numpy-seeded
inputs.

Tolerance: the JAX package's fp32 bar, rtol=5e-4, atol=5e-5; both sides do
the same rescaled-exp arithmetic, so only the order of the sums differs.

Dead entries.  XLA on the CPU flushes subnormals to zero, and the
reference's log floor 1e-38 is one: there ``log(max(prod, 1e-38))`` is
``log(0) = -inf`` for a state no path reaches, and a lattice with no path
at all reports ``logZ = -inf`` and a NaN gradient.  PyTorch keeps
subnormals on the CPU and on the card, so the port honours the floor as it
is written: such a state sits ~87 below its row's live states (weight
1e-38), a dead lattice stays finite and its gradient is zero.  So alphas
and betas are compared where the JAX value is live (finite and above
NEG_INF / 10), and elsewhere the port's value must be dead too (``DEAD``
below its row's maximum, or at NEG_INF): a weight of e^-60 is far below
fp32's resolution of the live ones.  T is a multiple of the 4-frame runs,
so every row but the empty one has a live clamped lattice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels.dual_pallas import (backward_dual_grad_pallas,
                                               backward_dual_pallas,
                                               forward_dual_pallas)
from asr_craft_tpu.models.topology import Topology
from asr_craft_tpu_torch.kernels import fwdbwd as K

TOL = dict(rtol=5e-4, atol=5e-5)
DEAD = 60.0
# (P, ns, clamp granularity, B, T): phone clamp over 3-state phones, state
# clamp (state labels, or one state per phone), a wider lattice
SHAPES = {"phone_ns3": (4, 3, 3, 4, 12), "state_ns3": (4, 3, 1, 4, 12),
          "mono": (7, 1, 1, 3, 9), "wide_ns3": (8, 3, 3, 2, 16),
          "one_frame": (3, 1, 1, 2, 1)}


def _problem(name, seed=0, topology=True):
    """Potentials with the n-state masks folded in, topology-legal labels
    (phone runs of 4 frames, or their state walks), lengths that end on a
    run (row 0 full, the last row empty)."""
    P, ns, cns, B, T = SHAPES[name]
    rng = np.random.default_rng(seed)
    L = P * ns
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    labels = np.repeat(rng.integers(0, P, size=(B, T // 4 + 1)), 4,
                       axis=1)[:, :T]
    if cns == 1 and ns > 1:
        labels = labels * ns + np.tile([0, 0, 1, 2], T // 4 + 1)[None, :T]
    lengths = (rng.integers(1, max(T // 4, 1) + 1, size=B) * 4).clip(max=T)
    lengths[0], lengths[-1] = T, 0
    if ns > 1 and topology:
        topo = Topology(P, ns)
        trans = trans + topo.transition_penalty()
        state[:, 0] += topo.start_penalty()
        for b in range(B):
            if lengths[b] > 0:
                state[b, lengths[b] - 1] += topo.end_penalty()
    return (state, trans.astype(np.float32), labels.astype(np.int32),
            lengths.astype(np.int32), cns)


def _jax_args(state, trans, labels, lengths):
    return (jnp.moveaxis(jnp.asarray(state), 1, 0), jnp.asarray(trans),
            jnp.moveaxis(jnp.asarray(labels), 1, 0), jnp.asarray(lengths))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _tm(x):
    return np.moveaxis(np.asarray(x), 0, 1)


def _close_where_live(got, want):
    """``got`` (port) equals ``want`` (JAX) where JAX is live; where JAX
    holds -inf or NEG_INF the port's entry is dead."""
    got, want = np.asarray(got), np.asarray(want)
    live = np.isfinite(want) & (want > -1e29)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[live], want[live], **TOL)
    if got.ndim:
        row_max = np.max(np.where(live, got, -np.inf), axis=-1,
                         keepdims=True)
        dead_ok = (got <= row_max - DEAD) | (got < -1e29)
        assert dead_ok[~live].all()


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_dual_plain_matches_pallas_interpret(name):
    state, trans, labels, lengths, cns = _problem(name)
    jaf, jac, jzf, jzc = forward_dual_pallas(
        *_jax_args(state, trans, labels, lengths), num_states=cns,
        interpret=True)
    af, ac, zf, zc = K.forward_dual_plain(
        *_torch(state, trans, labels, lengths), cns)
    for got, want in ((af, _tm(jaf)), (ac, _tm(jac)), (zf, jzf), (zc, jzc)):
        _close_where_live(got.numpy(), want)
    assert float(zc[0]) > -1e29           # row 0's clamped lattice lives


@pytest.mark.parametrize("name", list(SHAPES))
def test_backward_dual_plain_matches_pallas_interpret(name):
    state, trans, labels, lengths, cns = _problem(name, 1)
    jbf, jbc = backward_dual_pallas(
        *_jax_args(state, trans, labels, lengths), num_states=cns,
        interpret=True)
    bf, bc = K.backward_dual_plain(*_torch(state, trans, labels, lengths),
                                   cns)
    _close_where_live(bf.numpy(), _tm(jbf))
    _close_where_live(bc.numpy(), _tm(jbc))


def _grad_both(state, trans, labels, lengths, cns, wf, wc):
    """(g_state, UV) of the JAX K5 in interpret mode and of the port's
    plain K5, both fed the JAX K4's alphas and partitions."""
    jargs = _jax_args(state, trans, labels, lengths)
    jaf, jac, jzf, jzc = forward_dual_pallas(*jargs, num_states=cns,
                                             interpret=True)
    jg, jUV = backward_dual_grad_pallas(
        *jargs, jaf, jac, jzf, jzc, jnp.asarray(wf), jnp.asarray(wc),
        num_states=cns, interpret=True)
    g, UV = K.backward_dual_grad_plain(
        *_torch(state, trans, labels, lengths),
        *_torch(_tm(jaf), _tm(jac), jzf, jzc, wf, wc), cns)
    return (_tm(jg), np.asarray(jUV)), (g, UV)


@pytest.mark.parametrize("name", list(SHAPES))
def test_backward_dual_grad_plain_matches_pallas_interpret(name):
    state, trans, labels, lengths, cns = _problem(name, 2)
    rng = np.random.default_rng(3)
    B = len(lengths)
    wf = rng.uniform(0.5, 1.5, B).astype(np.float32)
    wc = -rng.uniform(0.5, 1.5, B).astype(np.float32)
    (jg, jUV), (g, UV) = _grad_both(state, trans, labels, lengths, cns, wf,
                                    wc)
    np.testing.assert_allclose(g.numpy(), jg, **TOL)
    np.testing.assert_allclose(UV.numpy(), jUV, rtol=5e-4,
                               atol=5e-5 * max(1.0, np.abs(jUV).max()))
    assert not g[-1].any()                # the empty row has no gradient
    for b, n in enumerate(lengths):       # nor has a frame past the length
        assert not g[b, n:].any()


@pytest.mark.parametrize("name", ["phone_ns3", "state_ns3", "mono"])
def test_dead_clamped_lattice_gives_zero_gradient(name):
    """A row labelled with a phone no state admits: its clamped lattice is
    dead (zc at NEG_INF, finite), and weighting that lattice alone gives a
    gradient of exactly zero with no NaN."""
    state, trans, labels, lengths, cns = _problem(name, 4)
    labels[1] = 10_000
    lengths[1] = state.shape[1] - 1
    args = _torch(state, trans, labels, lengths)
    af, ac, zf, zc = K.forward_dual_plain(*args, cns)
    assert float(zc[1]) < -1e29 and torch.isfinite(zc).all()
    wc = torch.zeros(len(lengths))
    wc[1] = 1.0
    g, UV = K.backward_dual_grad_plain(*args, af, ac, zf, zc,
                                       torch.zeros_like(wc), wc, cns)
    for x in (g, UV):
        assert torch.isfinite(x).all() and not x.any()


def test_boundary_dead_lattice_stays_finite():
    """A row cut inside a phone run whose label changes at the cut, so the
    end mask leaves its clamped lattice no path: every output of the
    port's K4/K5 arithmetic stays finite (the JAX package on the CPU
    reports -inf and NaN there, see the module note), and the other rows'
    state gradient equals the JAX kernel's."""
    state, trans, labels, lengths, cns = _problem("phone_ns3", 5,
                                                  topology=False)
    topo = Topology(4, 3)
    lengths[1] = 6                          # inside row 1's second run
    labels[1, 4:] = (labels[1, 3] + 1) % 4  # two frames cannot cross a phone
    trans = trans + topo.transition_penalty()
    state[:, 0] += topo.start_penalty()
    for b in range(len(lengths)):
        if lengths[b] > 0:
            state[b, lengths[b] - 1] += topo.end_penalty()
    ones = np.ones(len(lengths), np.float32)
    (jg, _), _ = _grad_both(state, trans, labels, lengths, cns, ones, -ones)
    args = _torch(state, trans, labels, lengths)
    af, ac, zf, zc = K.forward_dual_plain(*args, cns)
    assert float(zc[1]) < float(zf[1]) - DEAD
    g_own, UV_own = K.backward_dual_grad_plain(
        *args, af, ac, zf, zc, *_torch(ones, -ones), cns)
    for x in (af, ac, zf, zc, g_own, UV_own):
        assert torch.isfinite(x).all()
    live_rows = [0, 2]
    np.testing.assert_allclose(g_own.numpy()[live_rows], jg[live_rows],
                               **TOL)


@pytest.mark.parametrize("name", ["phone_ns3", "mono"])
def test_gradient_is_bit_equal_on_two_runs(name):
    state, trans, labels, lengths, cns = _problem(name, 6)
    args = _torch(state, trans, labels, lengths)
    af, ac, zf, zc = K.forward_dual_plain(*args, cns)
    w = torch.ones(len(lengths))
    first = K.backward_dual_grad(*args, af, ac, zf, zc, w, -w, cns)
    again = K.backward_dual_grad(*args, af, ac, zf, zc, w, -w, cns)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert K.launches["backward_dual_grad"] == 0     # CPU: plain only


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never drops to the plain version: a CPU tensor
    raises, and no launch is counted."""
    state, trans, labels, lengths, cns = _problem("mono")
    args = _torch(state, trans, labels, lengths)
    before = dict(K.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.forward_dual_cuda(*args, cns)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.backward_cuda(args[0], args[1], args[3])
    assert K.launches == before
