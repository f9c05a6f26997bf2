"""The classical gradients of the port's ops.mxu — log_partition_mxu and
nll_dual, explicit forward-backward recursions behind torch.autograd
Functions — against jax.grad of the JAX package's ops.mxu (XLA path) with
weighted cotangents, against torch.autograd through the plain logsumexp
loop of ops.fwdbwd, and against finite differences in float64.

Tolerance: the JAX package's own bar for these gradients, rtol=2e-3,
atol=1e-5 (tests/oracle/test_mxu_parity.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu import kernels as jkernels
from asr_craft_tpu.models.topology import Topology
from asr_craft_tpu.ops import mxu as jmxu
from asr_craft_tpu_torch.ops import fwdbwd, mxu
from asr_craft_tpu_torch.ops.semiring import NEG_INF

GRAD = dict(rtol=2e-3, atol=1e-5)
# (B, T, L, clamp granularity)
SHAPES = {"mono": (3, 8, 5, 1), "phone_ns3": (3, 12, 12, 3),
          "state_ns3": (3, 12, 12, 1), "wide": (2, 9, 24, 1)}


@pytest.fixture(autouse=True)
def xla_backend(monkeypatch):
    """The JAX package on its XLA (lax.scan) path."""
    monkeypatch.setattr(jkernels, "_BACKEND", "xla")


def _problem(name, seed=0):
    """Potentials (n-state masks folded in for the ns3 shapes), legal
    labels (phone runs of 4 frames, or their state walks), lengths on run
    ends with row 0 full and the last row empty, and cotangent weights for
    the three outputs."""
    B, T, L, cns = SHAPES[name]
    ns = 3 if "ns3" in name else 1
    P = L // ns
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    labels = np.repeat(rng.integers(0, P, size=(B, T // 4 + 1)), 4,
                       axis=1)[:, :T]
    if ns > 1 and cns == 1:
        labels = labels * ns + np.tile([0, 0, 1, 2], T // 4 + 1)[None, :T]
    lengths = (rng.integers(1, T // 4 + 1, size=B) * 4).clip(max=T)
    lengths[0], lengths[-1] = (T // 4) * 4, 0
    if ns > 1:
        topo = Topology(P, ns)
        trans = trans + topo.transition_penalty()
        state[:, 0] += topo.start_penalty()
        for b in range(B):
            if lengths[b] > 0:
                state[b, lengths[b] - 1] += topo.end_penalty()
    w = rng.uniform(-2.0, 2.0, size=(3, B)).astype(np.float32)
    return (state, trans.astype(np.float32), labels.astype(np.int32),
            lengths.astype(np.int32), cns, w)


def _leaves(state, trans):
    return (torch.from_numpy(state).requires_grad_(True),
            torch.from_numpy(trans).requires_grad_(True))


@pytest.mark.parametrize("name", list(SHAPES))
def test_log_partition_mxu_gradient_matches_jax(name):
    state, trans, _, lengths, _, w = _problem(name)
    jn = jnp.asarray(lengths)

    def f(s, t):
        return jnp.sum(jnp.asarray(w[0]) * jmxu.log_partition_mxu(s, t, jn))

    jv, (jgs, jgt) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(state), jnp.asarray(trans))
    s, t = _leaves(state, trans)
    v = (torch.from_numpy(w[0])
         * mxu.log_partition_mxu(s, t, torch.from_numpy(lengths))).sum()
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgs), **GRAD)
    live = trans > NEG_INF / 2            # masked transitions: no gradient
    np.testing.assert_allclose(t.grad.numpy()[live], np.asarray(jgt)[live],
                               **GRAD)
    assert not t.grad.numpy()[~live].any()


@pytest.mark.parametrize("name", list(SHAPES))
def test_nll_dual_gradient_matches_jax(name):
    """Weighted cotangents on all three outputs (nll, logZ, numerator)."""
    state, trans, labels, lengths, cns, w = _problem(name, 1)
    live_rows = jnp.asarray(lengths > 0)
    jw = jnp.asarray(w)

    def f(s, t):
        outs = jmxu.nll_dual(s, t, jnp.asarray(labels), jnp.asarray(lengths),
                             cns)
        return sum(jnp.sum(jnp.where(live_rows, jw[i] * o, 0.0))
                   for i, o in enumerate(outs))

    jv, (jgs, jgt) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(state), jnp.asarray(trans))
    s, t = _leaves(state, trans)
    outs = mxu.nll_dual(s, t, torch.from_numpy(labels),
                        torch.from_numpy(lengths), cns)
    keep = torch.from_numpy(lengths > 0)
    v = sum(torch.where(keep, torch.from_numpy(w[i]) * o, 0.0).sum()
            for i, o in enumerate(outs))
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jgs), **GRAD)
    live = trans > NEG_INF / 2
    np.testing.assert_allclose(t.grad.numpy()[live], np.asarray(jgt)[live],
                               **GRAD)
    assert not s.grad[-1].any()           # the masked empty row


@pytest.mark.parametrize("name", list(SHAPES))
def test_nll_dual_values_match_jax(name):
    state, trans, labels, lengths, cns, _ = _problem(name, 2)
    jouts = jmxu.nll_dual(jnp.asarray(state), jnp.asarray(trans),
                          jnp.asarray(labels), jnp.asarray(lengths), cns)
    outs = mxu.nll_dual(torch.from_numpy(state), torch.from_numpy(trans),
                        torch.from_numpy(labels), torch.from_numpy(lengths),
                        cns)
    for got, want in zip(outs, jouts):
        np.testing.assert_allclose(got.numpy()[:-1], np.asarray(want)[:-1],
                                   rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("name", ["mono", "wide"])
def test_log_partition_gradient_matches_autograd_through_the_loop(name):
    """The explicit forward-backward recursion against torch.autograd
    through the generic logsumexp loop on the same weighted loss."""
    state, trans, _, lengths, _, w = _problem(name, 3)
    n, wt = torch.from_numpy(lengths), torch.from_numpy(w[1])
    s1, t1 = _leaves(state, trans)
    (wt * mxu.log_partition_mxu(s1, t1, n)).sum().backward()
    s2, t2 = _leaves(state, trans)
    (wt * fwdbwd.log_partition_batch(s2, t2, n)).sum().backward()
    # the empty row: frame 0 still feeds logZ = lse(state_0) under
    # autograd; the classical gradient is zero at frames >= length
    np.testing.assert_allclose(s1.grad.numpy()[:-1], s2.grad.numpy()[:-1],
                               **GRAD)
    assert not s1.grad[-1].any()
    np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(), **GRAD)


def _clamped(state, labels, cns):
    lane = torch.arange(state.shape[-1])
    return state + torch.where(lane // cns == labels[..., None].long(), 0.0,
                               NEG_INF).to(state.dtype)


@pytest.mark.parametrize("name", ["mono", "phone_ns3"])
def test_nll_dual_gradient_matches_autograd_through_the_loop(name):
    state, trans, labels, lengths, cns, w = _problem(name, 4)
    n, lab = torch.from_numpy(lengths), torch.from_numpy(labels)
    keep = n > 0
    wt = torch.from_numpy(w)

    def loss(outs):
        return sum(torch.where(keep, wt[i] * o, 0.0).sum()
                   for i, o in enumerate(outs))

    s1, t1 = _leaves(state, trans)
    loss(mxu.nll_dual(s1, t1, lab, n, cns)).backward()
    s2, t2 = _leaves(state, trans)
    zf = fwdbwd.log_partition_batch(s2, t2, n)
    zc = fwdbwd.log_partition_batch(_clamped(s2, lab, cns), t2, n)
    loss((zf - zc, zf, zc)).backward()
    np.testing.assert_allclose(s1.grad.numpy(), s2.grad.numpy(), **GRAD)
    live = trans > NEG_INF / 2
    np.testing.assert_allclose(t1.grad.numpy()[live], t2.grad.numpy()[live],
                               **GRAD)


def test_gradcheck_float64():
    """Finite differences in float64 at a tiny size: both Functions'
    backward passes are the derivative of their forward passes."""
    rng = np.random.default_rng(5)
    B, T, L = 2, 5, 3
    s = torch.from_numpy(rng.normal(size=(B, T, L))).requires_grad_(True)
    t = torch.from_numpy(rng.normal(size=(L, L))).requires_grad_(True)
    n = torch.tensor([T, 3], dtype=torch.int32)
    lab = torch.from_numpy(rng.integers(0, L, size=(B, T)).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda a, b: mxu.log_partition_mxu(a, b, n), (s, t), atol=1e-6)
    assert torch.autograd.gradcheck(
        lambda a, b: mxu.nll_dual(a, b, lab, n, 1), (s, t), atol=1e-6)


def test_empty_batch_row_and_single_frame():
    """T = 1 has no transition: g_trans is zero and g_state is gamma of
    frame 0 for rows of length 1, zero for the empty row."""
    rng = np.random.default_rng(6)
    state = rng.normal(size=(3, 1, 4)).astype(np.float32)
    trans = rng.normal(size=(4, 4)).astype(np.float32)
    s, t = _leaves(state, trans)
    n = torch.tensor([1, 1, 0], dtype=torch.int32)
    mxu.log_partition_mxu(s, t, n).sum().backward()
    assert not t.grad.any()
    np.testing.assert_allclose(s.grad[:2, 0].numpy(),
                               torch.softmax(s.detach()[:2, 0], -1).numpy(),
                               rtol=1e-5)
    assert not s.grad[2].any()
