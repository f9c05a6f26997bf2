"""The port's single-lattice forward-backward — the plain versions of the K6a
/ K6b kernels (kernels.fwdbwd), ops.mxu.forward_mxu / posteriors_mxu and
the generic ops.fwdbwd — against the JAX package on identical numpy-seeded
inputs: the Pallas kernels forward_pallas / backward_pallas in interpret
mode and the XLA path of ops.mxu / ops.fwdbwd.

Tolerance: the JAX package's own fp32 bar for these tensors, rtol=5e-4,
atol=5e-5 (tests/oracle/test_mxu_parity.py); both sides do the same
rescaled-exp arithmetic, so only the order of the sums differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu import kernels as jkernels
from asr_craft_tpu import ops as jops
from asr_craft_tpu.kernels.fwdbwd_pallas import (backward_pallas,
                                                 forward_pallas)
from asr_craft_tpu.models.topology import Topology
from asr_craft_tpu.ops import mxu as jmxu
from asr_craft_tpu_torch.kernels import fwdbwd as K
from asr_craft_tpu_torch.ops import fwdbwd, mxu
from asr_craft_tpu_torch.utils import diagnostics

TOL = dict(rtol=5e-4, atol=5e-5)
CASES = ["ragged", "empty_row", "masked", "large", "one_frame", "wide"]


def _case(kind, seed=0):
    """(state (B, T, L), trans (L, L), lengths (B,)) as numpy arrays: the
    cases of the JAX package's mxu parity tests."""
    rng = np.random.default_rng(seed)
    B, T, L, scale = {"ragged": (4, 17, 7, 1.0), "empty_row": (3, 9, 5, 1.0),
                      "masked": (3, 12, 6, 1.0), "large": (2, 32, 10, 20.0),
                      "one_frame": (2, 1, 3, 1.0),
                      "wide": (2, 11, 24, 1.0)}[kind]
    state = rng.normal(size=(B, T, L), scale=scale).astype(np.float32)
    trans = rng.normal(size=(L, L), scale=scale).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    if kind == "empty_row":
        lengths[-1] = 0
    if kind == "masked":
        trans = trans + Topology(num_labels=3,
                                 num_states=2).transition_penalty()
    return state, trans, lengths


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _tm(x):
    """Time-major (T, B, ...) jax array -> batch-major numpy."""
    return np.moveaxis(np.asarray(x), 0, 1)


@pytest.fixture
def xla_backend(monkeypatch):
    """The JAX package on its XLA (lax.scan) path for this test."""
    monkeypatch.setattr(jkernels, "_BACKEND", "xla")


@pytest.mark.parametrize("kind", CASES)
def test_forward_plain_matches_pallas_interpret(kind):
    state, trans, lengths = _case(kind)
    ja, jz = forward_pallas(jnp.moveaxis(jnp.asarray(state), 1, 0),
                            jnp.asarray(trans), jnp.asarray(lengths),
                            interpret=True)
    alphas, z = K.forward_plain(*_torch(state, trans, lengths))
    np.testing.assert_allclose(alphas.numpy(), _tm(ja), **TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)


@pytest.mark.parametrize("kind", CASES)
def test_backward_plain_matches_pallas_interpret(kind):
    state, trans, lengths = _case(kind, 1)
    jb = backward_pallas(jnp.moveaxis(jnp.asarray(state), 1, 0),
                         jnp.asarray(trans), jnp.asarray(lengths),
                         interpret=True)
    betas = K.backward_plain(*_torch(state, trans, lengths))
    np.testing.assert_allclose(betas.numpy(), _tm(jb), **TOL)
    for b, n in enumerate(lengths):         # beta is 0 from length - 1 on
        assert not betas[b, max(int(n) - 1, 0):].any()


@pytest.mark.parametrize("kind", CASES)
def test_forward_mxu_matches_jax(kind, xla_backend):
    state, trans, lengths = _case(kind, 2)
    ja, jz = jmxu.forward_mxu(jnp.asarray(state), jnp.asarray(trans),
                              jnp.asarray(lengths))
    with diagnostics.held_launches() as ran:
        alphas, z = mxu.forward_mxu(*_torch(state, trans, lengths))
    np.testing.assert_allclose(alphas.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    assert ran == {}                                    # CPU: plain only


@pytest.mark.parametrize("kind", CASES)
def test_posteriors_mxu_matches_jax(kind, xla_backend):
    state, trans, lengths = _case(kind, 3)
    jg = jmxu.posteriors_mxu(jnp.asarray(state), jnp.asarray(trans),
                             jnp.asarray(lengths))
    gamma = mxu.posteriors_mxu(*_torch(state, trans, lengths)).numpy()
    np.testing.assert_allclose(gamma, np.asarray(jg), **TOL)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(gamma[b, :n].sum(-1), 1.0, rtol=5e-4)
        np.testing.assert_array_equal(gamma[b, n:], 0.0)


def test_empty_row_reports_the_frame0_partition():
    """A row of length 0 still reports logZ = lse(state[0]): frame 0 always
    runs, in the kernels' plain versions as in the JAX package."""
    state, trans, lengths = _torch(*_case("empty_row"))
    for z in (K.forward_plain(state, trans, lengths)[1],
              fwdbwd.log_partition_batch(state, trans, lengths)):
        np.testing.assert_allclose(
            z[-1].numpy(), torch.logsumexp(state[-1, 0], -1).numpy(),
            rtol=1e-6)


def test_transition_factors_are_the_jax_wrappers():
    """tmax / P / tmax_r / Pt as forward_pallas and backward_pallas form
    them outside the kernel body, dead columns included."""
    _, trans, _ = _case("masked")
    trans[:, 2] = -1e30                      # an all-dead column
    t = jnp.asarray(trans)
    tmax = jnp.maximum(jnp.max(t, axis=0), -1e30)
    tmax_r = jnp.maximum(jnp.max(t, axis=1), -1e30)
    got_tmax, got_P = K.forward_factors(torch.from_numpy(trans))
    got_tmax_r, got_Pt = K.backward_factors(torch.from_numpy(trans))
    np.testing.assert_array_equal(got_tmax.numpy(), np.asarray(tmax))
    np.testing.assert_array_equal(got_tmax_r.numpy(), np.asarray(tmax_r))
    np.testing.assert_allclose(got_P.numpy(),
                               np.asarray(jnp.exp(t - tmax[None, :])),
                               rtol=1e-6)
    np.testing.assert_allclose(got_Pt.numpy(),
                               np.asarray(jnp.exp(t.T - tmax_r[None, :])),
                               rtol=1e-6)
    assert (got_P[:, 2] == 1.0).all()        # exp(0) on the dead column


def _trans_of(kind, rng, B, T, L):
    shape = {"shared": (L, L), "per_sequence": (B, T, L, L)}[kind]
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["shared", "per_sequence"])
def test_generic_scan_matches_jax(kind):
    """ops.fwdbwd's batched surface for (L, L) and (B, T, L, L)
    transitions: alphas, logZ, posteriors, path scores and the autograd
    gradient of logZ against jax.grad."""
    rng = np.random.default_rng(4)
    B, T, L = 3, 9, 5
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    trans = _trans_of(kind, rng, B, T, L)
    lengths = np.asarray([T, 4, 0], np.int32)
    labels = rng.integers(0, L, size=(B, T)).astype(np.int32)
    js, jt, jn, jl = (jnp.asarray(a) for a in (state, trans, lengths,
                                               labels))
    ts, tt, tn, tl = _torch(state, trans, lengths, labels)
    ja, jz = jops.forward_batch(js, jt, jn)
    ta, tz = fwdbwd.forward_batch(ts, tt, tn)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(
        fwdbwd.posteriors_batch(ts, tt, tn).numpy(),
        np.asarray(jops.posteriors_batch(js, jt, jn)), **TOL)
    np.testing.assert_allclose(
        fwdbwd.path_score_batch(ts, tt, tl, tn).numpy(),
        np.asarray(jops.path_score_batch(js, jt, jl, jn)), **TOL)
    w = np.asarray([1.0, -2.0, 0.5], np.float32)
    jg = jax.grad(lambda s, t: jnp.sum(jnp.asarray(w)
                                       * jops.log_partition_batch(s, t, jn)),
                  argnums=(0, 1))(js, jt)
    ts.requires_grad_(True)
    tt.requires_grad_(True)
    (torch.from_numpy(w) * fwdbwd.log_partition_batch(ts, tt, tn)).sum() \
        .backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg[0]),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg[1]),
                               rtol=2e-3, atol=1e-5)


def test_generic_scan_shared_equals_repeated_and_checks_shapes():
    """(L, L) transitions equal the same matrix repeated per sequence and
    frame; a wrong frame count or shape raises, as in the JAX package."""
    rng = np.random.default_rng(5)
    B, T, L = 2, 6, 4
    state = torch.from_numpy(rng.normal(size=(B, T, L)).astype(np.float32))
    trans = torch.from_numpy(_trans_of("shared", rng, B, T, L))
    lengths = torch.tensor([T, 3], dtype=torch.int32)
    labels = torch.from_numpy(rng.integers(0, L, size=(B, T)))
    rep = trans[None, None].expand(B, T, L, L)
    for fn in (fwdbwd.log_partition_batch, fwdbwd.posteriors_batch,
               fwdbwd.backward_batch):
        assert torch.equal(fn(state, trans, lengths),
                           fn(state, rep, lengths))
    assert torch.equal(fwdbwd.path_score_batch(state, trans, labels, lengths),
                       fwdbwd.path_score_batch(state, rep, labels, lengths))
    with pytest.raises(ValueError, match="T="):
        fwdbwd.forward_batch(state, rep[:, :-1], lengths)
    with pytest.raises(ValueError, match="trans"):
        fwdbwd.log_partition_batch(state, trans[:-1], lengths)
