"""The port's dense segmental oracle (``ops/segmental``) against the JAX
package's (``asr_craft_tpu.ops.segmental``) and the numpy oracles, on
identical numpy-seeded potentials.

Tolerances: fp32 log-sum-exp recursions over up to 14 frames, rtol 1e-5,
atol 1e-4 on alphas, logZ and scores; segmentations equal (continuous random
potentials: no ties)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.ops import oracle
from asr_craft_tpu.ops import segmental as jseg
from asr_craft_tpu_torch.ops import segmental as tseg

TOL = dict(rtol=1e-5, atol=1e-4)
SHAPES = [(3, 9, 4, 3), (2, 5, 8, 3), (2, 6, 6, 2), (4, 1, 2, 3),
          (2, 14, 5, 6)]                      # (B, T, Dmax, L)


def _problem(seed, B, T, Dmax, L, scale=0.8):
    rng = np.random.default_rng(seed)
    seg = (scale * rng.normal(size=(B, T, Dmax, L))).astype(np.float32)
    trans = (scale * rng.normal(size=(L, L))).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return seg, trans, lengths


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax_and_numpy_oracle(shape):
    B, T, Dmax, L = shape
    seg, trans, lengths = _problem(0, *shape)
    ja, jz = jseg.segmental_forward_batch(jnp.asarray(seg),
                                          jnp.asarray(trans),
                                          jnp.asarray(lengths))
    ta, tz = tseg.segmental_forward_batch(torch.from_numpy(seg),
                                          torch.from_numpy(trans),
                                          torch.from_numpy(lengths))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    for b in range(B):
        n = int(lengths[b])
        np.testing.assert_allclose(ta[b, :n].numpy(), np.asarray(ja)[b, :n],
                                   **TOL)
        alpha_np, z_np = oracle.segmental_forward_np(seg[b], trans, n, Dmax)
        np.testing.assert_allclose(ta[b, :n].numpy(), alpha_np, **TOL)
        np.testing.assert_allclose(float(tz[b]), z_np, **TOL)
        a1, z1 = tseg.segmental_forward(torch.from_numpy(seg[b]),
                                        torch.from_numpy(trans), n)
        assert torch.equal(a1, ta[b]) and float(z1) == float(tz[b])


@pytest.mark.parametrize("shape", SHAPES)
def test_viterbi_matches_jax_and_numpy_oracle(shape):
    B, T, Dmax, L = shape
    seg, trans, lengths = _problem(1, *shape)
    js, jl, jn, jsc = jseg.segmental_viterbi_batch(
        jnp.asarray(seg), jnp.asarray(trans), jnp.asarray(lengths))
    ts, tl, tn, tsc = tseg.segmental_viterbi_batch(
        torch.from_numpy(seg), torch.from_numpy(trans),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert ts.dtype == tl.dtype == tn.dtype == torch.int32
    for b in range(B):
        n = int(lengths[b])
        segs, score = oracle.segmental_viterbi_np(seg[b], trans, n, Dmax)
        k = int(tn[b])
        assert [s for s, _, _ in segs] == ts[b, :k].tolist()
        assert [l for _, _, l in segs] == tl[b, :k].tolist()
        np.testing.assert_allclose(float(tsc[b]), score, **TOL)


def test_viterbi_ties_fall_as_in_jax():
    """Integer potentials make ties certain: the shortest duration, then the
    lowest predecessor and the lowest final label, as the JAX argmaxes."""
    rng = np.random.default_rng(2)
    B, T, Dmax, L = 6, 10, 4, 3
    seg = rng.integers(-1, 2, size=(B, T, Dmax, L)).astype(np.float32)
    trans = rng.integers(-1, 2, size=(L, L)).astype(np.float32)
    lengths = np.array([10, 7, 1, 4, 10, 9], np.int32)
    js, jl, jn, jsc = jseg.segmental_viterbi_batch(
        jnp.asarray(seg), jnp.asarray(trans), jnp.asarray(lengths))
    ts, tl, tn, tsc = tseg.segmental_viterbi_batch(
        torch.from_numpy(seg), torch.from_numpy(trans),
        torch.from_numpy(lengths))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_forward_gradient_matches_jax_autodiff():
    """Autograd through the port's dense scan == jax.grad through the JAX
    one (the --dense_loss path), within 1e-4 of the largest entry."""
    B, T, Dmax, L = 3, 8, 3, 4
    seg, trans, lengths = _problem(3, B, T, Dmax, L)
    w = np.random.default_rng(4).normal(size=B).astype(np.float32)

    def jobj(s, tr):
        return jnp.sum(jnp.asarray(w) * jseg.segmental_forward_batch(
            s, tr, jnp.asarray(lengths))[1])

    jg = jax.grad(jobj, argnums=(0, 1))(jnp.asarray(seg), jnp.asarray(trans))
    s = torch.from_numpy(seg).requires_grad_(True)
    tr = torch.from_numpy(trans).requires_grad_(True)
    (torch.from_numpy(w) * tseg.segmental_forward_batch(
        s, tr, torch.from_numpy(lengths))[1]).sum().backward()
    for got, want in ((s.grad, jg[0]), (tr.grad, jg[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("T", [7, 12])
def test_segments_to_frames_matches_jax(T):
    rng = np.random.default_rng(5)
    B, K = 4, T
    starts = np.zeros((B, K), np.int32)
    labels = np.zeros((B, K), np.int32)
    n = np.array([3, 1, 0, 4], np.int32)
    lengths = np.array([T, T - 2, 0, T], np.int32)
    for b in range(B):
        starts[b, :n[b]] = np.sort(rng.choice(np.arange(1, T), size=n[b],
                                              replace=False))
        if n[b]:
            starts[b, 0] = 0
        labels[b, :n[b]] = rng.integers(0, 5, size=n[b])
    want = jax.vmap(lambda s, l, k, ln: jseg.segments_to_frames(
        s, l, k, ln, T))(jnp.asarray(starts), jnp.asarray(labels),
                         jnp.asarray(n), jnp.asarray(lengths))
    got = tseg.segments_to_frames(torch.from_numpy(starts),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(n),
                                  torch.from_numpy(lengths), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = tseg.segments_to_frames(torch.from_numpy(starts[0]),
                                  torch.from_numpy(labels[0]),
                                  torch.tensor(int(n[0])), int(lengths[0]), T)
    np.testing.assert_array_equal(one.numpy(), np.asarray(want)[0])
