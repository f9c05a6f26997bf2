"""The ops surface the JAX package exposes beside its kernels, held to its
JAX twins on numpy-seeded inputs: ``ops.viterbi.viterbi`` (one utterance)
and ``ops.viterbi.viterbi_batch`` over shared ``(L, L)``, shared ``(T, L,
L)`` and per-sequence ``(B, T, L, L)`` transitions, exact and pruned;
``ops.fwdbwd``'s batched functions on shared ``(T, L, L)`` transitions;
``models.segmental.nstate_cuts``.

Viterbi paths must be equal (N(0, 1) scores have no ties) and scores
within rtol 1e-5; alphas and logZ within rtol 1e-5, atol 1e-5 (sums over
up to 17 frames of fp32 lse in another order).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.models import segmental as jseg
from asr_craft_tpu.ops import fwdbwd as jfb
from asr_craft_tpu_torch import ops as tops
from asr_craft_tpu_torch.models import segmental as tseg
from asr_craft_tpu_torch.ops import fwdbwd as tfb
from asr_craft_tpu_torch.ops import viterbi as tvit

# the module: the JAX package's ops/__init__ binds the name to the function
jvit = importlib.import_module("asr_craft_tpu.ops.viterbi")
B, T, L = 3, 17, 6
BEAMS = {"exact": (None, None), "threshold": (None, 1.5), "topk": (2, None)}


def _inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(B, T, L)).astype(np.float32)
    shape = {"LL": (L, L), "TLL": (T, L, L), "BTLL": (B, T, L, L)}[kind]
    trans = rng.normal(size=shape).astype(np.float32)
    lengths = np.array([T, 9, 1], dtype=np.int32)
    return state, trans, lengths


@pytest.mark.parametrize("beams", list(BEAMS))
@pytest.mark.parametrize("kind", ["LL", "TLL", "BTLL"])
def test_viterbi_batch_matches_jax(kind, beams):
    state, trans, lengths = _inputs(kind)
    bw, thr = BEAMS[beams]
    jp, js = jvit.viterbi_batch(jnp.asarray(state), jnp.asarray(trans),
                                jnp.asarray(lengths), bw, thr)
    tp, ts = tvit.viterbi_batch(torch.from_numpy(state),
                                torch.from_numpy(trans),
                                torch.from_numpy(lengths), bw, thr)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    assert tops.viterbi_batch is tvit.viterbi_batch


@pytest.mark.parametrize("length", [T, 5, 0])
@pytest.mark.parametrize("kind", ["LL", "TLL"])
def test_viterbi_one_utterance_matches_jax(kind, length):
    """(T,) path and score; padded frames repeat label ``length - 1``."""
    state, trans, _ = _inputs(kind, seed=1)
    for bw, thr in BEAMS.values():
        jp, js = jvit.viterbi(jnp.asarray(state[0]), jnp.asarray(trans),
                              jnp.asarray(length), bw, thr)
        tp, ts = tvit.viterbi(torch.from_numpy(state[0]),
                              torch.from_numpy(trans), length, bw, thr)
        assert tp.shape == (T,) and tp.dtype == torch.int32
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
        if 0 < length < T:
            assert (tp[length - 1:] == tp[length - 1]).all()


def test_fwdbwd_batch_on_shared_frame_transitions():
    """forward_batch, log_partition_batch, posteriors_batch and
    path_score_batch on shared (T, L, L) transitions, as JAX's take them."""
    state, trans, lengths = _inputs("TLL", seed=2)
    labels = np.random.default_rng(3).integers(0, L, size=(B, T)).astype(
        np.int32)
    j = [jnp.asarray(a) for a in (state, trans, lengths)]
    t = [torch.from_numpy(a) for a in (state, trans, lengths)]
    ja, jz = jfb.forward_batch(*j)
    ta, tz = tfb.forward_batch(*t)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **tol)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tol)
    np.testing.assert_allclose(tfb.log_partition_batch(*t).numpy(),
                               np.asarray(jfb.log_partition_batch(*j)),
                               **tol)
    np.testing.assert_allclose(tfb.posteriors_batch(*t).numpy(),
                               np.asarray(jfb.posteriors_batch(*j)), **tol)
    np.testing.assert_allclose(
        tfb.path_score_batch(t[0], t[1], torch.from_numpy(labels),
                             t[2]).numpy(),
        np.asarray(jfb.path_score_batch(j[0], j[1], jnp.asarray(labels),
                                        j[2])), **tol)
    with pytest.raises(ValueError, match="T="):
        tfb.forward_batch(t[0], t[1][:-1], t[2])


@pytest.mark.parametrize("max_dur,ns", [(1, 1), (5, 2), (8, 3), (16, 3),
                                        (6, 4)])
def test_nstate_cuts_matches_jax(max_dur, ns):
    np.testing.assert_array_equal(np.asarray(tseg.nstate_cuts(max_dur, ns)),
                                  np.asarray(jseg.nstate_cuts(max_dur, ns)))
    assert "nstate_cuts" in tseg.__all__
