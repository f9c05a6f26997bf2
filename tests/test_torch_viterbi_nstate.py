"""The port's plain n-state decode (asr_craft_tpu_torch.ops.viterbi on the
dense topology-masked trans: the plain version of the K8 kernel) against
the JAX package's K8 kernel itself (viterbi_pallas_nstate, run in interpret
mode as the JAX package's own tests run it on the CPU), on identical
numpy-seeded inputs.

On continuous random inputs paths are equal and scores allclose at rtol
1e-5, atol 1e-5 (K8 adds the factored weights in another grouping).  On
tied inputs they may differ: K8 breaks exact ties in its plane-major order
``s * pp + q`` (viterbi_pallas.py:297-305, :376-404) where the XLA path, K7
and the port take the first argmax in expanded order ``q * ns + s``.  There
the near-tie rule holds: a differing K8 path rescores (``path_score``) to
the port's score.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels.viterbi_pallas import viterbi_pallas_nstate
from asr_craft_tpu.ops.viterbi import viterbi_batch
from asr_craft_tpu_torch.ops import viterbi as V
from tests.test_torch_viterbi import MODES, port, problem

TOL = dict(rtol=1e-5, atol=1e-5)


def jax_k8(state, trans, lengths, ns, thr=None, bw=None):
    paths, scores = viterbi_pallas_nstate(
        jnp.moveaxis(jnp.asarray(state), 1, 0), jnp.asarray(trans),
        jnp.asarray(lengths), ns, beam_threshold=thr, beam_width=bw,
        interpret=True)
    return np.asarray(paths), np.asarray(scores)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P,ns", [(5, 3), (4, 2)])
def test_matches_k8_interpret_on_continuous_inputs(P, ns, mode):
    thr, bw = MODES[mode]
    state, trans, lengths = problem(P * 7 + ns, P, ns, B=4, T=11)
    lengths[1] = 5                     # every row can reach a last state
    tp, ts = port(state, trans, lengths, thr, bw)
    kp, ks = jax_k8(state, trans, lengths, ns, thr, bw)
    np.testing.assert_allclose(ts, ks, **TOL)
    np.testing.assert_array_equal(tp, kp)


def test_k8_tie_order_differs_on_integer_inputs_near_tie_rule():
    """P=5, ns=2, B=16, T=12, seeds 0-5, potentials in {0, 1} plus the
    topology and boundary penalties: the port equals the XLA path in every
    row; K8's paths differ in some rows, each a near-tie (same score, and
    its path rescores to it)."""
    n_diff = 0
    for seed in range(6):
        state, trans, lengths = problem(seed, 5, 2, B=16, T=12,
                                        kind="integer")
        tp, ts = port(state, trans, lengths, None, None)
        xp, xs = viterbi_batch(jnp.asarray(state), jnp.asarray(trans),
                               jnp.asarray(lengths))
        np.testing.assert_array_equal(tp, np.asarray(xp))
        kp, ks = jax_k8(state, trans, lengths, 2)
        np.testing.assert_allclose(ks, ts, **TOL)
        diff = (kp != tp).any(axis=1)
        n_diff += int(diff.sum())
        rescored = V.path_score(torch.from_numpy(state),
                                torch.from_numpy(trans),
                                torch.from_numpy(kp.astype(np.int32)),
                                torch.from_numpy(lengths)).numpy()
        np.testing.assert_allclose(rescored[diff], ts[diff], **TOL)
    assert n_diff > 0, "K8's plane-major tie order no longer shows"
