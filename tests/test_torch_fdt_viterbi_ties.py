"""Tie order of the port's factored Viterbi against the JAX package's XLA
decode and its TPU kernel (interpret mode), on adversarial inputs where
only the tie rules decide: all-zero weights (every score equal) or integer
weights and features (exact fp32 arithmetic, so ties survive any order of
summation).  Paths must be equal, scores allclose as in
test_torch_fdt_viterbi.py.
"""
import numpy as np
import pytest

from tests.test_torch_fdt_viterbi import (MODES, _assert_same, _jax_pallas,
                                          _jax_xla, _port_ops, _port_wall,
                                          _problem)


@pytest.mark.parametrize("integer", [False, True], ids=["zero", "integer"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ns", [1, 3])
def test_tie_order_matches_jax(ns, mode, integer):
    """self > advance > cross, first cross predecessor, first final
    argmax, ties at the K-th value kept."""
    thr, bw = MODES[mode]
    P = 5
    jcfg, tcfg, params, feats, lengths = _problem(
        7 + ns, P, ns, T=9, scale=0.3 if integer else 1.0, integer=integer)
    if not integer:
        params = {k: np.zeros_like(v) for k, v in params.items()}
    ref = _jax_xla(jcfg, params, feats, lengths, ns, thr, bw)
    _assert_same(_jax_pallas(jcfg, params, feats, lengths, ns, thr, bw),
                 ref, "pallas vs xla")
    _assert_same(_port_ops(tcfg, params, feats, lengths, ns, thr, bw), ref,
                 "ops")
    _assert_same(_port_wall(tcfg, params, feats, lengths, ns, thr, bw), ref,
                 "wall")
