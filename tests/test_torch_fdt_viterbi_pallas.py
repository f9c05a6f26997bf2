"""The plain version of the port's K3 kernel against the TPU kernel itself
(asr_craft_tpu.kernels.fdt_pallas.fdt_viterbi_pallas, run in interpret mode
as the JAX package's own tests run it on the CPU), on identical
numpy-seeded inputs, n-state topology (monophone:
test_torch_fdt_viterbi_pallas_mono.py; adversarial ties:
test_torch_fdt_viterbi_ties.py).  One file per topology keeps each under
20 s: every (P, ns, mode) compiles the interpreted kernel anew.

Paths must be equal; scores allclose at rtol=1e-5, atol=1e-4 (fp32 planes
summed in another order by PyTorch than by the TPU kernel's dot).
"""
import pytest

from tests.test_torch_fdt_viterbi import (MODES, _assert_same, _jax_pallas,
                                          _port_wall, _problem)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("P,ns", [(5, 3), (8, 3)])
def test_wall_plain_matches_jax_pallas_interpret(P, ns, mode):
    """The kernel's plain version (Wall packing + planes + DP) against the
    TPU kernel itself, run in interpret mode."""
    thr, bw = MODES[mode]
    jcfg, tcfg, params, feats, lengths = _problem(P * 10 + ns + 1, P, ns)
    _assert_same(_port_wall(tcfg, params, feats, lengths, ns, thr, bw),
                 _jax_pallas(jcfg, params, feats, lengths, ns, thr, bw), mode)
