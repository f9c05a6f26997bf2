"""Properties of the port's log-semiring fdt path against the JAX
package's ops.fdt: a long T, zero gradient on illegal pairs and dead
lattices, inert padding, and the frame posteriors.  Split from
test_torch_fdt_train.py (same helpers and tolerances) so each file stays
short: every shape compiles the JAX reference anew.
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu.ops import fdt as jfdt
from asr_craft_tpu_torch.models.topology import Topology
from asr_craft_tpu_torch.ops import fdt
from tests.test_torch_fdt_train import _grads_match, _jax, _problem, _torch


def test_long_T_matches_jax():
    jc, tc, params, feats, labels, lengths = _problem(4, 2, 27, 3, 3)
    _grads_match(jc, tc, 3, params, feats, labels, lengths, 3)


def test_illegal_pairs_get_zero_grad():
    ns, P = 2, 3
    jc, tc, params, feats, labels, lengths = _problem(5, 2, 7, P, ns)
    tp = _grads_match(jc, tc, ns, params, feats, labels, lengths, ns)
    g = tp["w_trans"].grad.numpy()
    mask = Topology(P, ns).transition_mask()
    np.testing.assert_array_equal(g[:, ~mask], 0.0)
    assert np.abs(g[:, mask]).sum() > 0
    np.testing.assert_array_equal(tp["b_trans"].grad.numpy()[~mask], 0.0)


def test_padding_inert():
    """Extra padded frames change neither the values nor the gradient."""
    ns, P = 3, 3
    _, tc, params, feats, labels, lengths = _problem(6, 2, 8, P, ns)
    outs = []
    for pad in (0, 5):
        tp, tf, tl, tn = _torch(
            params, np.pad(feats, ((0, 0), (0, pad), (0, 0))),
            np.pad(labels, ((0, 0), (0, pad))), lengths, grad=True)
        nll, zf, zc = fdt.fdt_nll_dual(tc, ns, tp, tf, tl, tn)
        nll.sum().backward()
        outs.append((zf.detach(), zc.detach(), tp["w_trans"].grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_dead_lattice_gets_zero_grad():
    """A length cut inside a phone (the end boundary unreachable) kills the
    clamped lattice: zc = NEG_INF and that row's numerator contributes no
    gradient; a row of length 0 contributes none through crf_loss's mask."""
    ns, P = 3, 4
    jc, tc, params, feats, labels, lengths = _problem(7, 3, 12, P, ns)
    lengths[1] = 6                    # 6 = one run of 4 + 2 frames
    tp = _grads_match(jc, tc, ns, params, feats, labels, lengths, ns)
    _, tf, tl, tn = _torch(params, feats, labels, lengths)
    _, zf, zc = fdt.fdt_nll_dual(tc, ns, tp, tf, tl, tn)
    assert zc[1].item() < -1e29 < zf[1].item()
    only = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    _, _, zc = fdt.fdt_nll_dual(tc, ns, only, tf[1:2], tl[1:2], tn[1:2])
    zc.sum().backward()
    for k, v in only.items():
        assert float(v.grad.abs().max()) == 0.0, k


@pytest.mark.parametrize("ns", [1, 2, 3])
def test_fdt_posteriors_match_jax(ns):
    P = 4
    jc, tc, params, feats, _, lengths = _problem(8, 3, 9, P, ns, D=7,
                                                 state_range=(0, 7),
                                                 trans_range=(1, 7))
    lengths = np.asarray([9, 7, 4], np.int32)
    jp, jf, jn = _jax(params, feats, lengths)
    ref = jfdt.fdt_posteriors(
        *jfdt.factored_planes(jp, jf, P * ns, ns, jc.state_range,
                              jc.trans_range), jn, ns)
    tp, tf, tn = _torch(params, feats, lengths)
    post = fdt.fdt_posteriors(
        *fdt.factored_planes(tp, tf, P * ns, ns, tc.state_range,
                             tc.trans_range), tn, ns)
    np.testing.assert_allclose(post.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    sums = post.sum(-1).numpy()
    valid = np.arange(9)[None, :] < lengths[:, None]
    np.testing.assert_allclose(sums[valid], 1.0, rtol=1e-4)
    np.testing.assert_array_equal(sums[~valid], 0.0)
