"""The port's log-semiring fdt path (ops.fdt: fdt_logZ_pair, fdt_nll_dual on
its plain autograd branch, fdt_posteriors) against the JAX package's
ops.fdt (its XLA path, what JAX runs on the CPU), on identical
numpy-seeded inputs.  Mirrors tests/oracle/test_fdt.py.

Tolerances are JAX's own for this comparison: values rtol=1e-4 (logZ sums
over up to 27 frames of fp32 lse), gradients rtol=3e-3, atol=3e-5 (the
gradient of a log-partition is a difference of posteriors, which loses
relative precision where two large expected counts nearly cancel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.models.feature_map import FeatureMapConfig as JaxFmap
from asr_craft_tpu.ops import fdt as jfdt
from asr_craft_tpu_torch.models.feature_map import FeatureMapConfig
from asr_craft_tpu_torch.ops import fdt

VAL = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=3e-3, atol=3e-5)


def _problem(seed, B, T, P, ns, D=12, clamp_ns=None, **fmap):
    """Both packages' feature maps and numpy inputs: phone runs of ns+1
    frames (state walks [0, 0, 1, .., ns-1] at clamp_ns=1), lengths >= ns
    with the first row full."""
    rng = np.random.default_rng(seed)
    kw = dict(feat_dim=D, num_expanded=P * ns,
              state_range=fmap.pop("state_range", (0, D - 1)),
              trans_range=fmap.pop("trans_range", (2, D)), **fmap)
    jc, tc = JaxFmap(**kw), FeatureMapConfig(**kw)
    params = {k: rng.normal(size=s, scale=0.3).astype(np.float32)
              for k, s in tc.param_shapes().items()}
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    run = ns + 1
    labels = np.repeat(rng.integers(0, P, size=(B, T // run + 1)), run,
                       axis=1)[:, :T]
    if clamp_ns == 1:
        steps = np.asarray([0] + list(range(ns)))
        labels = labels * ns + np.tile(steps, T // run + 1)[None, :T]
    lengths = rng.integers(max(ns, 1), T + 1, size=B)
    lengths[0] = T
    return (jc, tc, params, feats, labels.astype(np.int32),
            lengths.astype(np.int32))


def _jax(params, *arrays):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            *(jnp.asarray(a) for a in arrays))


def _torch(params, *arrays, grad=False):
    return ({k: torch.tensor(v, requires_grad=grad)
             for k, v in params.items()},
            *(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("B,T,P,ns", [(2, 9, 4, 1), (3, 11, 5, 2),
                                      (2, 13, 4, 3)])
def test_logZ_pair_matches_jax(B, T, P, ns):
    jc, tc, params, feats, labels, lengths = _problem(1, B, T, P, ns)
    jp, jf, jl, jn = _jax(params, feats, labels, lengths)
    jzf, jzc = jfdt.fdt_logZ_pair(
        *jfdt.factored_planes(jp, jf, P * ns, ns, jc.state_range,
                              jc.trans_range), jl, jn, ns, ns, True)
    tp, tf, tl, tn = _torch(params, feats, labels, lengths)
    zf, zc = fdt.fdt_logZ_pair(
        *fdt.factored_planes(tp, tf, P * ns, ns, tc.state_range,
                             tc.trans_range), tl, tn, ns, ns, True)
    np.testing.assert_allclose(zf.numpy(), np.asarray(jzf), **VAL)
    np.testing.assert_allclose(zc.numpy(), np.asarray(jzc), **VAL)


def _grads_match(jc, tc, ns, params, feats, labels, lengths, clamp_ns,
                 boundaries=True):
    """sum(2 nll + zf/4 - zc/2) and the gradient of every param, both
    packages' fdt_nll_dual."""
    jp, jf, jl, jn = _jax(params, feats, labels, lengths)

    def jloss(p):
        nll, zf, zc = jfdt.fdt_nll_dual(jc, ns, p, jf, jl, jn, clamp_ns,
                                        boundaries)
        return jnp.sum(nll * 2.0 + 0.25 * zf - 0.5 * zc)

    jv, jg = jax.value_and_grad(jloss)(jp)
    tp, tf, tl, tn = _torch(params, feats, labels, lengths, grad=True)
    nll, zf, zc = fdt.fdt_nll_dual(tc, ns, tp, tf, tl, tn, clamp_ns,
                                   boundaries)
    v = (nll * 2.0 + 0.25 * zf - 0.5 * zc).sum()
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(jv), **VAL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   **GRAD, err_msg=k)
    return tp


@pytest.mark.parametrize("ns,clamp_ns", [(1, 1), (3, 3), (3, 1)])
def test_nll_dual_grads_match_jax(ns, clamp_ns):
    jc, tc, params, feats, labels, lengths = _problem(
        2, 2, 9, 4, ns, clamp_ns=clamp_ns)
    # state-granular targets may be cut mid-phone: no end boundary there
    _grads_match(jc, tc, ns, params, feats, labels, lengths, clamp_ns,
                 boundaries=clamp_ns != 1)


def test_disjoint_ranges_no_biases_match_jax():
    jc, tc, params, feats, labels, lengths = _problem(
        3, 2, 10, 4, 2, state_range=(0, 7), trans_range=(5, 12),
        use_state_bias=False, use_trans_bias=False)
    _grads_match(jc, tc, 2, params, feats, labels, lengths, 2)
