"""The port's models.crf training surface — crf_loss (both label kinds,
grad_feats, empty rows), frame_posteriors, densify_sparse, sparse crf_loss
and sparse decode, apply_boundaries — against the JAX package's
models.crf on identical numpy-seeded inputs.

Tolerances: the loss rtol=1e-5 (a per-frame mean of fp32 log-partitions),
gradients JAX's rtol=3e-3, atol=3e-5, posteriors rtol=2e-4, atol=2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.models import crf as jcrf
from asr_craft_tpu.models.feature_map import densify_sparse as jdensify
from asr_craft_tpu_torch.flagship import ragged_lengths
from asr_craft_tpu_torch.models import crf
from asr_craft_tpu_torch.models.feature_map import densify_sparse

GRAD = dict(rtol=3e-3, atol=3e-5)
P, NS, D = 4, 3, 10


def _configs(**kw):
    kw = dict(num_labels=P, feat_dim=D, num_states=NS, trans_range=(1, D),
              **kw)
    return jcrf.CrfConfig(**kw), crf.CrfConfig(**kw)


def _inputs(cfg, seed, B=4, T=15, label_kind="phone"):
    """Params, frames, topology-legal labels (phone runs of 4 frames, or
    their state walks [0, 0, 1, 2]) and ragged lengths with an empty last
    row."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s, scale=0.3).astype(np.float32)
              for k, s in cfg.fmap.param_shapes().items()}
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    labels = np.repeat(rng.integers(0, P, size=(B, T // 4 + 1)), 4,
                       axis=1)[:, :T]
    if label_kind == "state":
        labels = labels * NS + np.tile([0, 0, 1, 2], T // 4 + 1)[None, :T]
    lengths = ragged_lengths(B, T, seed)
    return params, feats, labels.astype(np.int32), lengths


def _jax_loss(jcfg, params, feats, labels, lengths, **kw):
    def f(p, x):
        return jcrf.crf_loss(jcfg, p, x, jnp.asarray(labels),
                             jnp.asarray(lengths), **kw)[0]
    return jax.value_and_grad(f, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats))


@pytest.mark.parametrize("grad_feats", [False, True])
@pytest.mark.parametrize("label_kind", ["phone", "state"])
def test_crf_loss_matches_jax(label_kind, grad_feats):
    boundaries = label_kind == "phone"     # state walks may end mid-phone
    jcfg, tcfg = _configs(enforce_boundaries=boundaries)
    params, feats, labels, lengths = _inputs(tcfg, 1, label_kind=label_kind)
    jv, (jg, jgf) = _jax_loss(jcfg, params, feats, labels, lengths,
                              label_kind=label_kind, grad_feats=grad_feats)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tf = torch.tensor(feats, requires_grad=True)
    loss, aux = crf.crf_loss(tcfg, tp, tf, torch.from_numpy(labels),
                             torch.from_numpy(lengths),
                             label_kind=label_kind, grad_feats=grad_feats)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    assert int(aux["frames"]) == int(lengths.sum())
    assert aux["nll"][-1].item() == 0.0                   # the empty row
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   **GRAD, err_msg=k)
    if grad_feats:
        np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), **GRAD)
        assert float(tf.grad[-1].abs().max()) == 0.0
    else:
        assert tf.grad is None
        assert float(np.abs(np.asarray(jgf)).max()) == 0.0


def test_all_rows_empty_is_zero_loss_and_gradient():
    _, tcfg = _configs()
    params, feats, labels, _ = _inputs(tcfg, 2, B=2)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    loss, aux = crf.crf_loss(tcfg, tp, torch.from_numpy(feats),
                             torch.from_numpy(labels),
                             torch.zeros(2, dtype=torch.int32))
    loss.backward()
    assert loss.item() == 0.0 and int(aux["frames"]) == 1
    for k, v in tp.items():
        assert float(v.grad.abs().max()) == 0.0, k


@pytest.mark.parametrize("ns", [1, 3])
def test_frame_posteriors_match_jax(ns):
    jcfg = jcrf.CrfConfig(num_labels=P, feat_dim=D, num_states=ns,
                          trans_range=(1, D))
    tcfg = crf.CrfConfig(num_labels=P, feat_dim=D, num_states=ns,
                         trans_range=(1, D))
    params, feats, _, lengths = _inputs(tcfg, 3)
    ref = jcrf.frame_posteriors(
        jcfg, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(feats), jnp.asarray(lengths))
    post = crf.frame_posteriors(
        tcfg, {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(feats), torch.from_numpy(lengths))
    np.testing.assert_allclose(post.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)


def test_apply_boundaries_matches_jax():
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(4)
    state = rng.normal(size=(3, 6, P * NS)).astype(np.float32)
    lengths = np.array([6, 2, 0], np.int32)
    ref = jcrf.apply_boundaries(jcfg, jnp.asarray(state),
                                jnp.asarray(lengths))
    got = crf.apply_boundaries(tcfg, torch.from_numpy(state),
                               torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _sparse_inputs(seed, B=3, T=12, K=4):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, D, size=(B, T, K)).astype(np.int32)
    val = rng.normal(size=(B, T, K)).astype(np.float32)
    idx[:, :, -1], val[:, :, -1] = 0, 0.0       # the loader's padding slot
    return idx, val


def test_densify_sparse_matches_jax():
    idx, val = _sparse_inputs(5)
    idx[0, 0, :2] = 3                           # duplicates accumulate
    ref = jdensify(jnp.asarray(idx), jnp.asarray(val), D)
    got = densify_sparse(torch.from_numpy(idx), torch.from_numpy(val), D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_sparse_crf_loss_and_decode_match_jax():
    jcfg, tcfg = _configs(featuremap="sparse")
    params, _, labels, lengths = _inputs(tcfg, 6, B=3, T=12)
    idx, val = _sparse_inputs(6)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jsp = (jnp.asarray(idx), jnp.asarray(val))

    def jloss(p):
        return jcrf.crf_loss(jcfg, p, None, jnp.asarray(labels),
                             jnp.asarray(lengths), sparse=jsp)[0]

    jv, jg = jax.value_and_grad(jloss)(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tsp = (torch.from_numpy(idx), torch.from_numpy(val))
    loss, _ = crf.crf_loss(tcfg, tp, None, torch.from_numpy(labels),
                           torch.from_numpy(lengths), sparse=tsp)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   **GRAD, err_msg=k)
    jph, jpa, jsc = jcrf.decode(jcfg, jp, None, jnp.asarray(lengths),
                                sparse=jsp)
    tph, tpa, tsc = crf.decode(tcfg, {k: v.detach() for k, v in tp.items()},
                               None, torch.from_numpy(lengths), sparse=tsp)
    np.testing.assert_array_equal(tpa.numpy(), np.asarray(jpa))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5,
                               atol=1e-4)
