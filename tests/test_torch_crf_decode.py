"""The port's models.crf.decode against the JAX package's models.crf.decode
(its XLA path, which is what the JAX package runs on the CPU), on identical
numpy-seeded parameters and frames, plus the flagship helpers.

Paths must be equal; scores allclose at rtol=1e-5, atol=1e-4 (fp32 planes
summed in another order by PyTorch than by XLA).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from asr_craft_tpu.models import crf as jcrf
from asr_craft_tpu_torch.flagship import (flagship, posterior_model,
                                          ragged_lengths, tiny_batch)
from asr_craft_tpu_torch.models import crf
from asr_craft_tpu_torch.models.weights import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-4)
P, NS, D = 6, 3, 18


def _configs(**kw):
    kw = dict(num_labels=P, feat_dim=D, num_states=NS, trans_range=(0, D),
              **kw)
    return jcrf.CrfConfig(**kw), crf.CrfConfig(**kw)


def _inputs(jcfg, seed, B=4, T=21, scale=0.3):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s, scale=scale).astype(np.float32)
              for k, s in jcfg.fmap.param_shapes().items()}
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    return params, feats, ragged_lengths(B, T, seed)


@pytest.mark.parametrize("beams", [{}, {"beam_threshold": 3.0},
                                   {"beam_width": 5},
                                   {"beam_threshold": 2.0, "beam_width": 4}],
                         ids=["exact", "threshold", "topk", "both"])
@pytest.mark.parametrize("boundaries", [True, False])
def test_decode_matches_jax(beams, boundaries):
    jcfg, tcfg = _configs(enforce_boundaries=boundaries)
    params, feats, lengths = _inputs(jcfg, 5)
    jph, jpa, jsc = jcrf.decode(
        jcfg, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(feats), jnp.asarray(lengths), **beams)
    tph, tpa, tsc = crf.decode(tcfg, params_from_numpy(params),
                               torch.from_numpy(feats),
                               torch.from_numpy(lengths), **beams)
    np.testing.assert_array_equal(tpa.numpy(), np.asarray(jpa))
    np.testing.assert_array_equal(tph.numpy(), np.asarray(jph))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), **TOL)


def test_decode_disjoint_ranges_no_biases_matches_jax():
    jcfg = jcrf.CrfConfig(num_labels=P, feat_dim=D, num_states=NS,
                          state_range=(0, 12), trans_range=(6, D),
                          use_state_bias=False, use_trans_bias=False)
    tcfg = crf.CrfConfig(num_labels=P, feat_dim=D, num_states=NS,
                         state_range=(0, 12), trans_range=(6, D),
                         use_state_bias=False, use_trans_bias=False)
    params, feats, lengths = _inputs(jcfg, 6)
    _, jpa, jsc = jcrf.decode(
        jcfg, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(feats), jnp.asarray(lengths))
    _, tpa, tsc = crf.decode(tcfg, params_from_numpy(params),
                             torch.from_numpy(feats),
                             torch.from_numpy(lengths))
    np.testing.assert_array_equal(tpa.numpy(), np.asarray(jpa))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), **TOL)


def test_frame_accuracy_matches_jax():
    rng = np.random.default_rng(2)
    phones = rng.integers(0, P, size=(3, 10)).astype(np.int32)
    labels = np.where(rng.random((3, 10)) < 0.6, phones, 0).astype(np.int32)
    lengths = np.array([10, 4, 0], np.int32)
    want = float(jcrf.frame_accuracy(jnp.asarray(phones), jnp.asarray(labels),
                                     jnp.asarray(lengths)))
    got = float(crf.frame_accuracy(torch.from_numpy(phones),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(lengths)))
    assert got == pytest.approx(want, rel=1e-6)


def test_unported_branches_raise():
    """The shared-transition decode, training criterion and posteriors
    are ported; a sparse feature map is ported and, as in JAX, wants its
    (indices, values) pairs."""
    tcfg = crf.CrfConfig(num_labels=P, feat_dim=D, num_states=NS)
    params = tcfg.init_params()
    feats = torch.zeros((1, 4, D))
    lengths = torch.tensor([4])
    labels = torch.zeros((1, 4), dtype=torch.int32)
    phones, paths, scores = crf.decode(tcfg, params, feats, lengths)
    assert paths.tolist() == [[0, 0, 1, 2]] and phones.tolist() == [[0] * 4]
    assert float(scores[0]) == 0.0
    loss, _ = crf.crf_loss(tcfg, params, feats, labels, lengths)
    assert torch.isfinite(loss)
    post = crf.frame_posteriors(tcfg, params, feats, lengths)
    assert post.shape == (1, 4, P * NS)
    sparse = crf.CrfConfig(num_labels=P, feat_dim=D, num_states=NS,
                           trans_range=(0, D), featuremap="sparse")
    with pytest.raises(ValueError, match="sparse=\\(indices, values\\)"):
        crf.decode(sparse, sparse.init_params(), feats, lengths)


def test_flagship_matches_graft_entry():
    j = graft._flagship()
    t = flagship()
    for f in ("num_labels", "feat_dim", "num_states", "state_range",
              "trans_range", "use_state_bias", "use_trans_bias",
              "featuremap", "precision", "enforce_boundaries"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.fmap.param_shapes() == j.fmap.param_shapes()
    jb = graft._tiny_batch(j, B=2, T=16, seed=3)
    tb = tiny_batch(t, B=2, T=16, seed=3)
    for k in ("feats", "labels", "lengths"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), k)


def test_posterior_model_decodes_posteriors():
    """The hand-set model of chip_smoke's end-to-end phase, at P=6: the
    centre-window posterior of phone p feeds p's states, so a clean
    one-hot utterance decodes to its own phones; JAX and the port agree."""
    jcfg, tcfg = _configs()
    params = posterior_model(tcfg, window_extent=1, seed=0)
    assert params["w_state"][P + 2, 3 * 2:3 * 2 + 3].tolist() == [4.0] * 3
    truth = np.repeat(np.array([0, 3, 1, 4, 2]), 4)
    post = np.eye(P, dtype=np.float32)[truth]
    feats = np.concatenate([np.roll(post, 1, 0), post, np.roll(post, -1, 0)],
                           axis=1)[None]
    lengths = np.array([len(truth)], np.int32)
    tph, _, tsc = crf.decode(tcfg, params_from_numpy(params),
                             torch.from_numpy(feats),
                             torch.from_numpy(lengths))
    jph, _, jsc = jcrf.decode(
        jcfg, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(feats), jnp.asarray(lengths))
    np.testing.assert_array_equal(tph.numpy()[0], truth)
    np.testing.assert_array_equal(tph.numpy(), np.asarray(jph))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), **TOL)
