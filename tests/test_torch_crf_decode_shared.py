"""The port's shared-transition decode (models.crf.potentials + decode:
K7/K8's plain version on the CPU) against the JAX package's models.crf
(its XLA path, which is what the JAX package runs on the CPU), on identical
numpy-seeded parameters and frames; the sparse feature map; the configs 1,
3 and 5 and the hand-set posterior model.

Paths and phones must be equal.  Scores and potentials are allclose at
rtol=1e-5, atol=1e-4: the potentials are fp32 matmuls (or gathered sums)
whose terms are added in another order by PyTorch than by XLA.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recipes.swbd_multihost as swbd_recipe
import recipes.timit_mono as timit_recipe
import recipes.wsj_crandem as wsj_recipe
from asr_craft_tpu.models import crf as jcrf
from asr_craft_tpu.models import feature_map as jfm
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.flagship import (flagship, posterior_model, swbd,
                                          timit_mono, wsj_crandem)
from asr_craft_tpu_torch.models import crf
from asr_craft_tpu_torch.models import feature_map as fm
from asr_craft_tpu_torch.models.weights import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-4)
D, K = 10, 4
BEAMS = {"exact": {}, "threshold": {"beam_threshold": 2.0},
         "topk": {"beam_width": 4},
         "both": {"beam_threshold": 1.5, "beam_width": 3}}


def _configs(**kw):
    kw = dict(feat_dim=D, **kw)
    return jcrf.CrfConfig(**kw), crf.CrfConfig(**kw)


def _inputs(jcfg, seed, B=4, T=15, scale=0.5):
    """numpy params, dense frames, sparse (index, value) frames with
    padding slots and out-of-range indices, ragged lengths with a 0."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s, scale=scale).astype(np.float32)
              for k, s in jcfg.fmap.param_shapes().items()}
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    idx = rng.integers(0, D, size=(B, T, K)).astype(np.int32)
    val = rng.normal(size=(B, T, K)).astype(np.float32)
    idx[..., -1], val[..., -1] = 0, 0.0                 # a padding slot
    lengths = rng.integers(3, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = T, 0
    return params, feats, (idx, val), lengths


def _decode_both(jcfg, tcfg, params, feats, sparse, lengths, beams):
    jsp = tsp = None
    if sparse is not None:
        jsp = tuple(jnp.asarray(x) for x in sparse)
        tsp = tuple(torch.from_numpy(x) for x in sparse)
    j = jcrf.decode(jcfg, {k: jnp.asarray(v) for k, v in params.items()},
                    jnp.asarray(feats), jnp.asarray(lengths), sparse=jsp,
                    **beams)
    t = crf.decode(tcfg, params_from_numpy(params), torch.from_numpy(feats),
                   torch.from_numpy(lengths), sparse=tsp, **beams)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("beams", list(BEAMS))
@pytest.mark.parametrize("featuremap", ["dense", "sparse"])
@pytest.mark.parametrize("P,ns", [(6, 1), (4, 3), (130, 3)],
                         ids=["mono", "nstate", "nstate-P130"])
def test_decode_matches_jax(P, ns, featuremap, beams):
    """Monophone (K7's plain version), n-state with P <= 128 (K8's) and
    n-state with P > 128 (K7's at L' = 390)."""
    jcfg, tcfg = _configs(num_labels=P, num_states=ns,
                          featuremap=featuremap, state_range=(1, D))
    params, feats, sparse, lengths = _inputs(jcfg, P + ns, T=9 if P > 100
                                             else 15)
    (jph, jpa, jsc), (tph, tpa, tsc) = _decode_both(
        jcfg, tcfg, params, feats, sparse if featuremap == "sparse" else None,
        lengths, BEAMS[beams])
    np.testing.assert_array_equal(tpa, jpa)
    np.testing.assert_array_equal(tph, jph)
    np.testing.assert_allclose(tsc, jsc, **TOL)


@pytest.mark.parametrize("boundaries", [True, False])
def test_decode_boundaries_no_biases_matches_jax(boundaries):
    jcfg, tcfg = _configs(num_labels=5, num_states=2, use_state_bias=False,
                          enforce_boundaries=boundaries)
    params, feats, _, lengths = _inputs(jcfg, 3)
    (_, jpa, jsc), (_, tpa, tsc) = _decode_both(jcfg, tcfg, params, feats,
                                                None, lengths, {})
    np.testing.assert_array_equal(tpa, jpa)
    np.testing.assert_allclose(tsc, jsc, **TOL)


@pytest.mark.parametrize("ranges", [((0, D), (0, 0)), ((2, 8), (0, 0)),
                                    ((0, 6), (4, D))],
                         ids=["shared", "shared-state-range", "fdt"])
def test_sparse_potentials_match_jax(ranges):
    """Gather + weighted sum with range routing: out-of-range pairs add
    nothing; frame-dependent transitions included."""
    sr, tr = ranges
    kw = dict(feat_dim=D, num_expanded=6, state_range=sr, trans_range=tr)
    jcfg, tcfg = jfm.FeatureMapConfig(kind="sparse", **kw), \
        fm.FeatureMapConfig(**kw)
    rng = np.random.default_rng(7)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in jcfg.param_shapes().items()}
    _, _, (idx, val), _ = _inputs(jcrf.CrfConfig(num_labels=6, feat_dim=D),
                                  8)
    js, jt = jfm.sparse_potentials(
        jcfg, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(idx), jnp.asarray(val))
    ts, tt = fm.sparse_potentials(tcfg, params_from_numpy(params),
                                  torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    assert tt.shape == jt.shape


@pytest.mark.parametrize("ns", [1, 3])
def test_potentials_match_jax(ns):
    """State potentials allclose; the shared trans (bias plus the n-state
    penalty) equal to the bit."""
    jcfg, tcfg = _configs(num_labels=4, num_states=ns)
    params, feats, _, _ = _inputs(jcfg, 2)
    js, jt = jcrf.potentials(
        jcfg, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(feats))
    ts, tt = crf.potentials(tcfg, params_from_numpy(params),
                            torch.from_numpy(feats))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_shared_guards():
    """A CPU tensor under the 'cuda' backend raises, at every precision (no
    drop to the plain version); bf16x3 and default, refused on the kernel
    path until the kernels took them, decode on the plain path to the
    highest precision's paths here."""
    tcfg = crf.CrfConfig(num_labels=3, feat_dim=D, num_states=2)
    g = torch.Generator().manual_seed(0)
    params = tcfg.init_params(g, 0.5)
    feats = torch.randn((2, 9, D), generator=g)
    lengths = torch.tensor([9, 6])
    want = crf.decode(tcfg, params, feats, lengths)
    lows = [crf.CrfConfig(num_labels=3, feat_dim=D, num_states=2,
                          precision=p) for p in ("bf16x3", "default")]
    for low in lows:
        got = crf.decode(low, params, feats, lengths)
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    kernels.set_backend("cuda")
    try:
        for cfg in [tcfg] + lows:
            with pytest.raises(ValueError, match="CUDA tensor"):
                crf.decode(cfg, params, feats, lengths)
    finally:
        kernels.set_backend("auto")


@pytest.mark.parametrize("make,recipe,P,ns,window", [
    (timit_mono, timit_recipe, 48, 1, 1),
    (wsj_crandem, wsj_recipe, 42, 1, 2),
    (swbd, swbd_recipe, 46, 3, 2)], ids=["config1", "config3", "config5"])
def test_shared_configs_follow_their_recipes(make, recipe, P, ns, window):
    cfg = make()
    flags = recipe.TRAIN_ARGS
    for flag, want in (("--crf_label_size", P), ("--crf_states", ns),
                       ("--window_extent", window)):
        assert str(want) == flags[flags.index(flag) + 1], flag
    assert (cfg.num_labels, cfg.num_states) == (P, ns)
    assert cfg.feat_dim == P * (2 * window + 1)
    assert not cfg.fmap.frame_dependent_trans
    jcfg = jcrf.CrfConfig(num_labels=P, feat_dim=cfg.feat_dim,
                          num_states=ns)
    assert cfg.fmap.param_shapes() == jcfg.fmap.param_shapes()


def test_posterior_model_draws_shared_transitions():
    """A shared model gets b_trans = trans_scale * N(0, 1) from the seed;
    config 2's model (w_trans drawn, b_trans zero) is unchanged."""
    shared = posterior_model(timit_mono(), window_extent=1, seed=3,
                             trans_scale=0.5)
    want = (0.5 * np.random.default_rng(3).normal(size=(48, 48))).astype(
        np.float32)
    np.testing.assert_array_equal(shared["b_trans"], want)
    assert shared["w_state"][48 + 5, 5] == 4.0
    fdt = posterior_model(flagship())
    assert not fdt["b_trans"].any()
    np.testing.assert_array_equal(
        fdt["w_trans"], (0.01 * np.random.default_rng(0).normal(
            size=(144, 144, 144))).astype(np.float32))
