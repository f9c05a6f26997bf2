"""Weight files, parameter layout, topology and feature map: the port against
the JAX package.  A lambda file written by either package loads in the
other; numpy parameters convert unchanged; the structural masks and the
dense potentials agree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.models import feature_map as jfm
from asr_craft_tpu.models import topology as jtopo
from asr_craft_tpu.models import weights as jweights
from asr_craft_tpu_torch.models import feature_map as tfm
from asr_craft_tpu_torch.models import topology as ttopo
from asr_craft_tpu_torch.models import weights as tweights

CONFIGS = [
    dict(feat_dim=12, num_expanded=15, trans_range=(0, 12)),
    dict(feat_dim=12, num_expanded=6, state_range=(0, 8),
         trans_range=(4, 12), use_state_bias=False, use_trans_bias=False),
    dict(feat_dim=9, num_expanded=4),                 # bias-only transitions
]


def _np_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in cfg.param_shapes().items()}


@pytest.mark.parametrize("kw", CONFIGS)
def test_param_layout_matches_jax(kw):
    j, t = jfm.FeatureMapConfig(**kw), tfm.FeatureMapConfig(**kw)
    assert t.param_shapes() == j.param_shapes()
    assert t.num_params() == j.num_params()
    assert t.frame_dependent_trans == j.frame_dependent_trans


@pytest.mark.parametrize("kw", CONFIGS)
def test_jax_file_loads_in_port(tmp_path, kw):
    cfg = jfm.FeatureMapConfig(**kw)
    params = _np_params(cfg, 1)
    jweights.save_raw(tmp_path / "w.dat", cfg, params)
    got = tweights.load_raw(tmp_path / "w.dat", tfm.FeatureMapConfig(**kw))
    assert set(got) == set(params)
    for k, v in params.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("kw", CONFIGS)
def test_port_file_loads_in_jax(tmp_path, kw):
    cfg = tfm.FeatureMapConfig(**kw)
    params = cfg.init_params(torch.Generator().manual_seed(2), 0.5)
    tweights.save_raw(tmp_path / "w.dat", cfg, params)
    got = jweights.load_raw(tmp_path / "w.dat", jfm.FeatureMapConfig(**kw))
    for k, v in params.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    np.testing.assert_array_equal(
        tweights.flatten_params(cfg, params),
        jweights.flatten_params(jfm.FeatureMapConfig(**kw),
                                {k: v.numpy() for k, v in params.items()}))


def test_params_from_numpy_and_size_check():
    cfg = tfm.FeatureMapConfig(**CONFIGS[0])
    params = _np_params(cfg, 3)
    got = tweights.params_from_numpy(params)
    for k, v in params.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)
    got[next(iter(got))].add_(1.0)          # a copy, not a view of numpy
    assert not np.array_equal(got[next(iter(got))].numpy(),
                              params[next(iter(params))])
    with pytest.raises(ValueError, match="entries"):
        tweights.unflatten_params(cfg, np.zeros(cfg.num_params() + 1))
    with pytest.raises(ValueError, match="missing"):
        tweights.flatten_params(cfg, {"w_state": got["w_state"]})


@pytest.mark.parametrize("ns", [1, 3])
def test_scrf_params_from_numpy_and_npz_round_trip(tmp_path, ns):
    """SCRF parameters (a 2-D ``w_frame``, or 3-D for n-state segments)
    cross with ``params_from_numpy`` and come back unchanged through
    ``save_npz`` / ``load_npz``, the JAX package's reader included."""
    from asr_craft_tpu.models.segmental import SegCrfConfig
    cfg = SegCrfConfig(num_labels=5, feat_dim=7, max_dur=4, num_states=ns)
    rng = np.random.default_rng(7)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in cfg.param_shapes().items()}
    assert params["w_frame"].ndim == (2 if ns == 1 else 3)
    got = tweights.params_from_numpy(params)
    assert set(got) == {"w_frame", "b_trans", "b_dur", "b_seg"}
    for k, v in params.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)
    tweights.save_npz(tmp_path / "w.npz", got)
    back, jback = (tweights.load_npz(tmp_path / "w.npz"),
                   jweights.load_npz(tmp_path / "w.npz"))
    for k, v in params.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
        np.testing.assert_array_equal(jback[k], v)
        assert jback[k].dtype == np.float32


def test_init_params_seeded_and_zero():
    cfg = tfm.FeatureMapConfig(**CONFIGS[0])
    a = cfg.init_params(torch.Generator().manual_seed(4), 0.1)
    b = cfg.init_params(torch.Generator().manual_seed(4), 0.1)
    for k in a:
        assert torch.equal(a[k], b[k])
        assert float(a[k].std()) == pytest.approx(0.1, rel=0.5)
    z = cfg.init_params()
    assert all(float(v.abs().max()) == 0.0 for v in z.values())


@pytest.mark.parametrize("kw", CONFIGS)
def test_dense_potentials_match_jax(kw):
    j, t = jfm.FeatureMapConfig(**kw), tfm.FeatureMapConfig(**kw)
    params = _np_params(j, 5)
    feats = np.random.default_rng(6).normal(
        size=(2, 7, j.feat_dim)).astype(np.float32)
    js, jt = jfm.dense_potentials(j, {k: jnp.asarray(v) for k, v in
                                      params.items()}, jnp.asarray(feats))
    ts, tt = tfm.dense_potentials(t, tweights.params_from_numpy(params),
                                  torch.from_numpy(feats))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,k", [(4, 1), (5, 3), (3, 2)])
def test_topology_matches_jax(n, k):
    j, t = jtopo.Topology(n, k), ttopo.Topology(n, k)
    assert t.num_expanded == j.num_expanded
    for name in ("transition_mask", "transition_penalty", "start_penalty",
                 "end_penalty"):
        np.testing.assert_array_equal(getattr(t, name)(),
                                      getattr(j, name)(), err_msg=name)
    labels = np.random.default_rng(n).integers(0, n, size=(2, 6))
    np.testing.assert_array_equal(
        t.clamp_mask(torch.from_numpy(labels)).numpy(),
        np.asarray(j.clamp_mask(jnp.asarray(labels))))
    paths = np.arange(n * k).reshape(1, -1)
    np.testing.assert_array_equal(
        t.path_to_phones(torch.from_numpy(paths)).numpy(),
        np.asarray(j.path_to_phones(jnp.asarray(paths))))
