"""The shared-transition slice as a whole — the port's models.crf crf_loss
(loss, aux, parameter gradients) and frame_posteriors for configs shaped
like BASELINE 1, 3 and 5 at narrow widths — against the JAX package's
models.crf on identical numpy-seeded inputs, with the parameters carried
across by the weights module.

Tolerances: the loss rtol=1e-5 (a per-frame mean of fp32 log-partitions),
logZ / numerator rtol=5e-4, atol=5e-5, gradients the JAX package's
rtol=2e-3, atol=1e-5, posteriors rtol=5e-4, atol=5e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.models import crf as jcrf
from asr_craft_tpu.models import weights as jweights
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.models import crf, weights
from asr_craft_tpu_torch.utils import diagnostics

TOL = dict(rtol=5e-4, atol=5e-5)
GRAD = dict(rtol=2e-3, atol=1e-5)
# name: (phones, states per phone, window frames): the recipes' shapes
# (48 x 1 x 3, 42 x 1 x 5, 46 x 3 x 5) at narrow widths
CONFIGS = {"config1": (6, 1, 3), "config3": (5, 1, 5), "config5": (4, 3, 5)}


def _configs(name, **kw):
    P, ns, win = CONFIGS[name]
    kw = dict(num_labels=P, feat_dim=P * win, num_states=ns, **kw)
    return jcrf.CrfConfig(**kw), crf.CrfConfig(**kw)


def _inputs(tcfg, seed, B=5, T=16, label_kind="phone"):
    """Params (b_trans and no w_trans: shared transitions), frames,
    topology-legal labels (phone runs of 4 frames, or their state walks),
    lengths on run ends with row 0 full and the last row empty."""
    rng = np.random.default_rng(seed)
    P, ns = tcfg.num_labels, tcfg.num_states
    shapes = tcfg.fmap.param_shapes()
    assert "b_trans" in shapes and "w_trans" not in shapes
    params = {k: rng.normal(size=s, scale=0.3).astype(np.float32)
              for k, s in shapes.items()}
    feats = rng.normal(size=(B, T, tcfg.feat_dim)).astype(np.float32)
    labels = np.repeat(rng.integers(0, P, size=(B, T // 4)), 4, axis=1)
    if label_kind == "state":
        walk = [0] * (4 - ns) + list(range(ns))
        labels = labels * ns + np.tile(walk, T // 4)[None, :]
    lengths = rng.integers(1, T // 4 + 1, size=B) * 4
    lengths[0], lengths[-1] = T, 0
    return (params, feats, labels.astype(np.int32),
            lengths.astype(np.int32))


def _sparse(feats, K_=6, seed=0):
    """(indices, values) (B, T, K): K random dims of each frame, the rest
    dropped (so the sparse model sees other frames than the dense one)."""
    rng = np.random.default_rng(seed)
    B, T, D = feats.shape
    idx = np.stack([np.stack([rng.permutation(D)[:K_] for _ in range(T)])
                    for _ in range(B)]).astype(np.int32)
    val = np.take_along_axis(feats, idx, axis=2)
    return idx, val


def _jax_loss_and_grads(jcfg, params, feats, labels, lengths, **kw):
    def f(p):
        return jcrf.crf_loss(jcfg, p, None if feats is None
                             else jnp.asarray(feats), jnp.asarray(labels),
                             jnp.asarray(lengths), **kw)
    return jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})


def _port_loss_and_grads(tcfg, params, feats, labels, lengths, **kw):
    p = {k: v.requires_grad_(True)
         for k, v in weights.params_from_numpy(params).items()}
    loss, aux = crf.crf_loss(tcfg, p, None if feats is None
                             else torch.from_numpy(feats),
                             torch.from_numpy(labels),
                             torch.from_numpy(lengths), **kw)
    loss.backward()
    return loss, aux, {k: v.grad for k, v in p.items()}


def _compare(jout, tout, lengths):
    (jl, jaux), jg = jout
    loss, aux, g = tout
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    live = lengths > 0
    for key in ("logZ", "numerator", "nll"):
        np.testing.assert_allclose(aux[key].detach().numpy()[live],
                                   np.asarray(jaux[key])[live], **TOL)
    assert int(aux["frames"]) == int(jaux["frames"]) == int(lengths.sum())
    assert aux["nll"][-1].item() == 0.0           # the empty row is inert
    assert set(g) == set(jg)
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]), **GRAD)


@pytest.mark.parametrize("label_kind", ["phone", "state"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_shared_crf_loss_matches_jax(name, label_kind):
    jcfg, tcfg = _configs(name)
    params, feats, labels, lengths = _inputs(tcfg, 1, label_kind=label_kind)
    before = diagnostics.launches()
    _compare(_jax_loss_and_grads(jcfg, params, feats, labels, lengths,
                                 label_kind=label_kind),
             _port_loss_and_grads(tcfg, params, feats, labels, lengths,
                                  label_kind=label_kind), lengths)
    assert diagnostics.launches() == before       # CPU tensors: plain only


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shared_sparse_crf_loss_matches_jax(name):
    jcfg, tcfg = _configs(name, featuremap="sparse")
    params, feats, labels, lengths = _inputs(tcfg, 2)
    idx, val = _sparse(feats)
    _compare(_jax_loss_and_grads(jcfg, params, None, labels, lengths,
                                 sparse=(jnp.asarray(idx), jnp.asarray(val))),
             _port_loss_and_grads(tcfg, params, None, labels, lengths,
                                  sparse=(torch.from_numpy(idx),
                                          torch.from_numpy(val))), lengths)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shared_crf_loss_without_biases_or_boundaries(name):
    """No state bias, and the boundary masks off (the n-state config then
    admits any start and end state)."""
    jcfg, tcfg = _configs(name, use_state_bias=False,
                          enforce_boundaries=False)
    params, feats, labels, lengths = _inputs(tcfg, 3)
    lengths[1] = 6                          # mid-run: legal without the masks
    _compare(_jax_loss_and_grads(jcfg, params, feats, labels, lengths),
             _port_loss_and_grads(tcfg, params, feats, labels, lengths),
             lengths)


@pytest.mark.parametrize("featuremap", ["dense", "sparse"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_shared_frame_posteriors_match_jax(name, featuremap):
    jcfg, tcfg = _configs(name, featuremap=featuremap)
    params, feats, _, lengths = _inputs(tcfg, 4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = weights.params_from_numpy(params)
    if featuremap == "sparse":
        idx, val = _sparse(feats)
        jpost = jcrf.frame_posteriors(
            jcfg, jp, None, jnp.asarray(lengths),
            sparse=(jnp.asarray(idx), jnp.asarray(val)))
        post = crf.frame_posteriors(
            tcfg, tp, None, torch.from_numpy(lengths),
            sparse=(torch.from_numpy(idx), torch.from_numpy(val)))
    else:
        jpost = jcrf.frame_posteriors(jcfg, jp, jnp.asarray(feats),
                                      jnp.asarray(lengths))
        post = crf.frame_posteriors(tcfg, tp, torch.from_numpy(feats),
                                    torch.from_numpy(lengths))
    np.testing.assert_allclose(post.numpy(), np.asarray(jpost), **TOL)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(post[b, :n].sum(-1).numpy(), 1.0,
                                   rtol=5e-4)
        assert not post[b, n:].any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shared_params_cross_both_ways_through_weight_files(name, tmp_path):
    """A shared model's tree has b_trans and no w_trans: the flat weight
    file of either package loads in the other, and both give the same
    loss on it."""
    jcfg, tcfg = _configs(name)
    params, feats, labels, lengths = _inputs(tcfg, 5)
    assert sorted(tcfg.fmap.param_shapes()) == sorted(
        jcfg.fmap.param_shapes()) == ["b_state", "b_trans", "w_state"]
    jweights.save_raw(tmp_path / "jax.dat", jcfg.fmap,
                      {k: jnp.asarray(v) for k, v in params.items()})
    loaded = weights.load_raw(tmp_path / "jax.dat", tcfg.fmap)
    for k, v in params.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v)
    weights.save_raw(tmp_path / "port.dat", tcfg.fmap, loaded)
    assert (tmp_path / "port.dat").read_bytes() == \
        (tmp_path / "jax.dat").read_bytes()
    back = jweights.load_raw(tmp_path / "port.dat", jcfg.fmap)
    jl = jcrf.crf_loss(jcfg, back, jnp.asarray(feats), jnp.asarray(labels),
                       jnp.asarray(lengths))[0]
    tl = crf.crf_loss(tcfg, loaded, torch.from_numpy(feats),
                      torch.from_numpy(labels), torch.from_numpy(lengths))[0]
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)


def test_shared_guards_on_the_kernel_path():
    """Where a kernel would run, a CPU tensor under the 'cuda' backend
    raises at every precision: no drop to the plain version.  (bf16x3,
    which raised there until the kernels took it, runs on the plain path;
    tests/test_torch_precision_shared.py holds its numbers.)"""
    _, tcfg = _configs("config5")
    _, low = _configs("config5", precision="bf16x3")
    params, feats, labels, lengths = _inputs(tcfg, 6)
    tp = weights.params_from_numpy(params)
    args = (torch.from_numpy(feats), torch.from_numpy(labels),
            torch.from_numpy(lengths))
    crf.crf_loss(low, tp, *args)
    crf.frame_posteriors(low, tp, args[0], args[2])
    before = diagnostics.launches()
    kernels.set_backend("cuda")
    try:
        for cfg in (low, tcfg):
            with pytest.raises(ValueError, match="CUDA tensor"):
                crf.crf_loss(cfg, tp, *args)
            with pytest.raises(ValueError, match="CUDA tensor"):
                crf.frame_posteriors(cfg, tp, args[0], args[2])
    finally:
        kernels.set_backend("auto")
    assert diagnostics.launches() == before
