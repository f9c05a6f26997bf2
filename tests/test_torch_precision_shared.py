"""The ``bf16x3`` and ``default`` precisions outside the fdt kernels,
against the JAX package on the CPU: the shared configs' potentials (the
dense feature map's products, then the K4/K5 recursions' plain versions)
and the segmental frame scores.

- Shared configs (1, 3, 5): ``crf_loss`` (value and parameter gradients)
  and ``decode`` at each mode against JAX's XLA path at ``highest``.
  ``bf16x3`` keeps ~2^-16 of each product, so the loss is held to JAX's
  bar for the mode (rtol = atol = 2e-4; gradients rtol 2e-2, atol 2e-3,
  ``tests/kernels/test_fdt_pallas.py``), paths equal or near-ties;
  ``default`` is one matmul with TF32 allowed, which is fp32 on the CPU as
  JAX's DEFAULT is there, so it meets the fp32 bar (rtol 1e-5).
- Segmental (config 4): ``default`` against JAX's ``default`` (the port's
  streaming loss, its gradients and decode against JAX's dense oracle,
  which compiles in a fraction of the time: fp32 tolerance), and ``bf16x3``
  raises
  ``ValueError`` in both packages (JAX's einsum takes no such precision).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.models import crf as jcrf
from asr_craft_tpu.models import segmental as jm
from asr_craft_tpu_torch.models import crf, weights
from asr_craft_tpu_torch.models import segmental as tm
from asr_craft_tpu_torch.ops import viterbi as tvit
from tests.test_torch_crf_loss_shared import _configs, _inputs

BAR = {"bf16x3": (dict(rtol=2e-4, atol=2e-4), dict(rtol=2e-2, atol=2e-3)),
       "default": (dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-4, atol=1e-5))}


@pytest.mark.parametrize("prec", ["bf16x3", "default"])
@pytest.mark.parametrize("name", ["config1", "config3", "config5"])
def test_shared_loss_and_decode_within_bar_of_highest(name, prec):
    jcfg, _ = _configs(name)
    _, tcfg = _configs(name, precision=prec)
    params, feats, labels, lengths = _inputs(tcfg, 11)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jargs = [jnp.asarray(a) for a in (feats, labels, lengths)]

    def jloss(p):
        return jcrf.crf_loss(jcfg, p, *jargs)[0]

    jv, jg = jax.value_and_grad(jloss)(jp)
    tp = {k: v.requires_grad_(True)
          for k, v in weights.params_from_numpy(params).items()}
    targs = [torch.from_numpy(a) for a in (feats, labels, lengths)]
    v, aux = crf.crf_loss(tcfg, tp, *targs)
    v.backward()
    val, grad = BAR[prec]
    np.testing.assert_allclose(float(v.detach()), float(jv), **val)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   **grad, err_msg=k)
    _, jpaths, jscores = jcrf.decode(jcfg, jp, jargs[0], jargs[2])
    with torch.no_grad():
        _, paths, scores = crf.decode(tcfg, tp, targs[0], targs[2])
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), **val)
    diff = (paths.numpy() != np.asarray(jpaths)).any(axis=1)
    if diff.any():                   # the near-tie rule, at the mode's bar
        state, trans = crf.potentials(tcfg, tp, targs[0])
        state = crf.apply_boundaries(tcfg, state, targs[2])
        rescored = tvit.path_score(state, trans, paths, targs[2])
        np.testing.assert_allclose(rescored.detach().numpy()[diff],
                                   np.asarray(jscores)[diff], **val)


def _seg(prec, seed=5, B=3, T=12, D=5, L=4, Dmax=4):
    rng = np.random.default_rng(seed)
    kw = dict(num_labels=L, feat_dim=D, max_dur=Dmax, precision=prec)
    jcfg, tcfg = jm.SegCrfConfig(**kw), tm.SegCrfConfig(**kw)
    params = {k: (0.4 * rng.normal(size=s)).astype(np.float32)
              for k, s in sorted(jcfg.param_shapes().items())}
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    labels = np.repeat(rng.integers(0, L, size=(B, T // 2)), 2,
                       axis=1).astype(np.int32)
    lengths = np.array([T, 8, 4], dtype=np.int32)
    return jcfg, tcfg, params, feats, labels, lengths


def test_segmental_default_matches_jax_and_bf16x3_raises_in_both():
    jcfg, tcfg, params, feats, labels, lengths = _seg("default")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jargs = [jnp.asarray(a) for a in (feats, labels, lengths)]
    jv, jg = jax.value_and_grad(
        lambda p: jm.scrf_loss(jcfg, p, *jargs)[0])(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    targs = [torch.from_numpy(a) for a in (feats, labels, lengths)]
    v, _ = tm.scrf_loss_fused(tcfg, tp, *targs)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5,
                               atol=1e-5)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    js = jm.scrf_decode_dense(jcfg, jp, jargs[0], jargs[2])
    with torch.no_grad():
        ts = tm.scrf_decode(tcfg, tp, targs[0], targs[2])
    for a, b in zip(ts[:3], js[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(ts[3].numpy(), np.asarray(js[3]), rtol=1e-5)

    jcfg, tcfg, *_ = _seg("bf16x3")
    with pytest.raises(ValueError):
        jm.scrf_loss_fused(jcfg, jp, *jargs)
    with pytest.raises(ValueError, match="bf16x3"):
        tm.scrf_loss_fused(tcfg, tp, *targs)
    with pytest.raises(ValueError, match="bf16x3"):
        tm.scrf_decode(tcfg, tp, targs[0], targs[2])
