"""The ``bf16x3`` and ``default`` precisions of the fdt path (config 2's
K1-K3 products) against the JAX package on the CPU, on numpy-seeded
inputs:

- ``bf16x3``: the port's plain versions (the training criterion through
  autograd, and the K1/K2 kernels' plain twins through ``FdtNllDual``)
  against ``fdt_nll_dual_pallas(..., interpret=True)`` with a ``bf16x3``
  feature map: both form the same exact bf16 products, so ``(nll, logZ)``
  agree within rtol 1e-5, atol 1e-5 (fp32 sums in another order) and the
  gradients on the canonical params within 1e-5 of their largest entry
  (the port's autograd differentiates the split, hi carrying the gradient,
  where JAX's K2 splits dplane: 2^-16 of a term at most);
- both modes within JAX's own bar of the fp32 run (logZ rtol = atol =
  2e-4, nll 2e-3; ``tests/kernels/test_fdt_pallas.py``): ``bf16x3`` keeps
  ~2^-16 of each product and ``default`` (one TF32 pass: the kernels' twin
  rounds the operands to TF32) ~2^-11;
- K3's decode at ``bf16x3`` against ``fdt_viterbi_pallas(...,
  precision="bf16x3", interpret=True)``: scores within rtol 1e-5, paths
  equal or both optimal within it (the near-tie rule).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels.fdt_pallas import (build_wall as jbuild_wall,
                                              fdt_nll_dual_pallas,
                                              fdt_viterbi_pallas)
from asr_craft_tpu.ops import fdt as jfdt
from asr_craft_tpu_torch.kernels import fdt_train, fdt_viterbi
from asr_craft_tpu_torch.kernels.wall import build_wall, wall_planes
from asr_craft_tpu_torch.ops import fdt, precision
from tests.test_torch_fdt_train import _jax, _problem, _torch

B, T, P, NS = 2, 12, 4, 3
TIGHT = dict(rtol=1e-5, atol=1e-5)
LOGZ_BAR, NLL_BAR = dict(rtol=2e-4, atol=2e-4), dict(rtol=2e-3, atol=2e-3)


def _cfgs(prec):
    jc, tc, *arrays = _problem(3, B, T, P, NS)
    return (dataclasses.replace(jc, precision=prec),
            dataclasses.replace(tc, precision=prec), *arrays)


def _port(tc, path, params, feats, labels, lengths):
    """``(nll, logZ, grads)`` of the port's plain fdt path: ``autograd``
    (ops.fdt.fdt_nll_dual's CPU branch: factored planes, autograd) or
    ``twins`` (the K1/K2 kernels' plain versions through FdtNllDual)."""
    tp, tf, tl, tn = _torch(params, feats, labels, lengths, grad=True)
    if path == "autograd":
        nll, zf, _ = fdt.fdt_nll_dual(tc, NS, tp, tf, tl, tn, NS, True)
    else:
        Wall, u0, u1, dims = build_wall(tp, tc, NS)
        zf, zc = fdt_train.fdt_nll_dual_wall(
            Wall, tf, tl, tn, u0=u0, u1=u1, ns=NS, P=dims["P"], clamp_ns=NS,
            precision=tc.precision)
        nll = zf - zc
    nll.sum().backward()
    return (nll.detach().numpy(), zf.detach().numpy(),
            {k: v.grad.numpy() for k, v in tp.items()})


@pytest.fixture(scope="module")
def pallas_bf16x3():
    """JAX's interpret-mode K1/K2 at bf16x3: (nll, logZ, grads)."""
    jc, tc, params, feats, labels, lengths = _cfgs("bf16x3")
    jp, jf, jl, jn = _jax(params, feats, labels, lengths)

    def loss(p):
        nll, zf, _ = fdt_nll_dual_pallas(jc, NS, p, jf, jl, jn, NS, True,
                                         interpret=True)
        return jnp.sum(nll), (nll, zf)

    (_, (nll, zf)), g = jax.value_and_grad(loss, has_aux=True)(jp)
    return np.asarray(nll), np.asarray(zf), {k: np.asarray(v)
                                             for k, v in g.items()}


@pytest.mark.parametrize("path", ["autograd", "twins"])
def test_split_products_match_pallas_bf16x3(pallas_bf16x3, path):
    jc, tc, params, feats, labels, lengths = _cfgs("bf16x3")
    nll, zf, grads = _port(tc, path, params, feats, labels, lengths)
    jnll, jzf, jgrads = pallas_bf16x3
    np.testing.assert_allclose(nll, jnll, **TIGHT)
    np.testing.assert_allclose(zf, jzf, **TIGHT)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], rtol=0,
                                   atol=1e-5 * np.abs(jgrads[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("path", ["autograd", "twins"])
@pytest.mark.parametrize("prec", ["bf16x3", "default"])
def test_within_jax_bar_of_fp32(prec, path):
    """Against the JAX CPU run at ``highest`` (its XLA path, fp32), and
    ``default`` against the JAX CPU run at ``default`` (also fp32 there:
    the CPU has no TF32 pass) within the same bar."""
    jc, tc, params, feats, labels, lengths = _cfgs(prec)
    nll, zf, _ = _port(tc, path, params, feats, labels, lengths)
    jp, jf, jl, jn = _jax(params, feats, labels, lengths)
    for ref_prec in {"highest", "default"} & {"highest", prec}:
        jnll, jzf, _ = jfdt.fdt_nll_dual(
            dataclasses.replace(jc, precision=ref_prec), NS, jp, jf, jl, jn,
            NS, True)
        np.testing.assert_allclose(zf, np.asarray(jzf), **LOGZ_BAR)
        np.testing.assert_allclose(nll, np.asarray(jnll), **NLL_BAR)
    if prec == "default" and path == "autograd":
        # the products outside the kernels: one matmul with TF32 allowed,
        # which is fp32 on the CPU, as JAX's DEFAULT there
        np.testing.assert_allclose(zf, np.asarray(jzf), **TIGHT)


def test_kernel_twin_rounding():
    """The plain twin's operand rounding is the kernels': TF32 to nearest
    with ties away (cvt.rna), bf16 to nearest even, lo of an infinity
    NaN."""
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, float("inf"), -float("inf"), 0.0])
    np.testing.assert_array_equal(
        precision.round_tf32(x).numpy(),
        np.float32([1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0,
                    np.inf, -np.inf, 0.0]))
    assert torch.isnan(precision.round_tf32(torch.tensor([float("nan")])))
    x = np.float32([1 + 2 ** -9 + 2 ** -20, 1 + 2 ** -8 + 2 ** -20,
                    np.inf])
    hi, lo = precision.split_bf16(torch.from_numpy(x))
    assert hi.tolist() == [1.0, 1 + 2 ** -7, float("inf")]
    assert lo[:2].tolist() == [2 ** -9, -(2 ** -8)] and torch.isnan(lo[2])
    j_hi = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    j_lo = (jnp.asarray(x) - j_hi).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(j_hi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo))


def test_decode_bf16x3_matches_pallas():
    jc, tc, params, feats, _, lengths = _cfgs("bf16x3")
    jp, jf, jn = _jax(params, feats, lengths)
    JW, u0, u1, dims = jbuild_wall(jp, jc, NS)
    jpaths, jscores = fdt_viterbi_pallas(
        JW, jf, jn, u0=u0, u1=u1, ns=NS, P=dims["P"], P8=dims["P8"],
        boundaries=True, precision="bf16x3", interpret=True)
    tp, tf, tn = _torch(params, feats, lengths)
    Wall, u0, u1, _ = build_wall(tp, tc, NS)
    paths, scores = fdt_viterbi.fdt_viterbi_wall(
        Wall, tf, tn, u0=u0, u1=u1, ns=NS, P=P, precision="bf16x3")
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-5, atol=1e-5)
    diff = (paths.numpy() != np.asarray(jpaths)).any(axis=1)
    if diff.any():
        planes = wall_planes(Wall, tf, u0, u1, NS, P)
        rescored = fdt.path_score(*planes, paths, tn, NS)
        np.testing.assert_allclose(rescored.numpy()[diff],
                                   np.asarray(jscores)[diff], rtol=1e-5,
                                   atol=1e-4)
