"""The port's K1/K2 autograd Function (kernels.fdt_train.FdtNllDual, on
the CPU its plain versions) against the TPU kernels' custom VJP
(asr_craft_tpu.kernels.fdt_pallas.fdt_nll_dual_pallas in interpret mode),
through both packages' build_wall gathers: the gradient of every canonical
parameter, and of the features with ``grad_feats``.  Split from
test_torch_fdt_train_kernels.py so each file stays short.

Tolerances are the JAX kernel tests' own: values rtol=1e-4, gradients
rtol=3e-3, atol=3e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_craft_tpu.kernels.fdt_pallas import fdt_nll_dual_pallas
from asr_craft_tpu_torch.kernels import fdt_train as K
from asr_craft_tpu_torch.kernels.wall import build_wall
from tests.test_torch_fdt_train import _jax, _problem, _torch

VAL = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=3e-3, atol=3e-5)


@pytest.mark.parametrize("ns,clamp_ns,grad_feats",
                         [(1, 1, False), (3, 3, False), (3, 1, False),
                          (3, 3, True)])
def test_function_grads_match_pallas_interpret(ns, clamp_ns, grad_feats):
    """FdtNllDual (plain kernels on the CPU) through build_wall's gathers:
    the gradient of every canonical param, and of feats with
    ``grad_feats``, against the TPU kernels' custom VJP."""
    P = 4
    jc, tc, params, feats, labels, lengths = _problem(
        12, 2, 9, P, ns, D=10, clamp_ns=clamp_ns, state_range=(0, 10),
        trans_range=(1, 10))
    bnd = clamp_ns != 1
    jp, jf, jl, jn = _jax(params, feats, labels, lengths)

    def jloss(p, f):
        nll, zf, zc = fdt_nll_dual_pallas(jc, ns, p, f, jl, jn, clamp_ns,
                                          bnd, interpret=True,
                                          grad_feats=grad_feats)
        return jnp.sum(nll * 2.0 + 0.25 * zf - 0.5 * zc)

    jv, (jg, jgf) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jf)
    tp, tf, tl, tn = _torch(params, feats, labels, lengths, grad=True)
    tf.requires_grad_(True)
    W, u0, u1, _ = build_wall(tp, tc, ns)
    zf, zc = K.fdt_nll_dual_wall(W, tf, tl, tn, u0=u0, u1=u1, ns=ns, P=P,
                                 clamp_ns=clamp_ns, boundaries=bnd,
                                 grad_feats=grad_feats)
    v = ((zf - zc) * 2.0 + 0.25 * zf - 0.5 * zc).sum()
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(jv), **VAL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   **GRAD, err_msg=k)
    if grad_feats:
        assert np.abs(np.asarray(jgf)).max() > 0
        np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), **GRAD)
    else:
        assert tf.grad is None
