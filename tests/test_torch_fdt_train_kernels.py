"""The plain versions of the port's K1/K2 kernels (kernels.fdt_train) and
their autograd Function against the TPU kernels themselves
(asr_craft_tpu.kernels.fdt_pallas, run in interpret mode as the JAX
package's own tests run them on the CPU), and K2's explicit recursion
against autograd of K1's plain version.  The autograd Function against the
TPU kernels' custom VJP is test_torch_fdt_train_vjp.py.

Tolerances: against the TPU kernel the JAX kernel tests' own, values
rtol=1e-4 (it forms planes as one dot and chunks its cross lse; the plain
versions sum in another order); the recursion against autograd rtol=1e-4,
atol=1e-5 (the same function in fp32, two orders of summation).
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels.fdt_pallas import (build_wall as jax_build_wall,
                                              fdt_forward_pallas)
from asr_craft_tpu_torch.kernels import fdt_train as K
from asr_craft_tpu_torch.kernels.wall import build_wall
from tests.test_torch_fdt_train import _jax, _problem, _torch

VAL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,T,P,ns", [(2, 9, 4, 1), (3, 11, 5, 2),
                                      (2, 13, 4, 3)])
def test_forward_plain_matches_pallas_interpret(B, T, P, ns):
    jc, tc, params, feats, labels, lengths = _problem(11, B, T, P, ns)
    jp, jf, jl, jn = _jax(params, feats, labels, lengths)
    jW, u0, u1, d = jax_build_wall(jp, jc, ns)
    _, jzf, jzc = fdt_forward_pallas(
        jW, jf, jl, jn, u0=u0, u1=u1, ns=ns, P=P, P8=d["P8"], clamp_ns=ns,
        boundaries=True, interpret=True)
    tp, tf, tl, tn = _torch(params, feats, labels, lengths)
    W, u0, u1, _ = build_wall(tp, tc, ns)
    alphas, zf, zc = K.fdt_forward_wall_torch(
        W, tf, tl, tn, u0=u0, u1=u1, ns=ns, P=P, clamp_ns=ns)
    assert alphas.shape == (B, T, 2, P * ns)
    np.testing.assert_allclose(zf.numpy(), np.asarray(jzf), **VAL)
    np.testing.assert_allclose(zc.numpy(), np.asarray(jzc), **VAL)


@pytest.mark.parametrize("ns,clamp_ns", [(1, 1), (3, 3), (3, 1)])
def test_backward_recursion_matches_autograd_of_forward(ns, clamp_ns):
    """K2's plain version is an explicit recursion; it must equal autograd
    of K1's plain version for any lattice weights (rows of length >= 1:
    the kernels treat frame 0 of an empty row as absent, autograd of the
    forward does not)."""
    P = 5
    _, tc, params, feats, labels, lengths = _problem(
        13, 3, 11, P, ns, clamp_ns=clamp_ns)
    tp, tf, tl, tn = _torch(params, feats, labels, lengths)
    tf.requires_grad_(True)
    W, u0, u1, _ = build_wall(tp, tc, ns)
    W = W.detach().requires_grad_(True)
    kw = dict(u0=u0, u1=u1, ns=ns, P=P, clamp_ns=clamp_ns,
              boundaries=clamp_ns != 1)
    alphas, zf, zc = K.fdt_forward_wall_torch(W, tf, tl, tn, **kw)
    wf = torch.tensor([0.5, 1.0, -2.0])
    wc = torch.tensor([-1.0, 0.25, 3.0])
    live = lambda z: torch.where(z > -5e29, z, 0.0)
    (wf * live(zf) + wc * live(zc)).sum().backward()
    with torch.no_grad():
        dW, dX = K.fdt_backward_grad_wall_torch(
            W, tf, tl, tn, alphas, zf, zc, wf, wc, **kw, want_dfeats=True)
    torch.testing.assert_close(dW, W.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dX, tf.grad, rtol=1e-4, atol=1e-5)
