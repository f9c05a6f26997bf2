"""The plain versions of the port's K1/K2 kernels (kernels.fdt_train) and
their autograd Function against the TPU kernels themselves
(asr_craft_tpu.kernels.fdt_pallas, run in interpret mode as the JAX
package's own tests run them on the CPU), and K2's explicit recursion
against autograd of K1's plain version; K2's plain planes against the JAX
package's factored planes, and the layouts the wrappers hand the kernels
(the padded copy of Wall, the split of the frames).  The autograd Function
against the TPU kernels' custom VJP is test_torch_fdt_train_vjp.py.

Tolerances: against the TPU kernel the JAX kernel tests' own, values
rtol=1e-4 (it forms planes as one dot and chunks its cross lse; the plain
versions sum in another order); the recursion against autograd rtol=1e-4,
atol=1e-5 (the same function in fp32, two orders of summation); the
planes rtol=1e-5, atol=1e-5 (one fp32 dot each, in another order).
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels.fdt_pallas import (build_wall as jax_build_wall,
                                              fdt_forward_pallas)
from asr_craft_tpu.ops import fdt as jfdt
from asr_craft_tpu_torch.kernels import fdt_train as K
from asr_craft_tpu_torch.kernels.wall import build_wall, wall_k4
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


@pytest.mark.parametrize("B,T,P,ns,trans_range", [
    (2, 9, 4, 1, (2, 12)), (3, 11, 5, 2, (3, 10)), (2, 13, 4, 3, (2, 12))])
def test_planes_plain_match_jax_factored_planes(B, T, P, ns, trans_range):
    """fdt_planes_torch (the plane kernel's plain version) gives the JAX
    package's factored planes row block by row block: state, self,
    advance (where an advance exists; JAX sets the others to NEG_INF) and
    cross, at u0 != 0 when the state range starts later."""
    jc, tc, params, feats, _, _ = _problem(
        17, B, T, P, ns, state_range=(1, 12), trans_range=trans_range)
    jp, jf = _jax(params, feats)
    state, selfp, advp, crossp = jfdt.factored_planes(
        jp, jf, P * ns, ns, jc.state_range, jc.trans_range)
    tp, tf = _torch(params, feats)
    W, u0, u1, _ = build_wall(tp, tc, ns)
    assert u0 == 1
    planes = K.fdt_planes_torch(W, tf, u0=u0, u1=u1).numpy()
    Lp = P * ns
    assert planes.shape == (B, T, 3 * Lp + P * P)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(planes[..., :Lp], np.asarray(state), **tol)
    np.testing.assert_allclose(planes[..., 3 * Lp:],
                               np.asarray(crossp).reshape(B, T, P * P),
                               **tol)
    if ns > 1:
        np.testing.assert_allclose(planes[..., Lp:2 * Lp],
                                   np.asarray(selfp), **tol)
        adv = np.arange(Lp) % ns < ns - 1
        np.testing.assert_allclose(planes[..., 2 * Lp:3 * Lp][..., adv],
                                   np.asarray(advp)[..., adv], **tol)


@pytest.mark.parametrize("Du", [1, 4, 7, 144, 145])
def test_wall_k4_pads_rows_to_16_bytes(Du):
    """The tensor-core kernels' copy of Wall: its weights in rows of a
    multiple of 4 floats, the pad zero, the bias column left out."""
    g = torch.Generator().manual_seed(Du)
    Wall = torch.randn((37, Du + 1), generator=g)
    wk = wall_k4(Wall)
    assert wk.shape == (37, -(-Du // 4) * 4) and wk.is_contiguous()
    assert torch.equal(wk[:, :Du], Wall[:, :Du])
    assert not wk[:, Du:].any()


@pytest.mark.parametrize("N,R,splits", [
    (65536, 2736, 12),            # the flagship: 22 row tiles x 12 = 264
    (65536, 17536, 2),            # P = 128: 137 row tiles, two chunks
    (4095, 300, 1), (3 * 4096 + 17, 300, 3), (20 * 4096, 300, 16),
    (0, 70, 1), (10 ** 7, 40, 16)])
def test_contract_splits_plan(N, R, splits):
    """dWall's frames split into about as many blocks as the card holds
    (the H100's: 132 SMs, two blocks of 128 rows of dWall an SM), chunks of
    at least CONTRACT_CHUNK frames, at most CONTRACT_SPLITS of them."""
    blocks = 2 * 132
    assert K.contract_splits(N, R, tile_rows=128, blocks=blocks) == splits
    tiles = -(-R // 128)
    assert splits == 1 or tiles * (splits - 1) < blocks
