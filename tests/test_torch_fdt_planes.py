"""The fdt recursions over given planes, as the port's K1 and K3 kernels run
them: the planes of every frame formed once, before the recursion, in rows
of R4 = R rounded up to 4 floats (``kernels.fdt_train.fdt_planes_cuda``'s
layout), and read by the recursion.

- The plain versions of the two recursions (``fdt_forward_planes_torch``,
  ``fdt_viterbi_planes_torch``) on plane rows whose pad holds NaN (so a
  read of it would show) against the TPU kernels themselves
  (``fdt_forward_pallas``, ``fdt_viterbi_pallas``, in interpret mode as the
  JAX package's own tests run them on the CPU) and the JAX package's XLA
  path, on the same Wall and feats.
- The plumbing around the kernels, with ``kernels.use_kernel`` and the
  CUDA wrappers replaced by CPU stand-ins built on the plain versions: a
  forward and backward of ``FdtNllDual`` forms the planes once and hands
  the same tensor to K2's recursion; a decode split into sub-batches of
  planes gives the paths and scores of one call.

Tolerances: log-partitions at the JAX kernel tests' rtol=1e-4, atol=1e-4
(the TPU kernel forms planes as one dot and chunks its cross lse); Viterbi
scores at rtol=1e-5, atol=1e-4 (fp32 planes summed in another order), paths
equal.  The stand-ins run the plain versions' own arithmetic, so the
plumbing tests hold the kernel path to the plain path bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels.fdt_pallas import (build_wall as jax_build_wall,
                                              fdt_forward_pallas)
from asr_craft_tpu.ops import fdt as jfdt
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import fdt_train as K
from asr_craft_tpu_torch.kernels import fdt_viterbi as V
from asr_craft_tpu_torch.kernels.wall import build_wall, plane_blocks
from asr_craft_tpu_torch.ops import fdt
from asr_craft_tpu_torch.utils import diagnostics
from tests.test_torch_fdt_train import _jax, _problem, _torch
from tests.test_torch_fdt_viterbi import MODES, TOL, _jax_pallas, _jax_xla
from tests.test_torch_fdt_viterbi import _problem as _vit_problem

VAL = dict(rtol=1e-4, atol=1e-4)


def _padded(planes):
    """Plane rows (B, T, R) in rows of R rounded up to 4, and 4 more
    columns, the pad NaN: a recursion that read it would give NaN."""
    B, T, R = planes.shape
    out = torch.full((B, T, (R + 3) // 4 * 4 + 4), float("nan"))
    out[..., :R] = planes
    return out


@pytest.mark.parametrize("P,ns,clamp_ns", [(5, 1, 1), (5, 3, 3), (8, 1, 1),
                                           (8, 3, 3), (5, 3, 1)])
def test_forward_planes_plain_matches_pallas_and_xla(P, ns, clamp_ns):
    B, T = 4, 21
    jc, tc, params, feats, labels, lengths = _problem(
        P + 10 * ns, B, T, P, ns, clamp_ns=clamp_ns)
    jp, jf, jl, jn = _jax(params, feats, labels, lengths)
    jW, u0, u1, d = jax_build_wall(jp, jc, ns)
    _, pzf, pzc = fdt_forward_pallas(
        jW, jf, jl, jn, u0=u0, u1=u1, ns=ns, P=P, P8=d["P8"],
        clamp_ns=clamp_ns, boundaries=True, interpret=True)
    xzf, xzc = jfdt.fdt_logZ_pair(
        *jfdt.factored_planes(jp, jf, P * ns, ns, jc.state_range,
                              jc.trans_range), jl, jn, ns, clamp_ns, True)
    tp, tf, tl, tn = _torch(params, feats, labels, lengths)
    W, u0, u1, _ = build_wall(tp, tc, ns)
    planes = _padded(K.fdt_planes_torch(W, tf, u0=u0, u1=u1))
    kw = dict(ns=ns, P=P, clamp_ns=clamp_ns, boundaries=True)
    alphas, zf, zc = K.fdt_forward_planes_torch(planes, tl, tn, **kw)
    assert alphas.shape == (B, T, 2, P * ns)
    assert torch.isfinite(alphas).all()
    for want_f, want_c in ((pzf, pzc), (xzf, xzc)):
        np.testing.assert_allclose(zf.numpy(), np.asarray(want_f), **VAL)
        np.testing.assert_allclose(zc.numpy(), np.asarray(want_c), **VAL)
    # the Wall-in plain version is the planes followed by this one
    wall = K.fdt_forward_wall_torch(W, tf, tl, tn, u0=u0, u1=u1, **kw)
    for got, want in zip((alphas, zf, zc), wall):
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["exact", "threshold+topk"])
@pytest.mark.parametrize("P,ns", [(5, 1), (5, 3), (8, 1), (8, 3)])
def test_viterbi_planes_plain_matches_pallas_and_xla(P, ns, mode):
    thr, bw = MODES[mode]
    jcfg, tcfg, params, feats, lengths = _vit_problem(P * 7 + ns, P, ns,
                                                      B=5, T=19)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tf, tl = torch.from_numpy(feats), torch.from_numpy(lengths)
    W, u0, u1, _ = build_wall(tp, tcfg, ns)
    planes = _padded(K.fdt_planes_torch(W, tf, u0=u0, u1=u1))
    paths, scores = V.fdt_viterbi_planes_torch(
        planes, tl, ns=ns, P=P, boundaries=True, beam_threshold=thr,
        beam_width=bw)
    assert int(tl[-1]) == 0             # a length-0 row: frame 0 still runs
    for ref in (_jax_pallas(jcfg, params, feats, lengths, ns, thr, bw),
                _jax_xla(jcfg, params, feats, lengths, ns, thr, bw)):
        np.testing.assert_array_equal(paths.numpy(), ref[0], err_msg=mode)
        np.testing.assert_allclose(scores.numpy(), ref[1], err_msg=mode,
                                   **TOL)
    wall = V.fdt_viterbi_wall_torch(W, tf, tl, u0=u0, u1=u1, ns=ns, P=P,
                                    beam_threshold=thr, beam_width=bw)
    assert torch.equal(paths, wall[0]) and torch.equal(scores, wall[1])


def _plane_stand_in(formed):
    """A CPU stand-in for ``fdt_planes_cuda``: the plain planes in the
    kernel's (B, T, R4) layout (pad 0), counted as the wrapper counts."""

    def planes_cpu(Wall, feats, *, u0, u1, key="kernels.fdt_train_plane",
                   precision="highest"):
        planes = K.fdt_planes_torch(Wall, feats, u0=u0, u1=u1,
                                    precision=precision)
        B, T, R = planes.shape
        out = torch.zeros((B, T, (R + 3) // 4 * 4))
        out[..., :R] = planes
        formed.append(out)
        diagnostics.count(f"{key}[{K.plane_path(feats, u0=u0, Du=u1 - u0)}]")
        return out
    return planes_cpu


@pytest.mark.parametrize("grad_feats", [False, True])
def test_nll_dual_forms_the_planes_once(monkeypatch, grad_feats):
    """The kernel path of FdtNllDual on CPU stand-ins: the forward forms
    the planes (one plane launch), K1's recursion reads them, the backward
    hands the same tensor to K2's recursion, which forms none; dWall (and
    dfeats) equal the plain path's."""
    P, ns = 5, 3
    _, tc, params, feats, labels, lengths = _problem(
        31, 3, 13, P, ns, clamp_ns=ns)
    tp, tf, tl, tn = _torch(params, feats, labels, lengths)
    W, u0, u1, _ = build_wall(tp, tc, ns)
    formed, seen = [], []

    def forward_planes_cpu(planes, labels, lengths, **kw):
        assert planes is formed[-1]
        return K.fdt_forward_planes_torch(planes, labels, lengths, **kw)

    def dplane_cpu(*args, planes=None, **kw):
        seen.append(planes)
        return K.fdt_dplane_wall_torch(*args, **kw)

    def contract_cpu(dplane, src, out, *, mode, D, u0, Du,
                     precision="highest"):
        src = src if mode == 0 else (src, out)
        return out.copy_(K.contract_wall_torch(dplane, src, mode=mode,
                                               u0=u0, u1=u0 + Du,
                                               precision=precision))

    grads, ran = {}, {}
    for path in ("kernel", "plain"):
        with monkeypatch.context() as m:
            if path == "kernel":
                m.setattr(kernels, "use_kernel", lambda t: True)
                m.setattr(K, "_check_train", lambda *a, **kw: None)
                m.setattr(K, "fdt_planes_cuda", _plane_stand_in(formed))
                m.setattr(K, "fdt_forward_planes_cuda", forward_planes_cpu)
                m.setattr(K, "fdt_dplane_cuda", dplane_cpu)
                m.setattr(K, "contract_cuda", contract_cpu)
            Wg = W.detach().clone().requires_grad_(True)
            xg = tf.clone().requires_grad_(True)
            with diagnostics.held_launches() as ran[path]:
                zf, zc = K.fdt_nll_dual_wall(Wg, xg, tl, tn, u0=u0, u1=u1,
                                             ns=ns, P=P, clamp_ns=ns,
                                             grad_feats=grad_feats)
                (2.0 * zf.sum() - zc.sum()).backward()
            grads[path] = (zf, zc, Wg.grad, xg.grad)
    assert len(formed) == 1 and ran["plain"] == {}
    ((name, n),) = ran["kernel"].items()
    assert name.startswith("kernels.fdt_train_plane[") and n == 1
    assert len(seen) == 1 and seen[0] is formed[0]
    for got, want in zip(grads["kernel"], grads["plain"]):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert (grads["kernel"][3] is not None) == grad_feats


@pytest.mark.parametrize("B,T,R,budget,plan", [
    (64, 512, 2736, 1 << 30, [(0, 64)]),              # the flagship decode
    (400, 512, 2736, 1 << 30, [(0, 191), (191, 382), (382, 400)]),
    (3, 10, 70, 1, [(0, 1), (1, 2), (2, 3)]),          # one at a time
    (5, 10, 70, 4 * 10 * 72 * 2, [(0, 2), (2, 4), (4, 5)]),
    (0, 10, 70, 1 << 30, [])])
def test_sub_batches_plan(B, T, R, budget, plan):
    """The decode's sub-batches: as many utterances as keep their (b, T,
    R4) fp32 planes within the budget, at least one, in order."""
    assert V.sub_batches(B, T, R, budget) == plan


def _planes(ran):
    """The decode's plane launches among the launch counts ``ran``, every
    design summed; and nothing else counted (the stand-ins count none)."""
    assert all(k.startswith("kernels.fdt_viterbi_plane[") for k in ran)
    return sum(ran.values())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("budget", [1, 4 * 19 * 72 * 2])
def test_decode_sub_batches_give_one_calls_results(monkeypatch, budget,
                                                   mode):
    """fdt_viterbi_cuda on CPU stand-ins of its kernels, with PLANE_BUDGET
    set to one or two utterances' planes: one plane launch and one recursion a
    sub-batch, each writing its rows of the decode's outputs; the paths and
    scores are those of one call and of the plain version."""
    thr, bw = MODES[mode]
    P, ns = 5, 3
    _, tcfg, params, feats, lengths = _vit_problem(3, P, ns, B=5, T=19)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tf, tl = torch.from_numpy(feats), torch.from_numpy(lengths)
    W, u0, u1, _ = build_wall(tp, tcfg, ns)
    formed, rows = [], []

    def forward_planes_cpu(planes, lengths, bp, last, scores, *, ns, P,
                           boundaries, beam_threshold, beam_width):
        assert planes is formed[-1]
        rows.append(len(lengths))
        out = fdt.fdt_viterbi_forward(*plane_blocks(planes, ns, P), lengths,
                                      ns, boundaries, beam_width,
                                      beam_threshold)
        for dst, src in zip((bp, last, scores), out):
            dst.copy_(src)

    def traceback_cpu(bp, last, lengths):
        return fdt.fdt_viterbi_traceback(bp, last, lengths)

    monkeypatch.setattr(V, "check_inputs",
                        lambda name, Wall, feats, *a, **kw: feats.shape)
    monkeypatch.setattr(V, "fdt_planes_cuda", _plane_stand_in(formed))
    monkeypatch.setattr(V, "viterbi_forward_planes_cuda",
                        forward_planes_cpu)
    monkeypatch.setattr(V, "viterbi_traceback_cuda", traceback_cpu)
    kw = dict(u0=u0, u1=u1, ns=ns, P=P, beam_threshold=thr, beam_width=bw)
    with monkeypatch.context() as m, diagnostics.held_launches() as ran:
        m.setattr(V, "PLANE_BUDGET", budget)
        split = V.fdt_viterbi_cuda(W, tf, tl, **kw)
    plan = V.sub_batches(5, 19, W.shape[0], budget)
    assert len(plan) > 1 and rows == [e - s for s, e in plan]
    assert _planes(ran) == len(plan)
    with diagnostics.held_launches() as ran:
        one = V.fdt_viterbi_cuda(W, tf, tl, **kw)
    assert rows[-1] == 5 and _planes(ran) == 1
    plain = V.fdt_viterbi_wall_torch(W, tf, tl, **kw)
    for got in (split, one):
        assert torch.equal(got[0], plain[0])
        assert torch.equal(got[1], plain[1])
