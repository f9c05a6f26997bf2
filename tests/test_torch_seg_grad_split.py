"""K11's plain pieces (``kernels/segmental``: the message pass, the xi pass
gathered by duration, the ``E^T F`` contraction) against the scan form the
kernel replaced (kept here as the oracle) and against the JAX package's
``segmental_grad_pallas`` in interpret mode, on identical numpy-seeded
inputs.  The port is batch-major, the JAX kernel time-major.

Tolerances: against the scan form, the same terms summed in another order
(by duration here, by frame there): within 1e-5 of each output's largest
entry plus rtol 1e-5; against the Pallas kernel, as
``tests/test_torch_segmental_kernels.py``: within 1e-4 of the largest entry
plus rtol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.kernels import segmental_pallas as jk
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import segmental as K
from asr_craft_tpu_torch.kernels.fwdbwd import (forward_factors, row_max,
                                                row_width, safe_log)
from asr_craft_tpu_torch.utils import diagnostics


def _scan_form(frame, trans, bias, lengths, alphas, betas, logZ, g,
               mean_pool):
    """The xi pass as PR 5's K11 and its plain version computed it: one
    frame after the other, each window scattered into S, gd and F."""
    B, T, L = frame.shape
    Dmax = bias.shape[0]
    invd = K.pool_weights(Dmax, mean_pool)
    tmax, P = forward_factors(trans)
    m_all = row_max(alphas)
    e_all = torch.exp(alphas - m_all)
    q_all = m_all + tmax + safe_log(e_all @ P)
    cs_all = torch.zeros_like(frame)
    A, S, F = (torch.zeros_like(frame) for _ in range(3))
    gd = torch.zeros((B, Dmax, L))
    cum = torch.zeros((B, L))
    gB = g[:, None, None]
    for t in range(T):
        cum = cum + frame[:, t]
        q, seg = K._window(q_all, cs_all, cum, bias, invd, t)
        n, nd = q.shape[1], min(t, Dmax)
        xv = seg + (betas[:, t] - logZ[:, None])[:, None]
        valid = (t < lengths)[:, None, None]
        xi = torch.where(valid, torch.exp(q + xv) * gB, 0.0)
        y = invd[:n, None] * xi
        A[:, t] = y.sum(dim=1)
        S[:, t - n + 1:t + 1] += y.flip(1)
        gd[:, :n] += xi
        if nd:
            mu = m_all[:, t - nd:t].flip(1)
            F[:, t - nd:t] += torch.where(
                valid, torch.exp(xv[:, :nd] + mu) * gB, 0.0).flip(1)
        cs_all[:, t] = cum
    return A, S, gd.sum(dim=0), torch.einsum("btp,btl->pl", e_all, F), F


def _problem(seed, B, T, Dmax, L):
    rng = np.random.default_rng(seed)
    draw = lambda *s: (0.7 * rng.normal(size=s)).astype(np.float32)
    frame, bias, trans = draw(B, T, L), draw(Dmax, L), draw(L, L)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    lengths[-1] = 0                              # an empty row
    g = rng.uniform(-1.5, 1.5, size=B).astype(np.float32)
    return frame, bias, trans, lengths, g


def _rel(got, want, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _inputs(frame, bias, trans, lengths, g, mean_pool):
    f, b, tr, n, gg = (torch.from_numpy(x) for x in
                       (frame, bias, trans, lengths, g))
    alphas, logZ = K.segmental_forward_plain(f, tr, b, n, mean_pool)
    betas = K.segmental_backward_plain(f, tr, b, n, mean_pool)
    return f, tr, b, n, alphas, betas, logZ, gg


# (B, T, Dmax, L, pooling, against the Pallas kernel too): ragged with an
# empty row and L = 5 (rows of 8), T < Dmax, Dmax = 1, L = 6 under sum
# pooling, a deeper window.  Each interpret-mode call takes ~10 s here: the
# first three hold the families to the JAX kernel, the other two to the
# scan form it matches.
CASES = [(4, 11, 4, 5, "mean", True), (3, 3, 8, 6, "sum", True),
         (3, 9, 1, 7, "mean", True), (4, 10, 3, 6, "sum", False),
         (3, 14, 6, 4, "mean", False)]


@pytest.mark.parametrize("B,T,Dmax,L,pooling,pallas", CASES)
def test_parts_match_the_scan_form_and_pallas(B, T, Dmax, L, pooling,
                                              pallas):
    mean_pool = pooling == "mean"
    frame, bias, trans, lengths, g = _problem(B * T + Dmax, B, T, Dmax, L)
    args = _inputs(frame, bias, trans, lengths, g, mean_pool)
    f, tr, b, n, alphas, betas, logZ, gg = args
    E, q, cs, m = K.segmental_grad_message_plain(f, tr, b, n, alphas)
    A, S, F, gd = K.segmental_grad_xi_plain(q, cs, m, betas, logZ, gg, b, n,
                                            mean_pool)
    gt = K.segmental_grad_contract_plain(E, F, L)
    want = _scan_form(f, tr, b, n, alphas, betas, logZ, gg, mean_pool)
    for name, got, ref in (("A", A, want[0]), ("S", S, want[1]),
                           ("gd", gd, want[2]), ("gt", gt, want[3]),
                           ("F", F[..., :L], want[4])):
        _rel(got, ref, 1e-5, f"{name} vs the scan form")
    assert torch.equal(torch.stack(K.segmental_grad_plain(
        f, tr, b, n, alphas, betas, logZ, gg, mean_pool)[:2]),
        torch.stack((A, S)))
    if not pallas:
        return
    ja, jb = (jnp.asarray(np.moveaxis(x.numpy(), 1, 0))
              for x in (alphas, betas))
    jA, jS, jacc, jgd, jgt = jk.segmental_grad_pallas(
        jnp.asarray(np.moveaxis(frame, 1, 0)), jnp.asarray(trans),
        jnp.asarray(bias), jnp.asarray(lengths), ja, jb,
        jnp.asarray(logZ.numpy()), jnp.asarray(g), max_dur=Dmax,
        mean_pool=mean_pool, interpret=True)
    S_emit, acc_fin = K.emit_layout(S, Dmax)
    bm = lambda x: np.moveaxis(np.asarray(x), 0, 1)
    for name, got, ref in (("A", A, bm(jA)), ("S_emit", S_emit, bm(jS)),
                           ("acc_fin", acc_fin, bm(jacc)), ("gd", gd, jgd),
                           ("gt", gt, jgt)):
        _rel(got, ref, 1e-4, f"{name} vs pallas")


def test_message_pass_layout():
    """E in rows of L4 floats, zero in the pads and at and past a length;
    q the messages, cs the running sums, m the clamped row maxima."""
    B, T, Dmax, L = 3, 7, 3, 6
    frame, bias, trans, lengths, g = _problem(7, B, T, Dmax, L)
    f, tr, b, n, alphas, *_ = _inputs(frame, bias, trans, lengths, g, True)
    E, q, cs, m = K.segmental_grad_message_plain(f, tr, b, n, alphas)
    assert E.shape == (B, T, row_width(L)) == (B, T, 8)
    assert float(E[..., L:].abs().max()) == 0.0
    tmax, P = forward_factors(tr)
    for row, k in enumerate(lengths):
        assert float(E[row, k:].abs().max() if k < T else 0.0) == 0.0
        if k == 0:
            continue
        mr = row_max(alphas[row, :k])
        assert torch.equal(m[row, :k], mr[:, 0])
        e = torch.exp(alphas[row, :k] - mr)
        assert torch.equal(E[row, :k, :L], e)
        assert torch.allclose(q[row, :k], mr + tmax + safe_log(e @ P),
                              rtol=1e-6, atol=1e-6)
        run = torch.zeros(L)
        for t in range(k):                       # frame order, as the kernel
            run = run + f[row, t]
            assert torch.equal(cs[row, t], run)


@pytest.mark.parametrize("mean_pool", [True, False])
def test_xi_pass_rows_past_a_length_hold_zero(mean_pool):
    """A and S at and past a length, F at and past ``length - 1`` (no
    segment starts after it) and every output of the empty row are 0; the
    segments from frame 0 feed A, S and gd but no F row."""
    B, T, Dmax, L = 4, 9, 4, 5
    frame, bias, trans, lengths, g = _problem(11, B, T, Dmax, L)
    f, tr, b, n, alphas, betas, logZ, gg = _inputs(frame, bias, trans,
                                                   lengths, g, mean_pool)
    E, q, cs, m = K.segmental_grad_message_plain(f, tr, b, n, alphas)
    A, S, F, gd = K.segmental_grad_xi_plain(q, cs, m, betas, logZ, gg, b, n,
                                            mean_pool)
    for row, k in enumerate(lengths):
        assert float(A[row, k:].abs().max() if k < T else 0.0) == 0.0
        assert float(S[row, k:].abs().max() if k < T else 0.0) == 0.0
        lo = max(k - 1, 0)
        assert float(F[row, lo:].abs().max()) == 0.0
        if k:
            assert float(A[row, :k].abs().min()) > 0.0
    assert float(F[..., L:].abs().max()) == 0.0
    # one frame: one segment a label, A = S = g times the label posteriors
    # (summing to g), gd[0] their sum, gd[1:] and gt 0 (no source frame)
    one = np.array([1, 0, 0, 0], np.int32)
    f1, tr1, b1, n1, a1, be1, z1, g1 = _inputs(frame, bias, trans, one, g,
                                               mean_pool)
    out = K.segmental_grad_plain(f1, tr1, b1, n1, a1, be1, z1, g1, mean_pool)
    assert torch.allclose(out[0][0, 0].sum(), g1[0], rtol=1e-5)
    assert torch.equal(out[0], out[1])
    assert torch.equal(out[2][0], out[0][0, 0])
    assert float(out[2][1:].abs().max()) == float(out[3].abs().max()) == 0.0


def test_dispatch_and_wrappers_on_cpu_tensors():
    """The dispatch takes the plain pieces for a CPU tensor and counts no
    launch; the three CUDA wrappers raise on CPU tensors."""
    frame, bias, trans, lengths, g = _problem(3, 3, 6, 3, 4)
    f, tr, b, n, alphas, betas, logZ, gg = _inputs(frame, bias, trans,
                                                   lengths, g, True)
    before = diagnostics.launches()
    got = K.segmental_grad(f, tr, b, n, alphas, betas, logZ, gg)
    want = K.segmental_grad_plain(f, tr, b, n, alphas, betas, logZ, gg)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    E, q, cs, m = K.segmental_grad_message_plain(f, tr, b, n, alphas)
    for call in (lambda: K.segmental_grad_message_cuda(f, tr, b, n, alphas),
                 lambda: K.segmental_grad_xi_cuda(q, cs, m, betas, logZ, gg,
                                                  b, n),
                 lambda: K.segmental_grad_contract_cuda(E, E, 4)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    kernels.set_backend("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensor"):
            K.segmental_grad(f, tr, b, n, alphas, betas, logZ, gg)
    finally:
        kernels.set_backend("auto")
    assert diagnostics.launches() == before
