"""Forward-backward over a shared ``(L, L)`` transition matrix, with the
classical gradient.

Counterpart of :mod:`asr_craft_tpu.ops.mxu`, same public names.  The
recursions are the rescaled-exp products of that module,

    m       = max_p alpha[p]                     (per row)
    tmax[l] = max_p trans[p, l]                  (per column)
    alpha'  = m + tmax + log(exp(alpha - m) @ exp(trans - tmax)) + state

whose factors lie in [0, 1]; they run in
:mod:`asr_craft_tpu_torch.kernels.fwdbwd` (the K4, K5, K6a, K6b kernels for
CUDA tensors, their plain versions for CPU tensors).  The gradient is not
autograd through the frame loop: two ``torch.autograd.Function``s implement
the forward-backward identities,

    d logZ / d state[b, t, l] = gamma[b, t, l] = exp(alpha + beta - logZ)
    d logZ / d trans[p, l]    = sum_{b, t} xi[b, t, p, l]
                              = exp(trans) . (U^T V)
      with U[b, t-1, p] = exp(alpha[b, t-1, p] - logZ_b),
           V[b, t, l]   = exp(state[b, t, l] + beta[b, t, l])

formed as ``g_trans = sign(UV) * exp(trans + log|UV|)`` so that a large
learned transition weight cannot overflow ``exp``.  Everything is
batch-major ``(B, T, L)``.
"""
from __future__ import annotations

import torch

from asr_craft_tpu_torch.kernels import fwdbwd as K

__all__ = ["forward_mxu", "log_partition_mxu", "posteriors_mxu", "nll_dual"]


def _valid(lengths, T: int, device):
    """(B, T, 1) mask of the frames below each length."""
    return (torch.arange(T, device=device)[None, :]
            < lengths.to(device)[:, None])[..., None]


def _g_trans(trans, UV):
    return torch.sign(UV) * torch.exp(trans + K.safe_log(UV.abs()))


def forward_mxu(state, trans, lengths):
    """Batched alpha pass.  ``state (B, T, L)``, ``trans (L, L)``.  Returns
    ``(alphas (B, T, L), logZ (B,))``."""
    return K.forward(state, trans, lengths)


def posteriors_mxu(state, trans, lengths):
    """(B, T, L) gamma = exp(alpha + beta - logZ), zero past each length."""
    alphas, logZ = K.forward(state, trans, lengths)
    betas = K.backward(state, trans, lengths)
    gamma = torch.exp(alphas + betas - logZ[:, None, None])
    return torch.where(_valid(lengths, state.shape[1], state.device), gamma,
                       0.0)


def _xi_uv(alphas, betas, state, logZ, valid, w):
    """The cotangent-weighted factors of the xi contraction, ``(U, V)``
    ``(B, T-1, L)`` each: U pairs frame t's alpha with V, frame t+1's
    ``exp(beta + state - mV)``; the scale ``exp(mU + mV - logZ) * w`` is
    folded into U and gated by ``t + 1 < length``."""
    mU = K.row_max(alphas[:, :-1])
    x = betas[:, 1:] + state[:, 1:]
    mV = K.row_max(x)
    scale = torch.where(valid[:, 1:],
                        torch.exp(mU + mV - logZ[:, None, None]), 0.0)
    U = torch.exp(alphas[:, :-1] - mU) * (scale * w[:, None, None])
    return U, torch.exp(x - mV)


class _LogPartition(torch.autograd.Function):
    """``logZ (B,)`` with the classical forward-backward gradient: K6a in
    the forward, K6b in the backward, then gamma and one ``U^T V``
    contraction over all frames (the JAX ``_lp_fwd`` / ``_lp_bwd``)."""

    @staticmethod
    def forward(ctx, state, trans, lengths):
        alphas, logZ = K.forward(state, trans, lengths)
        ctx.save_for_backward(state, trans, lengths, alphas, logZ)
        return logZ

    @staticmethod
    def backward(ctx, g):
        state, trans, lengths, alphas, logZ = ctx.saved_tensors
        betas = K.backward(state, trans, lengths)
        valid = _valid(lengths, state.shape[1], state.device)
        gamma = torch.where(
            valid, torch.exp(alphas + betas - logZ[:, None, None]), 0.0)
        U, V = _xi_uv(alphas, betas, state, logZ, valid, g)
        UV = torch.einsum("btp,btl->pl", U, V)
        return gamma * g[:, None, None], _g_trans(trans, UV), None


def log_partition_mxu(state, trans, lengths):
    """(B,) logZ with the classical forward-backward gradient."""
    return _LogPartition.apply(state, trans, lengths)


class _NllDual(torch.autograd.Function):
    """``(nll, logZ, numerator)`` per sequence over the free and the
    label-clamped lattice: K4 in the forward, the fused K5 in the backward
    (the JAX ``_make_nll_dual``).  All three outputs carry gradient: the
    free lattice is weighted ``wf = g_nll + g_zf``, the clamped one ``wc =
    g_zc - g_nll``."""

    @staticmethod
    def forward(ctx, state, trans, labels, lengths, clamp_ns):
        af, ac, zf, zc = K.forward_dual(state, trans, labels, lengths,
                                        clamp_ns)
        ctx.save_for_backward(state, trans, labels, lengths, af, ac, zf, zc)
        ctx.clamp_ns = clamp_ns
        return zf - zc, zf, zc

    @staticmethod
    def backward(ctx, g_nll, g_zf, g_zc):
        state, trans, labels, lengths, af, ac, zf, zc = ctx.saved_tensors
        g_state, UV = K.backward_dual_grad(
            state, trans, labels, lengths, af, ac, zf, zc, g_nll + g_zf,
            g_zc - g_nll, ctx.clamp_ns)
        return g_state, _g_trans(trans, UV), None, None, None


def nll_dual(state, trans, labels, lengths, num_states: int = 1):
    """Per-sequence ``(nll, logZ, numerator)``, the fused training
    objective.  ``num_states``: the clamp granularity — frame label ``y``
    admits expanded states ``[y * ns, (y + 1) * ns)``; 1 = state
    equality."""
    return _NllDual.apply(state, trans, labels, lengths, int(num_states))
