"""Streaming SCRF log-partition with the classical segmental forward-backward
gradient, and the streaming segmental Viterbi.

Counterpart of :mod:`asr_craft_tpu.ops.segmental_stream`, same public names.
The ``(B, T, Dmax, L)`` segment-potential tensor of the dense path
(:mod:`asr_craft_tpu_torch.ops.segmental`) is never built: segment potentials
are rebuilt from cumulative frame scores,

    seg[t, d, l] = invd[d] * (CS[t+1, l] - CS[t-d, l]) + bias[d, l],

with ``CS[k] = sum_{u<k} frame[u]`` and ``invd[d] = 1 / (d + 1)`` for mean
pooling (1 otherwise).  The gradient is not autograd through the frame loop
but the classical identities, as ``torch.autograd.Function``s:

    beta[t, l]  = logsumexp_{d, l'} trans[l, l'] + seg[t+d+1, d, l']
                                    + beta[t+d+1, l']        (beta[len-1] = 0)
    xi[t, d, l] = exp(pred[t, d, l] + seg[t, d, l] + beta[t, l] - logZ)
      with pred = logsumexp_p alpha[t-d-1, p] + trans[p, l]  (0 if d == t)

    dlogZ/dbias[d, l]  = sum_t xi[t, d, l]
    dlogZ/dtrans[p, l] = exp(trans[p, l]) * gt[p, l]
    dlogZ/dframe[u]    = sum_{t >= u} A[t] - sum_{k > u} S[k]
      A[t] = sum_d invd[d] xi[t, d]        (segments ending at t)
      S[k] = sum_d invd[d] xi[k+d, d]      (segments starting at k)

Everything is batch-major (``frame (B, T, L)``, or ``(B, T, ns, L)`` for
n-state segments), where the JAX module is time-major.

One sub-state per segment (``ns == 1``): the three passes are the K9, K10 and
K11 kernels of :mod:`asr_craft_tpu_torch.kernels.segmental` for CUDA tensors
and their plain versions for CPU tensors; the decode without ``beam_width``
is K12 and K13.  The rolling-window scans of the JAX module's XLA path
(:func:`seg_forward_stream`, :func:`seg_backward_stream`, :func:`_grad_scan`)
stand beside them as a second formulation the tests hold them to.  n-state
segments and ``beam_width`` have no kernel in the JAX package either: they
are frame loops on whichever device the tensors are on.
"""
from __future__ import annotations

import numpy as np
import torch

from asr_craft_tpu_torch.kernels import segmental as K
from asr_craft_tpu_torch.kernels.fwdbwd import (backward_factors,
                                                forward_factors, row_max,
                                                safe_log)
from asr_craft_tpu_torch.ops.segmental import traceback_segments
from asr_craft_tpu_torch.ops.semiring import NEG_INF

__all__ = ["seg_log_partition_stream", "seg_forward_stream",
           "seg_backward_stream", "seg_log_partition_stream_ns",
           "seg_forward_stream_ns", "seg_backward_stream_ns",
           "seg_viterbi_stream", "nstate_cuts", "nstate_pool_matrices"]

_invd = K.pool_weights


def _push(buf, row):
    """The rolling window one frame on: ``row`` in front, the last out."""
    return torch.cat([row[:, None], buf[:, :-1]], dim=1)


def _window_1(bias, invd):
    """``(cum_now (B, L), cs_buf (B, Dmax, L)) -> (B, Dmax, L)``: the
    potentials of the Dmax segments between the window's sums and
    ``cum_now``.  The backward pass, whose window holds the later sums,
    passes ``-invd``."""
    def window(cum_now, cs_buf):
        return (cum_now[:, None] - cs_buf) * invd[:, None] + bias
    return window


def _window_ns(bias, E):
    """The n-state window: ``(cum_now (B, ns, L), cs_buf (B, Dmax, ns, L))
    -> (B, Dmax, L)`` through the static pooling matrix ``E (ns, Dmax, Dmax
    + 1)``."""
    def window(cum_now, cs_buf):
        W = torch.cat([cum_now[:, None], cs_buf], dim=1)
        return torch.einsum("sdj,bjsl->bdl", E, W) + bias
    return window


def _last_logZ(alphas, lengths):
    last = K.last_row(alphas, lengths)
    m = row_max(last)
    return (m + safe_log(torch.exp(last - m).sum(-1, keepdim=True)))[:, 0]


def _messages(alpha_buf, tmax, P, t: int):
    """``(msg (B, Dmax, L), m (B, Dmax, 1))``: the duration messages of the
    window's alphas: 0 for the segment from frame 0, NEG_INF for a duration
    that would start before it."""
    ds = torch.arange(alpha_buf.shape[1], device=alpha_buf.device)[:, None]
    m = row_max(alpha_buf)
    msg = m + tmax + safe_log(torch.exp(alpha_buf - m) @ P)
    msg = torch.where(ds == t, 0.0, msg)
    return torch.where(ds > t, NEG_INF, msg), m


def _forward_scan(cums, window, trans, lengths, Dmax: int):
    B, T, L = cums.shape[0], cums.shape[1], cums.shape[-1]
    lengths = lengths.to(cums.device)
    tmax, P = forward_factors(trans)
    # alpha_buf[:, i] = alpha[t - 1 - i]; cs_buf[:, i] = CS[t - i]
    alpha_buf = cums.new_full((B, Dmax, L), NEG_INF)
    cs_buf = cums.new_zeros((B, Dmax) + tuple(cums.shape[2:]))
    alphas = []
    for t in range(T):
        msg, _ = _messages(alpha_buf, tmax, P, t)
        cand = msg + window(cums[:, t], cs_buf)
        cm = torch.clamp(cand.amax(dim=1), min=NEG_INF)
        alpha_t = cm + safe_log(torch.exp(cand - cm[:, None]).sum(dim=1))
        alpha_t = torch.where((t < lengths)[:, None], alpha_t, NEG_INF)
        alphas.append(alpha_t)
        alpha_buf, cs_buf = _push(alpha_buf, alpha_t), _push(cs_buf,
                                                             cums[:, t])
    alphas = torch.stack(alphas, dim=1)
    return alphas, _last_logZ(alphas, lengths)


def _backward_scan(cums, window, trans, lengths, Dmax: int):
    B, T, L = cums.shape[0], cums.shape[1], cums.shape[-1]
    lengths = lengths.to(cums.device)
    tmax_r, Pt = backward_factors(trans)
    # beta_buf[:, i] = beta[t + 1 + i]; cs_buf[:, i] = CS[t + 2 + i]
    beta_buf = cums.new_full((B, Dmax, L), NEG_INF)
    cs_buf = cums.new_zeros((B, Dmax) + tuple(cums.shape[2:]))
    betas = [None] * T
    for t in range(T - 1, -1, -1):
        # segments (end t + d + 1, duration d + 1) starting at t + 1
        w = window(cums[:, t], cs_buf) + beta_buf
        mw = row_max(w)
        msg = mw + tmax_r + safe_log(torch.exp(w - mw) @ Pt)
        cm = torch.clamp(msg.amax(dim=1), min=NEG_INF)
        beta_t = cm + safe_log(torch.exp(msg - cm[:, None]).sum(dim=1))
        beta_t = torch.where((t == lengths - 1)[:, None], 0.0, beta_t)
        beta_t = torch.where((t >= lengths)[:, None], NEG_INF, beta_t)
        betas[t] = beta_t
        beta_buf, cs_buf = _push(beta_buf, beta_t), _push(cs_buf, cums[:, t])
    return torch.stack(betas, dim=1)


def _xi_scan(cums, window, trans, lengths, Dmax, alphas, betas, logZ, g,
             on_xi):
    """The ascending xi pass: calls ``on_xi(t, xi_g (B, Dmax, L))`` per
    frame and returns ``(gd (Dmax, L), gt (L, L))``.  ``g (B,)``: the
    cotangent of logZ, folded into every xi."""
    B, T, L = cums.shape[0], cums.shape[1], cums.shape[-1]
    lengths = lengths.to(cums.device)
    tmax, P = forward_factors(trans)
    ds = torch.arange(Dmax, device=cums.device)[:, None]
    gB = g[:, None, None]
    alpha_buf = cums.new_full((B, Dmax, L), NEG_INF)
    cs_buf = cums.new_zeros((B, Dmax) + tuple(cums.shape[2:]))
    gd = cums.new_zeros((Dmax, L))
    gt = cums.new_zeros((L, L))
    for t in range(T):
        pred, m = _messages(alpha_buf, tmax, P, t)
        x_v = window(cums[:, t], cs_buf) + (betas[:, t]
                                            - logZ[:, None])[:, None]
        valid = (t < lengths)[:, None, None]
        xi_g = torch.where(valid, torch.exp(pred + x_v) * gB, 0.0)
        on_xi(t, xi_g)
        gd = gd + xi_g.sum(dim=0)
        # trans contraction: xi over (p, l) factored as U^T V * exp(trans)
        mV = row_max(x_v)
        w_sc = torch.where(valid & (ds < t), torch.exp(m + mV) * gB, 0.0)
        U = torch.exp(alpha_buf - m) * w_sc
        gt = gt + torch.einsum("bdp,bdl->pl", U, torch.exp(x_v - mV))
        alpha_buf, cs_buf = (_push(alpha_buf, alphas[:, t]),
                             _push(cs_buf, cums[:, t]))
    return gd, gt


# ---------------------------------------------------------------------------
# one sub-state per segment: the rolling-window scans
# ---------------------------------------------------------------------------

def seg_forward_stream(cum, bias, trans, lengths, invd):
    """Alpha pass over the (t, d) lattice from cumulative frame scores.
    ``cum (B, T, L)`` with ``cum[:, t] = CS[t + 1]``; ``bias (Dmax, L)``;
    ``trans (L, L)``.  Returns ``(alphas (B, T, L), logZ (B,))``."""
    return _forward_scan(cum, _window_1(bias, invd), trans, lengths,
                         bias.shape[0])


def seg_backward_stream(cum, bias, trans, lengths, invd):
    """Beta pass (descending t).  Returns betas ``(B, T, L)`` with
    ``beta[length - 1] = 0`` and NEG_INF past the sequence end."""
    return _backward_scan(cum, _window_1(bias, -invd), trans, lengths,
                          bias.shape[0])


def _grad_scan(cum, bias, trans, lengths, invd, alphas, betas, logZ, g):
    """Ascending xi pass.  Returns the raw pieces ``(A (B, T, L), S_emit (B,
    T, L), acc_fin (B, Dmax, L), gd (Dmax, L), gt (L, L))`` of
    :func:`_assemble_frame_grad` and the exp(trans) finish."""
    Dmax = bias.shape[0]
    state = {"acc": torch.zeros_like(alphas[:, :1]).repeat(1, Dmax, 1)}
    A, S_emit = [], []

    def on_xi(t, xi_g):
        y = invd[:, None] * xi_g
        acc = state["acc"] + y
        S_emit.append(acc[:, Dmax - 1])
        state["acc"] = _push(acc, torch.zeros_like(acc[:, 0]))
        A.append(y.sum(dim=1))

    gd, gt = _xi_scan(cum, _window_1(bias, invd), trans, lengths, Dmax,
                      alphas, betas, logZ, g, on_xi)
    return (torch.stack(A, dim=1), torch.stack(S_emit, dim=1), state["acc"],
            gd, gt)


def _assemble_frame_grad(A, S_emit, acc_fin):
    """Frame-score gradient from the xi-pass pieces.  ``A[:, t]``: end
    contributions of frame t; ``S_emit[:, t]``: completed start
    contributions of frame ``t - (Dmax - 1)``; ``acc_fin[:, j]``: leftover
    start contributions of frame ``T - j``."""
    B, T, L = A.shape
    Dmax = acc_fin.shape[1]
    S = torch.zeros_like(A)
    if T >= Dmax:
        S[:, :T - Dmax + 1] = S_emit[:, Dmax - 1:]
    for j in range(1, min(Dmax, T + 1)):
        S[:, T - j] = acc_fin[:, j]
    return K.frame_grad(A, S)


# ---------------------------------------------------------------------------
# n-state segments: a duration-(d + 1) segment is split into ns proportional
# sub-state spans, each a cumulative-sum difference of its own frame-score
# stream.  With the window W[j] = CS[t + 1 - j] (j = 0..Dmax) every span
# endpoint is a static window offset per (d, s), so pooling is one einsum
# with a +/- pooling matrix E[s, d, j].
# ---------------------------------------------------------------------------

def nstate_cuts(max_dur: int, num_states: int):
    """(Dmax, ns+1) proportional span boundaries of a duration-(d + 1)
    segment (canonical left-to-right alignment; static)."""
    d = np.arange(max_dur) + 1
    s = np.arange(num_states + 1)
    return np.floor(s[None, :] * d[:, None] / num_states + 0.5).astype(
        np.int32)


def nstate_pool_matrices(max_dur: int, ns: int, mean_pool: bool):
    """Static pooling matrices ``(E_fwd, E_bwd)``: ``(ns, Dmax, Dmax + 1)``
    numpy arrays.  Forward window ``W[j] = CS[t + 1 - j]`` (segments ending
    at t): span s of segment ``[t - d, t]`` is ``W[d + 1 - cut[d, s + 1]] -
    W[d + 1 - cut[d, s]]``.  Backward window ``V[j] = CS[t + 1 + j]``
    (segments starting at t + 1): span s is ``V[cut[d, s + 1]] - V[cut[d,
    s]]``."""
    cuts = nstate_cuts(max_dur, ns)
    Ef = np.zeros((ns, max_dur, max_dur + 1), np.float32)
    Eb = np.zeros((ns, max_dur, max_dur + 1), np.float32)
    for s in range(ns):
        for d in range(max_dur):
            lo, hi = int(cuts[d, s]), int(cuts[d, s + 1])
            if hi <= lo:
                continue                      # empty span (short segment)
            w = 1.0 / (hi - lo) if mean_pool else 1.0
            Ef[s, d, d + 1 - hi] += w
            Ef[s, d, d + 1 - lo] -= w
            Eb[s, d, hi] += w
            Eb[s, d, lo] -= w
    return Ef, Eb


def seg_forward_stream_ns(cums, bias, trans, lengths, E):
    """Alpha pass with n-state sub-segment pooling.  ``cums (B, T, ns, L)``:
    inclusive cumsums per sub-state stream.  Returns (alphas, logZ)."""
    return _forward_scan(cums, _window_ns(bias, E), trans, lengths,
                         bias.shape[0])


def seg_backward_stream_ns(cums, bias, trans, lengths, Eb):
    """Beta pass with n-state pooling (the V-window orientation)."""
    return _backward_scan(cums, _window_ns(bias, Eb), trans, lengths,
                          bias.shape[0])


def _grad_scan_ns(cums, bias, trans, lengths, E, alphas, betas, logZ, g):
    """Ascending xi pass, n-state: each frame scatters its xi mass onto the
    rolling dCS window with the same pooling matrix.  Returns ``(dcs_emit
    (B, T, ns, L)`` whose row t holds ``dCS[t + 1 - Dmax]``, ``acc_fin (B,
    Dmax + 1, ns, L)`` for the tail positions, ``gd (Dmax, L)``, ``gt (L,
    L))``."""
    B, T, ns, L = cums.shape
    Dmax = bias.shape[0]
    state = {"acc": cums.new_zeros((B, Dmax + 1, ns, L))}
    emit = []

    def on_xi(t, xi_g):
        # dCS[t + 1 - j] += sum_{s, d} E[s, d, j] * xi[d]
        acc = state["acc"] + torch.einsum("sdj,bdl->bjsl", E, xi_g)
        emit.append(acc[:, Dmax])
        state["acc"] = _push(acc, torch.zeros_like(acc[:, 0]))

    gd, gt = _xi_scan(cums, _window_ns(bias, E), trans, lengths, Dmax,
                      alphas, betas, logZ, g, on_xi)
    return torch.stack(emit, dim=1), state["acc"], gd, gt


def _assemble_frame_grad_ns(dcs_emit, acc_fin):
    """dCS pieces -> frame-score gradient ``(B, T, ns, L)``.
    ``dcs_emit[:, t] = dCS[t + 1 - Dmax]``; ``acc_fin[:, j] = dCS[T + 1 -
    j]``; ``dframe[u] = sum_{k > u} dCS[k]``."""
    B, T, ns, L = dcs_emit.shape
    Dmax = acc_fin.shape[1] - 1
    dcs = dcs_emit.new_zeros((B, T + 1, ns, L))       # dCS[k], k = 0..T
    if T >= Dmax:
        dcs[:, :T - Dmax + 1] = dcs_emit[:, Dmax - 1:]
    for j in range(1, Dmax + 1):
        if 0 <= T + 1 - j <= T:
            dcs[:, T + 1 - j] = acc_fin[:, j]
    return dcs[:, 1:].flip(1).cumsum(dim=1).flip(1)


def _g_trans(trans, gt):
    """exp(trans) * gt in log space, immune to large learned transitions."""
    return torch.sign(gt) * torch.exp(trans + safe_log(gt.abs()))


class _LogPartitionStreamNs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, frame, bias, trans, lengths, max_dur, ns, mean_pool):
        cums = frame.cumsum(dim=1)
        Ef, _ = nstate_pool_matrices(max_dur, ns, mean_pool)
        alphas, logZ = seg_forward_stream_ns(
            cums, bias, trans, lengths, torch.from_numpy(Ef).to(frame.device))
        ctx.save_for_backward(cums, bias, trans, lengths, alphas, logZ)
        ctx.static = (max_dur, ns, mean_pool)
        return logZ

    @staticmethod
    def backward(ctx, g):
        cums, bias, trans, lengths, alphas, logZ = ctx.saved_tensors
        Ef, Eb = (torch.from_numpy(E).to(cums.device)
                  for E in nstate_pool_matrices(*ctx.static))
        betas = seg_backward_stream_ns(cums, bias, trans, lengths, Eb)
        dcs_emit, acc_fin, gd, gt = _grad_scan_ns(
            cums, bias, trans, lengths, Ef, alphas, betas, logZ, g)
        return (_assemble_frame_grad_ns(dcs_emit, acc_fin), gd,
                _g_trans(trans, gt), None, None, None, None)


def seg_log_partition_stream_ns(frame, bias, trans, lengths, max_dur: int,
                                ns: int, mean_pool: bool = True):
    """n-state SCRF logZ ``(B,)`` from per-sub-state frame scores ``frame
    (B, T, ns, L)``: O(B T ns L) memory, classical gradient."""
    return _LogPartitionStreamNs.apply(frame, bias, trans, lengths,
                                       int(max_dur), int(ns), bool(mean_pool))


# ---------------------------------------------------------------------------
# one sub-state per segment: K9 in the forward, K10 and K11 in the backward
# ---------------------------------------------------------------------------

class _LogPartitionStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, frame, bias, trans, lengths, mean_pool):
        alphas, logZ = K.segmental_forward(frame, trans, bias, lengths,
                                           mean_pool)
        ctx.save_for_backward(frame, bias, trans, lengths, alphas, logZ)
        ctx.mean_pool = mean_pool
        return logZ

    @staticmethod
    def backward(ctx, g):
        frame, bias, trans, lengths, alphas, logZ = ctx.saved_tensors
        betas = K.segmental_backward(frame, trans, bias, lengths,
                                     ctx.mean_pool)
        A, S, gd, gt = K.segmental_grad(frame, trans, bias, lengths, alphas,
                                        betas, logZ, g, ctx.mean_pool)
        return K.frame_grad(A, S), gd, _g_trans(trans, gt), None, None


def seg_log_partition_stream(frame, bias, trans, lengths, max_dur: int,
                             mean_pool: bool = True):
    """SCRF logZ ``(B,)`` from frame scores ``frame (B, T, L)``,
    differentiable at production shapes: never materializes ``(B, T, Dmax,
    L)``.  ``bias (Dmax, L)``: the combined duration and label bias;
    ``trans (L, L)``: segment-level transitions."""
    if bias.shape[0] != max_dur:
        raise ValueError(f"bias {tuple(bias.shape)} vs max_dur {max_dur}")
    return _LogPartitionStream.apply(frame, bias, trans, lengths,
                                     bool(mean_pool))


# ---------------------------------------------------------------------------
# streaming segmental Viterbi
# ---------------------------------------------------------------------------

def seg_viterbi_stream(frame, bias, trans, lengths, max_dur: int, ns: int = 1,
                       mean_pool: bool = True, beam_threshold=None,
                       beam_width=None):
    """Best segmentations from frame scores, O(B T ns L) memory.  ``frame (B,
    T, L)`` for ns == 1, else ``(B, T, ns, L)``.  Returns ``(starts, labels,
    n_segs, scores)`` in the fixed-size ``(B, T)`` layout of
    ``ops.segmental.segmental_viterbi_batch``.  Beam pruning masks each
    frame's delta row (a score margin and/or the top ``beam_width``); both
    None = exact."""
    if frame.dim() == 3 and ns == 1 and beam_width is None:
        deltas, arg_d, lab0, scores = K.segmental_viterbi(
            frame, trans, bias, lengths, mean_pool, beam_threshold)
        end_lab, end_start = K.segmental_viterbi_traceback(
            deltas, arg_d, trans, lab0, lengths)
        return (*_pack_segment_markers(end_lab, end_start), scores)
    if frame.dim() == 3:
        frame = frame[:, :, None, :]
    B, T, ns_, L = frame.shape
    if ns_ != ns:
        raise ValueError(f"frame {tuple(frame.shape)} vs ns {ns}")
    dev = frame.device
    lengths = lengths.to(dev)
    Dmax = bias.shape[0]
    Ef, _ = nstate_pool_matrices(max_dur, ns, mean_pool)
    window = _window_ns(bias, torch.from_numpy(Ef).to(dev))
    cums = frame.cumsum(dim=1)
    ds = torch.arange(Dmax, device=dev)[:, None]

    delta_buf = frame.new_full((B, Dmax, L), NEG_INF)
    cs_buf = frame.new_zeros((B, Dmax, ns, L))
    deltas, arg_ds, arg_ps = [], [], []
    for t in range(T):
        # msg[b, d, l] = max_p delta[t - d - 1, b, p] + trans[p, l]
        msg, argp = (delta_buf[:, :, :, None] + trans).max(dim=2)
        msg = torch.where(ds == t, 0.0, msg)
        argp = torch.where(ds == t, 0, argp)
        msg = torch.where(ds > t, NEG_INF, msg)
        cand = msg + window(cums[:, t], cs_buf)
        delta_t, argd = cand.max(dim=1)
        arg_ps.append(argp.gather(1, argd[:, None])[:, 0])
        if beam_threshold is not None:
            top = delta_t.amax(dim=-1, keepdim=True)
            delta_t = torch.where(delta_t >= top - beam_threshold, delta_t,
                                  NEG_INF)
        if beam_width is not None and beam_width < L:
            kth = delta_t.topk(beam_width, dim=-1).values[:, -1:]
            delta_t = torch.where(delta_t >= kth, delta_t, NEG_INF)
        delta_t = torch.where((t < lengths)[:, None], delta_t, NEG_INF)
        deltas.append(delta_t)
        arg_ds.append(argd)
        delta_buf, cs_buf = _push(delta_buf, delta_t), _push(cs_buf,
                                                             cums[:, t])
    deltas = torch.stack(deltas, dim=1)
    scores, lab0 = K.last_row(deltas, lengths).max(dim=-1)
    starts, labels, n = traceback_segments(
        torch.stack(arg_ds, dim=1), torch.stack(arg_ps, dim=1), lab0, lengths)
    return starts, labels, n, scores


def _pack_segment_markers(end_lab, end_start):
    """``(B, T)`` per-frame segment-end markers (label or -1, start frame)
    -> the fixed-size ascending ``(starts (B, T), labels (B, T), n (B,))``
    layout.  The marker at frame t lands in slot ``cs[t] - 1`` (cs = running
    end count): one cumulative sum and one scatter, no ``(B, T, T)``
    tensor."""
    B, T = end_lab.shape
    ends = end_lab >= 0
    cs = ends.cumsum(dim=1)
    # non-markers all land in one spare slot, cut off below
    slot = torch.where(ends, cs - 1, T)
    out = end_lab.new_zeros((2, B, T + 1))
    out[0].scatter_(1, slot, torch.where(ends, end_start, 0))
    out[1].scatter_(1, slot, torch.where(ends, end_lab, 0))
    return out[0, :, :T], out[1, :, :T], cs[:, -1].to(torch.int32)
