"""K9-K13: the segmental CRF recursions over frame scores — CUDA kernels,
their plain twins and the dispatch between them.

Counterpart of :mod:`asr_craft_tpu.kernels.segmental_pallas`
(``segmental_forward_pallas``, ``segmental_backward_pallas``,
``segmental_grad_pallas``, ``segmental_viterbi_pallas``,
``segmental_viterbi_traceback_pallas``).  The kernels are in
``csrc/segmental.cu`` (the note there gives the recursions and says what
bounds them on the card).  This module checks, launches and holds the plain
PyTorch version of each: explicit frame loops that form the duration message
once per source frame and keep the running cumulative score, as the kernels
do; K11's in its three parts, each frame-parallel but for the running sum.

=====================================  ==========================  ==========
dispatch                               kernel wrapper              plain
=====================================  ==========================  ==========
:func:`segmental_forward` (K9)         ``segmental_forward_cuda``  ``..._plain``
:func:`segmental_backward` (K10)       ``segmental_backward_cuda`` ``..._plain``
:func:`segmental_grad` (K11: the       ``segmental_grad_cuda``     ``..._plain``
three below)
- the message pass                     ``segmental_grad_message_   ``..._plain``
                                       cuda``
- the xi pass                          ``segmental_grad_xi_cuda``  ``..._plain``
- ``gt = E^T F`` (tensor cores)        ``segmental_grad_contract_  ``..._plain``
                                       cuda``
:func:`segmental_viterbi` (K12)        ``segmental_viterbi_cuda``  ``..._plain``
:func:`segmental_viterbi_traceback`    ``segmental_viterbi_        ``..._plain``
(K13)                                  traceback_cuda``
=====================================  ==========================  ==========

Everything is batch-major: ``frame (B, T, L)`` float32 per-frame label
scores, ``trans (L, L)``, ``bias (Dmax, L)`` the combined duration and label
bias of a segment, ``lengths (B,)`` int32.  Rows at and past a length hold
NEG_INF (alphas, betas, deltas) or 0 (A, S, arg_d).

Rebased rows (``scaled=True`` in K9 and K10; ``aoff``, ``boff`` in K11):
the alphas and betas grow by ~log L a frame, so in fp32 their rounding
grows with the utterance (logZ ~2e3 at T = 512 at config 4: ~1e-4 a step,
~1e-3 on the gradient's posteriors).  Rebased, the frames go in cycles of
Dmax and each cycle's rows are kept less a whole number, ``off (B, T)``
(the alphas are ``alphas + off[..., None]``), raised at each cycle's start
by the last row's maximum, rounded; K9 also returns ``zhat (B,)``, the last
row's log-sum, with ``logZ = zhat + off[length - 1]``.  Offsets are whole
numbers, so their differences are exact and every rounding happens within
~Dmax log L of 0.  K11 takes the offsets and zhat in place of logZ.  The
training path (``ops.segmental_stream``) rebases; unrebased calls return
the rows themselves, as before.

Where the port's outputs differ from the JAX functions':

- logZ (K9) and the final score and label (K12) are taken inside the kernel
  from the row of frame ``length - 1``; an empty row reports ``NEG_INF`` and
  label 0.
- K11 returns ``(A, S, gd, gt)`` with ``S[b, k]`` the start contributions
  of frame ``k`` itself: the xi pass gathers each start frame's segments
  and writes it to its place.  The JAX function returns them
  delayed (``S_emit[t] = S[t - Dmax + 1]``) with the last ``Dmax - 1`` in
  ``acc_fin``; :func:`emit_layout` rebuilds that pair for the tests, and
  :func:`frame_grad` is the assembly the training path uses.

A kernel takes the ``(L, Dmax)`` at which the transition factor and the
Dmax-slot windows fit a block's shared memory (at ``Dmax = 16``: ``L <=
205``, K11 included; :func:`smem_bytes` says which); the wrappers raise
beyond.  K9, K10 and K12 run on one frame (:func:`recursion_frame`: their
own, which forms the transition factor and ``invd`` inside the kernel, so
each wrapper launches its kernel alone; the three-barrier frame, which
takes them from the wrapper, at the few widths only its smaller footprint
fits).  K11's message and xi passes hold ~50 MB of temporaries at config 4
(``E``, ``F`` (B, T, L4), ``q``, ``cs`` (B, T, L), ``m`` (B, T)).

The dispatchers follow :func:`asr_craft_tpu_torch.kernels.use_kernel`: a
CUDA tensor under ``auto`` launches the kernel or raises, a CPU tensor takes
the plain version.  Each wrapper counts its launches in the counter
``kernels.<kernel>`` of :mod:`asr_craft_tpu_torch.utils.diagnostics` (K11:
one for each of its three parts), K9's, K10's and K12's with their frame
(``[own]`` or ``[three_barrier]``, :func:`recursion_path`), K11's xi pass
with its kernel (``[16]`` or ``[deep]``, :func:`xi_kernel`).

What bounds the kernels on the card, what was measured and what was tried
and dropped is in the note of ``csrc/segmental.cu`` and in PERF.md.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.kernels import fwdbwd
from asr_craft_tpu_torch.kernels.fdt_viterbi import stream_frames
from asr_craft_tpu_torch.kernels.fwdbwd import (backward_dual_contract_plain,
                                                backward_factors,
                                                forward_factors, row_max,
                                                row_width, safe_log)
from asr_craft_tpu_torch.ops.semiring import NEG_INF
from asr_craft_tpu_torch.utils import diagnostics

KINDS = {"segmental_forward": 0, "segmental_viterbi": 1,
         "segmental_backward": 2, "segmental_grad": 3}

_lib = None


def pool_weights(max_dur: int, mean_pool: bool, device="cpu"):
    """``invd (Dmax,)``: 1 / (d + 1) for mean pooling, else 1."""
    d = torch.arange(max_dur, dtype=torch.float32, device=device)
    return 1.0 / (d + 1.0) if mean_pool else torch.ones_like(d)


def segment_bias(dur_bias, seg_bias, max_dur: int, L: int, like):
    """The combined ``(Dmax, L)`` bias of ``dur_bias (Dmax, L)`` or None and
    ``seg_bias (L,)`` or None."""
    bias = torch.zeros((max_dur, L), dtype=like.dtype, device=like.device)
    if dur_bias is not None:
        bias = bias + dur_bias
    if seg_bias is not None:
        bias = bias + seg_bias[None, :]
    return bias


def last_row(x, lengths):
    """``x[b, lengths[b] - 1]`` of ``x (B, T, L)``; an empty row reads frame
    0, which holds NEG_INF there."""
    idx = (lengths.to(x.device).long() - 1).clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _window(msg_all, cs_all, cum, bias, invd, t: int):
    """``(msg (B, n, L), seg (B, n, L))`` of the n = min(t + 1, Dmax)
    segments ending at frame ``t``, index d = duration - 1: the messages of
    the source frames ``t - 1 - d`` (0 for the segment from frame 0) and the
    segment scores ``(CS[t + 1] - CS[t - d]) * invd[d] + bias[d]``."""
    Dmax = bias.shape[0]
    nd = min(t, Dmax)
    msg = msg_all[:, t - nd:t].flip(1)
    cs = cs_all[:, t - nd:t].flip(1)
    if t < Dmax:                                   # d == t: from frame 0
        zero = torch.zeros_like(cum)[:, None]
        msg, cs = torch.cat([msg, zero], 1), torch.cat([cs, zero], 1)
    n = msg.shape[1]
    return msg, (cum[:, None] - cs) * invd[:n, None] + bias[:n]


def _rebase_shift(mrow):
    """The kernels' ``rebase_shift``: the row maxima ``mrow (B,)`` rounded
    to whole numbers (0 for a row of NEG_INF alone)."""
    return torch.where(mrow > 0.5 * NEG_INF, torch.round(mrow), 0.0)


def _forward_plain(frame, trans, bias, lengths, mean_pool, tropical,
                   beam_threshold=None, scaled=False):
    """K9 (log semiring) or K12 (tropical) as a frame loop: alphas and logZ
    (and, ``scaled``, the rebased rows' offsets and zhat), or deltas, arg_d,
    lab0 and scores."""
    B, T, L = frame.shape
    dev = frame.device
    lengths = lengths.to(dev)
    Dmax = bias.shape[0]
    invd = pool_weights(Dmax, mean_pool, dev)
    if not tropical:
        tmax, P = forward_factors(trans)
    msg_all = torch.zeros_like(frame)              # q[u] or M[u]
    cs_all = torch.zeros_like(frame)               # CS[u + 1]
    out = torch.full_like(frame, NEG_INF)
    arg_d = torch.zeros((B, T, L), dtype=torch.int32, device=dev)
    cum = torch.zeros((B, L), dtype=frame.dtype, device=dev)
    off = torch.zeros((B, T), dtype=frame.dtype, device=dev)
    base = shift = mrow = torch.zeros((B,), dtype=frame.dtype, device=dev)
    for t in range(T):
        if scaled and t and t % Dmax == 0:         # a cycle's first frame
            shift = _rebase_shift(mrow)
            base = base + shift
        cum = cum + frame[:, t]
        msg, seg = _window(msg_all, cs_all, cum, bias, invd, t)
        if scaled:                                 # sources of the cycle before
            before = torch.arange(msg.shape[1], device=dev) >= t % Dmax
            msg = torch.where(before[None, :, None],
                              msg - shift[:, None, None], msg)
        cand = msg + seg                           # (B, n, L)
        live = (t < lengths)[:, None]
        if tropical:
            row, d_best = cand.max(dim=1)          # the shortest among equals
            if beam_threshold is not None:
                top = row.amax(dim=-1, keepdim=True)
                row = torch.where(row >= top - beam_threshold, row, NEG_INF)
            row = torch.where(live, row, NEG_INF)
            arg_d[:, t] = torch.where(live, d_best, 0).to(torch.int32)
            msg_all[:, t] = (row[:, :, None] + trans).amax(dim=1)
        else:
            cm = torch.clamp(cand.amax(dim=1), min=NEG_INF)
            row = cm + safe_log(torch.exp(cand - cm[:, None]).sum(dim=1))
            row = torch.where(live, row, NEG_INF)
            m = row_max(row)
            msg_all[:, t] = m + tmax + safe_log(torch.exp(row - m) @ P)
            mrow = m[:, 0]
            off[:, t] = torch.where(live[:, 0], base, 0.0)
        out[:, t] = row
        cs_all[:, t] = cum
    last = last_row(out, lengths)
    if not tropical:
        m = row_max(last)
        z = (m + safe_log(torch.exp(last - m).sum(-1, keepdim=True)))[:, 0]
        if not scaled:
            return out, z
        return out, z + last_row(off[..., None], lengths)[:, 0], off, z
    scores, lab0 = last.max(dim=-1)
    empty = lengths <= 0
    return (out, arg_d, torch.where(empty, 0, lab0).to(torch.int32),
            torch.where(empty, NEG_INF, scores))


def segmental_forward_plain(frame, trans, bias, lengths, mean_pool=True,
                            scaled=False):
    """The plain version of :func:`segmental_forward_cuda` (K9): ``(alphas
    (B, T, L), logZ (B,))``; ``scaled``: ``(alphas, logZ, off (B, T), zhat
    (B,))``, the rows rebased (the module's note)."""
    return _forward_plain(frame, trans, bias, lengths, mean_pool, False,
                          scaled=scaled)


def segmental_viterbi_plain(frame, trans, bias, lengths, mean_pool=True,
                            beam_threshold=None):
    """The plain version of :func:`segmental_viterbi_cuda` (K12): ``(deltas
    (B, T, L), arg_d (B, T, L) int32, lab0 (B,) int32, scores (B,))``."""
    return _forward_plain(frame, trans, bias, lengths, mean_pool, True,
                          beam_threshold)


def segmental_backward_plain(frame, trans, bias, lengths, mean_pool=True,
                             scaled=False):
    """The plain version of :func:`segmental_backward_cuda` (K10): ``betas
    (B, T, L)``, 0 at frame ``length - 1``; ``scaled``: ``(betas, off (B,
    T))``, the rows rebased as K10 rebases them, a cycle's base raised at its
    top frame below ``length - 1``."""
    B, T, L = frame.shape
    dev = frame.device
    lengths = lengths.to(dev)
    Dmax = bias.shape[0]
    invd = pool_weights(Dmax, mean_pool, dev)
    tmax_r, Pt = backward_factors(trans)
    ts = torch.arange(T, device=dev)
    fm = torch.where((ts[None, :] < lengths[:, None])[..., None], frame, 0.0)
    betas = torch.full_like(frame, NEG_INF)
    # R[k] = the sum of frames k .. length - 1: CS[b] - CS[a] = R[a] - R[b]
    r_all = torch.zeros((B, T + 1, L), dtype=frame.dtype, device=dev)
    rnow = torch.zeros((B, L), dtype=frame.dtype, device=dev)
    off = torch.zeros((B, T), dtype=frame.dtype, device=dev)
    base = shift = mrow = torch.zeros((B,), dtype=frame.dtype, device=dev)
    for t in range(T - 1, -1, -1):
        inner = t < lengths - 1                    # (B,): below the last
        if scaled and t % Dmax == Dmax - 1:        # a cycle's top frame
            shift = torch.where(inner, _rebase_shift(mrow), shift)
            base = base + torch.where(inner, shift, 0.0)
        nd = min(Dmax, T - 1 - t)
        if nd:
            # segments [t + 1, t + d + 1], d < nd
            bv = betas[:, t + 1:t + 1 + nd]
            if scaled:                             # ... in the cycle above
                above = torch.arange(nd, device=dev) >= Dmax - 1 - t % Dmax
                bv = torch.where(above[None, :, None],
                                 bv - shift[:, None, None], bv)
            w = ((rnow[:, None] - r_all[:, t + 2:t + 2 + nd])
                 * invd[:nd, None] + bias[:nd]) + bv
            cm = torch.clamp(w.amax(dim=1), min=NEG_INF)
            z = cm + safe_log(torch.exp(w - cm[:, None]).sum(dim=1))
        else:
            z = torch.full((B, L), NEG_INF, dtype=frame.dtype, device=dev)
        zm = row_max(z)
        beta = zm + tmax_r + safe_log(torch.exp(z - zm) @ Pt)
        beta = torch.where((t == lengths - 1)[:, None], 0.0, beta)
        betas[:, t] = torch.where((t >= lengths)[:, None], NEG_INF, beta)
        mrow = torch.where(inner, zm[:, 0], mrow)
        off[:, t] = torch.where(t < lengths, base, 0.0)
        r_all[:, t + 1] = rnow
        rnow = rnow + fm[:, t]
    return (betas, off) if scaled else betas


def _running_sum(frame):
    """``cs (B, T, L)``: ``cs[:, t] = CS[t + 1]``, the sum of frames ``0 ..
    t``, added in frame order as the kernels add it."""
    cs = torch.empty_like(frame)
    cum = torch.zeros_like(frame[:, 0])
    for t in range(frame.shape[1]):
        cum = cum + frame[:, t]
        cs[:, t] = cum
    return cs


def segmental_grad_message_plain(frame, trans, bias, lengths, alphas):
    """The plain version of :func:`segmental_grad_message_cuda` (K11's
    message pass): ``(E (B, T, L4), q (B, T, L), cs (B, T, L), m (B, T))``,
    ``m`` the row maxima of the alphas, ``E = exp(alphas - m)`` in rows of
    ``L4 = row_width(L)`` floats (zeros past ``L`` and at and past a
    length), ``q = m + tmax + log(E @ P)`` the messages and ``cs`` the
    running sums.  Rows of ``q``, ``cs`` and ``m`` at and past a length are
    not read (0 here)."""
    B, T, L = frame.shape
    dev = frame.device
    live = (torch.arange(T, device=dev)[None, :]
            < lengths.to(dev)[:, None])[..., None]
    tmax, P = forward_factors(trans)
    m = row_max(alphas)                            # (B, T, 1)
    e = torch.where(live, torch.exp(alphas - m), 0.0)
    q = torch.where(live, m + tmax + safe_log(e @ P), 0.0)
    cs = torch.where(live, _running_sum(frame), 0.0)
    E = torch.zeros((B, T, row_width(L)), dtype=frame.dtype, device=dev)
    E[..., :L] = e
    return E, q, cs, torch.where(live, m, 0.0)[..., 0]


def segmental_grad_xi_plain(q, cs, m, betas, logZ, g, bias, lengths,
                            mean_pool=True, aoff=None, boff=None):
    """The plain version of :func:`segmental_grad_xi_cuda` (K11's xi pass),
    gathered by duration as the kernel gathers: ``(A (B, T, L), S (B, T, L),
    F (B, T, L4), gd (Dmax, L))``.  Segment ``[k, t]`` (``t = k + d <
    length``) has source ``u = k - 1`` (none for ``k = 0``: message and CS
    0) and ``x = (cs[t] - cs[u]) * invd[d] + bias[d] + beta[t] - logZ``;
    ``xi = g exp(q[u] + x)``; ``A[t]`` and ``S[k]`` gather ``invd[d] xi``,
    ``gd[d]`` gathers ``xi``, ``F[u]`` gathers ``g exp(x + m[u])``, each over
    ``d`` in ascending order.  Rows at and past a length (and ``F`` at
    ``length - 1``) hold 0.  ``aoff``, ``boff (B, T)``: the offsets of
    rebased alphas (so of ``q`` and ``m``) and betas, ``logZ`` then K9's
    ``zhat``; each exponent adds the exact whole number ``aoff[u] + boff[t]
    - aoff[length - 1]`` last."""
    B, T, L = q.shape
    dev = q.device
    Dmax = bias.shape[0]
    invd = pool_weights(Dmax, mean_pool, dev)
    ts = torch.arange(T, device=dev)
    lengths = lengths.to(dev)
    x0 = betas - logZ[:, None, None]
    gB = g[:, None, None]
    A, S = torch.zeros_like(q), torch.zeros_like(q)
    F = torch.zeros((B, T, row_width(L)), dtype=q.dtype, device=dev)
    gd = torch.zeros((Dmax, L), dtype=q.dtype, device=dev)
    zero = torch.zeros_like(q[:, :1])
    if aoff is not None:                           # boff[t] - oz, each end
        ko = boff - last_row(aoff[..., None], lengths)
    for d in range(min(Dmax, T)):
        n = T - d                                  # ends d.., starts 0..n-1
        q_src = torch.cat([zero, q[:, :n - 1]], 1)
        cs_src = torch.cat([zero, cs[:, :n - 1]], 1)
        xv = ((cs[:, d:] - cs_src) * invd[d] + bias[d]) + x0[:, d:]
        valid = (ts[d:][None, :] < lengths[:, None])[..., None]
        e_xi, e_f = q_src + xv, xv[:, 1:] + m[:, :n - 1, None]
        if aoff is not None:
            kv = (torch.cat([zero[..., 0], aoff[:, :n - 1]], 1)
                  + ko[:, d:])[..., None]
            e_xi, e_f = e_xi + kv, e_f + kv[:, 1:]
        xi = torch.where(valid, torch.exp(e_xi) * gB, 0.0)
        y = invd[d] * xi
        A[:, d:] += y
        S[:, :n] += y
        gd[d] = xi.sum(dim=(0, 1))
        if n > 1:                                  # starts k >= 1: u = k - 1
            F[:, :n - 1, :L] += torch.where(valid[:, 1:],
                                            torch.exp(e_f) * gB, 0.0)
    return A, S, F, gd


def segmental_grad_contract_plain(E, F, L: int):
    """The plain version of :func:`segmental_grad_contract_cuda`: ``gt (L,
    L) = sum_u E[u]^T F[u]`` over the rows' first ``L`` columns."""
    return backward_dual_contract_plain(E, F, L)


def segmental_grad_plain(frame, trans, bias, lengths, alphas, betas, logZ, g,
                         mean_pool=True, aoff=None, boff=None):
    """The plain version of :func:`segmental_grad_cuda` (K11): the xi pass.
    Returns ``(A (B, T, L), S (B, T, L), gd (Dmax, L), gt (L, L))``: the
    pooled posteriors of the segments ending (A) and starting (S) at each
    frame, the bias gradient, and the transition partial with ``g_trans =
    sign(gt) * exp(trans + log|gt|)`` left to the caller.  ``g (B,)``: the
    cotangent of logZ, folded into every term.  The message pass, the xi
    pass and the contraction, as the kernels run them.  ``aoff``, ``boff``:
    rebased rows' offsets (:func:`segmental_grad_xi_plain`)."""
    E, q, cs, m = segmental_grad_message_plain(frame, trans, bias, lengths,
                                               alphas)
    A, S, F, gd = segmental_grad_xi_plain(q, cs, m, betas, logZ, g, bias,
                                          lengths, mean_pool, aoff, boff)
    return A, S, gd, segmental_grad_contract_plain(E, F, frame.shape[-1])


def segmental_viterbi_traceback_plain(deltas, arg_d, trans, lab0, lengths):
    """The plain version of :func:`segmental_viterbi_traceback_cuda` (K13):
    ``(end_lab (B, T) int32, -1 where no segment ends; end_start (B, T)
    int32)``.  A walk on the host, one utterance after the other."""
    B, T, L = deltas.shape
    dl, ad = deltas.cpu().numpy(), arg_d.cpu().numpy()
    tr, l0, ln = trans.cpu().numpy(), lab0.cpu().numpy(), lengths.cpu().numpy()
    end_lab = np.full((B, T), -1, np.int32)
    end_start = np.zeros((B, T), np.int32)
    for b in range(B):
        t, lab = min(max(int(ln[b]), 0), T) - 1, int(l0[b])
        while t >= 0:
            start = t - int(ad[b, t, lab])
            end_lab[b, t], end_start[b, t] = lab, start
            if start <= 0:
                break
            lab = int(np.argmax(dl[b, start - 1] + tr[:, lab]))
            t = start - 1
    return (torch.from_numpy(end_lab).to(deltas.device),
            torch.from_numpy(end_start).to(deltas.device))


def emit_layout(S, max_dur: int):
    """``(S_emit (B, T, L), acc_fin (B, Dmax, L))``: the start contributions
    in the delayed layout of the JAX ``_grad_scan`` (batch-major).
    ``S_emit[:, t] = S[:, t - Dmax + 1]`` (0 before frame ``Dmax - 1``);
    ``acc_fin[:, j] = S[:, T - j]`` for ``1 <= j < Dmax`` (0 where that frame
    is negative, and for j = 0)."""
    B, T, L = S.shape
    S_emit = torch.zeros_like(S)
    if T >= max_dur:
        S_emit[:, max_dur - 1:] = S[:, :T - max_dur + 1]
    acc_fin = torch.zeros((B, max_dur, L), dtype=S.dtype, device=S.device)
    for j in range(1, min(max_dur, T + 1)):
        acc_fin[:, j] = S[:, T - j]
    return S_emit, acc_fin


def frame_grad(A, S):
    """The frame-score gradient ``(B, T, L)`` from the xi pass's pieces:
    ``g_frame[u] = sum_{t >= u} A[t] - sum_{k > u} S[k] = sum_{t >= u} (A[t]
    - S[t + 1])``: one reverse cumulative sum, taken along the innermost
    axis of a ``(B, L, T)`` copy (a scan over a middle axis is several times
    slower on the card)."""
    d = A.clone()
    d[:, :-1] -= S[:, 1:]
    d = d.transpose(1, 2).contiguous()
    return d.flip(-1).cumsum(dim=-1).flip(-1).transpose(1, 2)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.seg_forward.argtypes = ([ptr] * 6 + [i32] + [ptr] * 5 + [i32] * 4
                                    + [ptr])
        lib.seg_viterbi.argtypes = ([ptr] * 4 + [i32] + [ptr] * 5 + [i32] * 5
                                    + [f32, ptr])
        lib.seg_backward.argtypes = ([ptr] * 6 + [i32] + [ptr] * 3
                                     + [i32] * 4 + [ptr])
        lib.seg_grad_message.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.seg_grad_xi.argtypes = ([ptr] * 9 + [i32] + [ptr] * 6 + [i32] * 4
                                    + [ptr])
        lib.seg_traceback.argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
        lib.seg_traceback_frames.argtypes = [i32, ctypes.POINTER(i32)]
        lib.seg_traceback_frames.restype = i32
        for name in ("seg_forward", "seg_viterbi", "seg_backward",
                     "seg_grad_message", "seg_grad_xi", "seg_traceback",
                     "seg_frame", "seg_grad_chunk", "seg_grad_xi16"):
            getattr(lib, name).restype = i32
        lib.seg_frame.argtypes = [i32] * 2
        lib.seg_grad_chunk.argtypes = [i32] * 2
        lib.seg_grad_xi16.argtypes = [i32] * 2
        lib.seg_smem_bytes.argtypes = [i32] * 3
        lib.seg_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def traceback_plan(L: int):
    """``(C, trans_shared)`` of K13 at width L (the kernel's
    ``seg_traceback_frames``): the frames of its stream blocks, each slot
    holding C frames of deltas and of arg_d (:func:`asr_craft_tpu_torch.
    kernels.fdt_viterbi.stream_frames`), and whether trans^T (L^2 floats)
    is staged beside the ring; C = 0 where one frame does not fit."""
    trans = 4 * ((L * L + 3) // 4 * 4)
    C = stream_frames(L, 2, trans)
    return (C, True) if C else (stream_frames(L, 2, 0), False)


def smem_bytes(name: str, L: int, max_dur: int) -> int:
    """The dynamic shared memory of kernel ``name`` (a key of ``KINDS``) at
    this shape in bytes (K11: the larger of its two passes'); 0: it does not
    take this ``(L, Dmax)``."""
    return _library().seg_smem_bytes(KINDS[name], L, max_dur)


def recursion_frame(L: int, max_dur: int) -> int:
    """The frame of K9, K10 and K12 at ``(L, Dmax)``: the ``QV`` of their
    own layout (3, 5, 9: the factor in registers; 10-15: in shared memory),
    0 where only the three-barrier frame (``seg_forward_kernel``,
    ``seg_backward_kernel``: a smaller footprint) fits their windows, -1
    where they do not take them."""
    return _library().seg_frame(L, max_dur)


@functools.lru_cache(maxsize=None)
def recursion_path(L: int, max_dur: int) -> str:
    """The frame K9, K10 and K12 take at ``(L, Dmax)`` (:func:`
    recursion_frame`), as their launch counters name it:
    ``"own"`` or ``"three_barrier"``."""
    return "three_barrier" if recursion_frame(L, max_dur) == 0 else "own"


@functools.lru_cache(maxsize=None)
def xi_kernel(L: int, max_dur: int) -> str:
    """The kernel of K11's xi pass at ``(L, Dmax)``, as the counter
    ``kernels.segmental_grad[...]`` names it: ``"16"`` (``seg_xi16_kernel``:
    windows of at most 16 durations) or ``"deep"`` (``seg_xi_kernel``)."""
    return "16" if _library().seg_grad_xi16(L, max_dur) == 1 else "deep"


def _check(name, frame, trans, bias, lengths):
    """Validate what K9-K12 take; returns (B, T, L, Dmax)."""
    dev = frame.device
    _build.check_tensor("frame", frame, torch.float32, 3, dev)
    _build.check_tensor("trans", trans, torch.float32, 2, dev)
    _build.check_tensor("bias", bias, torch.float32, 2, dev)
    _build.check_tensor("lengths", lengths, torch.int32, 1, dev)
    B, T, L = frame.shape
    Dmax = bias.shape[0]
    if tuple(trans.shape) != (L, L) or bias.shape[1] != L:
        raise ValueError(f"trans {tuple(trans.shape)} / bias "
                         f"{tuple(bias.shape)} vs frame {tuple(frame.shape)}")
    if tuple(lengths.shape) != (B,) or T < 1 or L < 1 or Dmax < 1:
        raise ValueError(f"lengths {tuple(lengths.shape)} vs frame "
                         f"{tuple(frame.shape)}, Dmax {Dmax}")
    if smem_bytes(name, L, Dmax) == 0:
        raise ValueError(
            f"L = {L}, Dmax = {Dmax}: the segmental kernels take the widths "
            "at which the transition factor and the Dmax-slot windows fit a "
            "block's shared memory (232448 bytes; L <= 205 at Dmax = 16, "
            "the gradient's passes too)")
    return B, T, L, Dmax


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(x):
    return None if x is None else x.data_ptr()


def _old_invd(old: bool, max_dur: int, mean_pool: bool, dev):
    """invd for the three-barrier frame, which takes it formed (K9's frame
    forms it from the pooling); the caller holds it until the launch."""
    return pool_weights(max_dur, mean_pool, dev) if old else None


def segmental_forward_cuda(frame, trans, bias, lengths, mean_pool=True,
                           scaled=False):
    """K9 on the card: ``(alphas (B, T, L), logZ (B,))``, with ``scaled``
    ``(alphas, logZ, off (B, T), zhat (B,))``, as
    :func:`segmental_forward_plain` returns."""
    B, T, L, Dmax = _check("segmental_forward", frame, trans, bias, lengths)
    dev = frame.device
    alphas = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    logZ = torch.empty((B,), dtype=torch.float32, device=dev)
    off = zhat = None
    if scaled:
        off = torch.zeros((B, T), dtype=torch.float32, device=dev)
        zhat = torch.zeros((B,), dtype=torch.float32, device=dev)
    if B:
        old = recursion_frame(L, Dmax) == 0
        tmax, P = forward_factors(trans) if old else (None, None)
        invd = _old_invd(old, Dmax, mean_pool, dev)
        with torch.cuda.device(dev):
            code = _library().seg_forward(
                frame.data_ptr(), trans.data_ptr(), _ptr(P), _ptr(tmax),
                bias.data_ptr(), _ptr(invd), int(mean_pool),
                lengths.data_ptr(), alphas.data_ptr(), logZ.data_ptr(),
                _ptr(off), _ptr(zhat), B, T, L, Dmax, _stream(dev))
        _build.raise_on_error(code, "segmental forward launch")
        diagnostics.count(
            f"kernels.segmental_forward[{recursion_path(L, Dmax)}]")
    return (alphas, logZ, off, zhat) if scaled else (alphas, logZ)


def segmental_viterbi_cuda(frame, trans, bias, lengths, mean_pool=True,
                           beam_threshold=None):
    """K12 on the card: ``(deltas, arg_d, lab0, scores)``, as
    :func:`segmental_viterbi_plain` returns."""
    B, T, L, Dmax = _check("segmental_viterbi", frame, trans, bias, lengths)
    dev = frame.device
    deltas = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    arg_d = torch.empty((B, T, L), dtype=torch.int32, device=dev)
    lab0 = torch.empty((B,), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        invd = _old_invd(recursion_frame(L, Dmax) == 0, Dmax, mean_pool, dev)
        with torch.cuda.device(dev):
            code = _library().seg_viterbi(
                frame.data_ptr(), trans.data_ptr(), bias.data_ptr(),
                _ptr(invd), int(mean_pool), lengths.data_ptr(),
                deltas.data_ptr(), arg_d.data_ptr(), scores.data_ptr(),
                lab0.data_ptr(), B, T, L, Dmax,
                int(beam_threshold is not None),
                float(beam_threshold or 0.0), _stream(dev))
        _build.raise_on_error(code, "segmental viterbi launch")
        diagnostics.count(
            f"kernels.segmental_viterbi[{recursion_path(L, Dmax)}]")
    return deltas, arg_d, lab0, scores


def segmental_backward_cuda(frame, trans, bias, lengths, mean_pool=True,
                            scaled=False):
    """K10 on the card: ``betas (B, T, L)``, with ``scaled`` ``(betas, off
    (B, T))``, as :func:`segmental_backward_plain` returns."""
    B, T, L, Dmax = _check("segmental_backward", frame, trans, bias, lengths)
    dev = frame.device
    betas = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    off = (torch.zeros((B, T), dtype=torch.float32, device=dev) if scaled
           else None)
    if B:
        old = recursion_frame(L, Dmax) == 0
        tmax_r, Pt = backward_factors(trans) if old else (None, None)
        invd = _old_invd(old, Dmax, mean_pool, dev)
        with torch.cuda.device(dev):
            code = _library().seg_backward(
                frame.data_ptr(), trans.data_ptr(), _ptr(Pt), _ptr(tmax_r),
                bias.data_ptr(), _ptr(invd), int(mean_pool),
                lengths.data_ptr(), betas.data_ptr(), _ptr(off), B, T, L,
                Dmax, _stream(dev))
        _build.raise_on_error(code, "segmental backward launch")
        diagnostics.count(
            f"kernels.segmental_backward[{recursion_path(L, Dmax)}]")
    return (betas, off) if scaled else betas


def _check_rows(B, T, L, dev, **tensors):
    """Each tensor a (B, T, L) float32 one on ``dev``."""
    for name, x in tensors.items():
        _build.check_tensor(name, x, torch.float32, 3, dev)
        if tuple(x.shape) != (B, T, L):
            raise ValueError(f"{name} {tuple(x.shape)}, expected "
                             f"{(B, T, L)}")


def _check_per_row(B, dev, **tensors):
    """Each tensor a 1-D float32 one of B entries on ``dev``."""
    for name, v in tensors.items():
        _build.check_tensor(name, v, torch.float32, 1, dev)
        if v.shape[0] != B:
            raise ValueError(f"{name} has {v.shape[0]} rows, expected {B}")


def segmental_grad_message_cuda(frame, trans, bias, lengths, alphas):
    """K11's message pass on the card: ``(E, q, cs, m)``, as
    :func:`segmental_grad_message_plain` returns (rows of ``q``, ``cs`` and
    ``m`` at and past a length are left unwritten)."""
    B, T, L, Dmax = _check("segmental_grad", frame, trans, bias, lengths)
    dev = frame.device
    _check_rows(B, T, L, dev, alphas=alphas)
    E = torch.empty((B, T, row_width(L)), dtype=torch.float32, device=dev)
    q = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    cs = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    m = torch.empty((B, T), dtype=torch.float32, device=dev)
    if B:
        with torch.cuda.device(dev):
            code = _library().seg_grad_message(
                alphas.data_ptr(), frame.data_ptr(), trans.data_ptr(),
                lengths.data_ptr(), E.data_ptr(), q.data_ptr(), cs.data_ptr(),
                m.data_ptr(), B, T, L, Dmax, _stream(dev))
        _build.raise_on_error(code, "segmental grad message launch")
        diagnostics.count("kernels.segmental_grad_message")
    return E, q, cs, m


def segmental_grad_xi_cuda(q, cs, m, betas, logZ, g, bias, lengths,
                           mean_pool=True, aoff=None, boff=None):
    """K11's xi pass on the card: ``(A, S, F, gd)``, as
    :func:`segmental_grad_xi_plain` returns.  Each block of start frames
    writes its gd partial and a second kernel adds them in block order, so
    the result is the same on every run."""
    dev = q.device
    _build.check_tensor("q", q, torch.float32, 3, dev)
    B, T, L = q.shape
    _check_rows(B, T, L, dev, cs=cs, betas=betas)
    _check_per_row(B, dev, logZ=logZ, g=g)
    if (aoff is None) != (boff is None):
        raise ValueError("aoff and boff come together: rebased alphas and "
                         "betas")
    for name, o in (("aoff", aoff), ("boff", boff)):
        if o is not None:
            _build.check_tensor(name, o, torch.float32, 2, dev)
            if tuple(o.shape) != (B, T):
                raise ValueError(f"{name} {tuple(o.shape)}, expected "
                                 f"{(B, T)}")
    _build.check_tensor("m", m, torch.float32, 2, dev)
    _build.check_tensor("bias", bias, torch.float32, 2, dev)
    _build.check_tensor("lengths", lengths, torch.int32, 1, dev)
    Dmax = bias.shape[0]
    if tuple(m.shape) != (B, T) or bias.shape[1] != L or \
            tuple(lengths.shape) != (B,):
        raise ValueError(f"m {tuple(m.shape)}, bias {tuple(bias.shape)}, "
                         f"lengths {tuple(lengths.shape)} vs q {(B, T, L)}")
    chunk = _library().seg_grad_chunk(L, Dmax)
    if chunk == 0:
        raise ValueError(f"L = {L}, Dmax = {Dmax}: the gradient's passes "
                         "do not take these widths (L <= 205 at Dmax = 16)")
    A = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    S = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    F = torch.empty((B, T, row_width(L)), dtype=torch.float32, device=dev)
    gd = torch.empty((Dmax, L), dtype=torch.float32, device=dev)
    if B:
        gd_part = torch.empty((B * -(-T // chunk), Dmax, L),
                              dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            code = _library().seg_grad_xi(
                q.data_ptr(), cs.data_ptr(), m.data_ptr(), betas.data_ptr(),
                logZ.data_ptr(), g.data_ptr(), _ptr(aoff), _ptr(boff),
                bias.data_ptr(), int(mean_pool), lengths.data_ptr(),
                A.data_ptr(), S.data_ptr(), F.data_ptr(), gd_part.data_ptr(),
                gd.data_ptr(), B, T, L, Dmax, _stream(dev))
        _build.raise_on_error(code, "segmental grad xi launch")
        diagnostics.count(f"kernels.segmental_grad[{xi_kernel(L, Dmax)}]")
    else:
        gd.zero_()
    return A, S, F, gd


def segmental_grad_contract_cuda(E, F, L: int):
    """``gt = sum_u E[u]^T F[u]`` on the card, on the tensor cores (3xTF32):
    K5's contraction kernel (``csrc/fwdbwd_mma.cu``) over the ``B T`` rows
    of ``L4`` floats, summed in chunks and the chunks in order, as
    :func:`segmental_grad_contract_plain` returns."""
    gt = fwdbwd.contract_rows(E, F, L)
    diagnostics.count("kernels.segmental_grad_contract")
    return gt


def segmental_grad_cuda(frame, trans, bias, lengths, alphas, betas, logZ, g,
                        mean_pool=True, aoff=None, boff=None):
    """K11 on the card: ``(A, S, gd, gt)``, as :func:`segmental_grad_plain`
    returns: the message pass, the xi pass and the contraction, five kernel
    launches in all, every sum in a fixed order: the same result on every
    run."""
    B, T, L, Dmax = _check("segmental_grad", frame, trans, bias, lengths)
    dev = frame.device
    _check_rows(B, T, L, dev, alphas=alphas, betas=betas)
    _check_per_row(B, dev, logZ=logZ, g=g)
    if not B:
        z = torch.zeros((B, T, L), dtype=torch.float32, device=dev)
        return (z, z.clone(), torch.zeros((Dmax, L), device=dev),
                torch.zeros((L, L), device=dev))
    E, q, cs, m = segmental_grad_message_cuda(frame, trans, bias, lengths,
                                              alphas)
    A, S, F, gd = segmental_grad_xi_cuda(q, cs, m, betas, logZ, g, bias,
                                         lengths, mean_pool, aoff, boff)
    return A, S, gd, segmental_grad_contract_cuda(E, F, L)


def segmental_viterbi_traceback_cuda(deltas, arg_d, trans, lab0, lengths):
    """K13 on the card (one block an utterance, its deltas and arg_d rows
    streamed through shared memory in blocks of :func:`traceback_plan`'s C
    frames): ``(end_lab, end_start)``, as
    :func:`segmental_viterbi_traceback_plain` returns."""
    dev = deltas.device
    _build.check_tensor("deltas", deltas, torch.float32, 3, dev)
    _build.check_tensor("arg_d", arg_d, torch.int32, 3, dev)
    _build.check_tensor("trans", trans, torch.float32, 2, dev)
    _build.check_tensor("lab0", lab0, torch.int32, 1, dev)
    _build.check_tensor("lengths", lengths, torch.int32, 1, dev)
    B, T, L = deltas.shape
    if (tuple(arg_d.shape) != (B, T, L) or tuple(trans.shape) != (L, L)
            or lab0.shape[0] != B or lengths.shape[0] != B or T < 1 or L < 1):
        raise ValueError(f"arg_d {tuple(arg_d.shape)}, trans "
                         f"{tuple(trans.shape)}, lab0 {tuple(lab0.shape)}, "
                         f"lengths {tuple(lengths.shape)} vs deltas "
                         f"{tuple(deltas.shape)}")
    if not traceback_plan(L)[0]:
        raise ValueError(f"the segmental traceback's stream does not fit "
                         f"one frame of L = {L} labels in a block's shared "
                         "memory")
    end_lab = torch.empty((B, T), dtype=torch.int32, device=dev)
    end_start = torch.empty((B, T), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            code = _library().seg_traceback(
                deltas.data_ptr(), arg_d.data_ptr(), trans.data_ptr(),
                lab0.data_ptr(), lengths.data_ptr(), end_lab.data_ptr(),
                end_start.data_ptr(), B, T, L, _stream(dev))
        _build.raise_on_error(code, "segmental traceback launch")
        diagnostics.count("kernels.segmental_viterbi_traceback")
    return end_lab, end_start


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _i32(t, dev):
    return t.to(device=dev, dtype=torch.int32).contiguous()


def segmental_forward(frame, trans, bias, lengths, mean_pool=True,
                      scaled=False):
    """SCRF alpha pass and logZ: K9 or its plain version (``scaled``: the
    rows rebased, with their offsets and zhat)."""
    if kernels.use_kernel(frame):
        return segmental_forward_cuda(
            frame.contiguous(), trans.contiguous(), bias.contiguous(),
            _i32(lengths, frame.device), mean_pool, scaled)
    return segmental_forward_plain(frame, trans, bias, lengths, mean_pool,
                                   scaled)


def segmental_backward(frame, trans, bias, lengths, mean_pool=True,
                       scaled=False):
    """SCRF beta pass: K10 or its plain version (``scaled``: the rows
    rebased, with their offsets)."""
    if kernels.use_kernel(frame):
        return segmental_backward_cuda(
            frame.contiguous(), trans.contiguous(), bias.contiguous(),
            _i32(lengths, frame.device), mean_pool, scaled)
    return segmental_backward_plain(frame, trans, bias, lengths, mean_pool,
                                    scaled)


def segmental_grad(frame, trans, bias, lengths, alphas, betas, logZ, g,
                   mean_pool=True, aoff=None, boff=None):
    """The xi pass: K11 or its plain version (``aoff``, ``boff``: the
    offsets of rebased alphas and betas, ``logZ`` then K9's zhat)."""
    if kernels.use_kernel(frame):
        return segmental_grad_cuda(
            frame.contiguous(), trans.contiguous(), bias.contiguous(),
            _i32(lengths, frame.device), alphas.contiguous(),
            betas.contiguous(), logZ.contiguous(), g.contiguous(), mean_pool,
            aoff, boff)
    return segmental_grad_plain(frame, trans, bias, lengths, alphas, betas,
                                logZ, g, mean_pool, aoff, boff)


def segmental_viterbi(frame, trans, bias, lengths, mean_pool=True,
                      beam_threshold=None):
    """The max-plus pass: K12 or its plain version."""
    if kernels.use_kernel(frame):
        return segmental_viterbi_cuda(
            frame.contiguous(), trans.contiguous(), bias.contiguous(),
            _i32(lengths, frame.device), mean_pool, beam_threshold)
    return segmental_viterbi_plain(frame, trans, bias, lengths, mean_pool,
                                   beam_threshold)


def segmental_viterbi_traceback(deltas, arg_d, trans, lab0, lengths):
    """The segment traceback: K13 or its plain version."""
    if kernels.use_kernel(deltas):
        dev = deltas.device
        return segmental_viterbi_traceback_cuda(
            deltas.contiguous(), _i32(arg_d, dev), trans.contiguous(),
            _i32(lab0, dev), _i32(lengths, dev))
    return segmental_viterbi_traceback_plain(deltas, arg_d, trans, lab0,
                                             lengths)
