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
do.

=====================================  ==========================  ==========
dispatch                               kernel wrapper              plain
=====================================  ==========================  ==========
:func:`segmental_forward` (K9)         ``segmental_forward_cuda``  ``..._plain``
:func:`segmental_backward` (K10)       ``segmental_backward_cuda`` ``..._plain``
:func:`segmental_grad` (K11)           ``segmental_grad_cuda``     ``..._plain``
:func:`segmental_viterbi` (K12)        ``segmental_viterbi_cuda``  ``..._plain``
:func:`segmental_viterbi_traceback`    ``segmental_viterbi_        ``..._plain``
(K13)                                  traceback_cuda``
=====================================  ==========================  ==========

Everything is batch-major: ``frame (B, T, L)`` float32 per-frame label
scores, ``trans (L, L)``, ``bias (Dmax, L)`` the combined duration and label
bias of a segment, ``lengths (B,)`` int32.  Rows at and past a length hold
NEG_INF (alphas, betas, deltas) or 0 (A, S, arg_d).

Where the port's outputs differ from the JAX functions':

- logZ (K9) and the final score and label (K12) are taken inside the kernel
  from the row of frame ``length - 1``; an empty row reports ``NEG_INF`` and
  label 0.
- K11 returns ``(A, S, gd, gt)`` with ``S[b, k]`` the start contributions
  of frame ``k`` itself: one block sees the whole utterance and writes each
  completed start frame to its place.  The JAX function returns them
  delayed (``S_emit[t] = S[t - Dmax + 1]``) with the last ``Dmax - 1`` in
  ``acc_fin``; :func:`emit_layout` rebuilds that pair for the tests, and
  :func:`frame_grad` is the assembly the training path uses.

A kernel takes the ``(L, Dmax)`` at which the transition factor and the
Dmax-slot windows fit a block's shared memory (at ``Dmax = 16``: ``L <=
205``; K11 ``L <= 144``, where its register tiles cover the ``(L, L)``
partial); the wrappers raise beyond.

The dispatchers follow :func:`asr_craft_tpu_torch.kernels.use_kernel`: a
CUDA tensor under ``auto`` launches the kernel or raises, a CPU tensor takes
the plain version.  ``launches`` counts each wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.kernels.fwdbwd import (backward_factors,
                                                forward_factors, row_max,
                                                safe_log)
from asr_craft_tpu_torch.ops.semiring import NEG_INF

launches = {"segmental_forward": 0, "segmental_backward": 0,
            "segmental_grad": 0, "segmental_viterbi": 0,
            "segmental_viterbi_traceback": 0}
KINDS = {"segmental_forward": 0, "segmental_viterbi": 1,
         "segmental_backward": 2, "segmental_grad": 3}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


def _forward_plain(frame, trans, bias, lengths, mean_pool, tropical,
                   beam_threshold=None):
    """K9 (log semiring) or K12 (tropical) as a frame loop: alphas and logZ,
    or deltas, arg_d, lab0 and scores."""
    B, T, L = frame.shape
    dev = frame.device
    lengths = lengths.to(dev)
    invd = pool_weights(bias.shape[0], mean_pool, dev)
    if not tropical:
        tmax, P = forward_factors(trans)
    msg_all = torch.zeros_like(frame)              # q[u] or M[u]
    cs_all = torch.zeros_like(frame)               # CS[u + 1]
    out = torch.full_like(frame, NEG_INF)
    arg_d = torch.zeros((B, T, L), dtype=torch.int32, device=dev)
    cum = torch.zeros((B, L), dtype=frame.dtype, device=dev)
    for t in range(T):
        cum = cum + frame[:, t]
        msg, seg = _window(msg_all, cs_all, cum, bias, invd, t)
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
        out[:, t] = row
        cs_all[:, t] = cum
    last = last_row(out, lengths)
    if not tropical:
        m = row_max(last)
        return out, (m + safe_log(torch.exp(last - m).sum(-1, keepdim=True))
                     )[:, 0]
    scores, lab0 = last.max(dim=-1)
    empty = lengths <= 0
    return (out, arg_d, torch.where(empty, 0, lab0).to(torch.int32),
            torch.where(empty, NEG_INF, scores))


def segmental_forward_plain(frame, trans, bias, lengths, mean_pool=True):
    """The plain version of :func:`segmental_forward_cuda` (K9): ``(alphas
    (B, T, L), logZ (B,))``."""
    return _forward_plain(frame, trans, bias, lengths, mean_pool, False)


def segmental_viterbi_plain(frame, trans, bias, lengths, mean_pool=True,
                            beam_threshold=None):
    """The plain version of :func:`segmental_viterbi_cuda` (K12): ``(deltas
    (B, T, L), arg_d (B, T, L) int32, lab0 (B,) int32, scores (B,))``."""
    return _forward_plain(frame, trans, bias, lengths, mean_pool, True,
                          beam_threshold)


def segmental_backward_plain(frame, trans, bias, lengths, mean_pool=True):
    """The plain version of :func:`segmental_backward_cuda` (K10): ``betas
    (B, T, L)``, 0 at frame ``length - 1``."""
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
    for t in range(T - 1, -1, -1):
        nd = min(Dmax, T - 1 - t)
        if nd:
            # segments [t + 1, t + d + 1], d < nd
            w = ((rnow[:, None] - r_all[:, t + 2:t + 2 + nd])
                 * invd[:nd, None] + bias[:nd]) + betas[:, t + 1:t + 1 + nd]
            cm = torch.clamp(w.amax(dim=1), min=NEG_INF)
            z = cm + safe_log(torch.exp(w - cm[:, None]).sum(dim=1))
        else:
            z = torch.full((B, L), NEG_INF, dtype=frame.dtype, device=dev)
        zm = row_max(z)
        beta = zm + tmax_r + safe_log(torch.exp(z - zm) @ Pt)
        beta = torch.where((t == lengths - 1)[:, None], 0.0, beta)
        betas[:, t] = torch.where((t >= lengths)[:, None], NEG_INF, beta)
        r_all[:, t + 1] = rnow
        rnow = rnow + fm[:, t]
    return betas


def segmental_grad_plain(frame, trans, bias, lengths, alphas, betas, logZ, g,
                         mean_pool=True):
    """The plain version of :func:`segmental_grad_cuda` (K11): the xi pass.
    Returns ``(A (B, T, L), S (B, T, L), gd (Dmax, L), gt (L, L))``: the
    pooled posteriors of the segments ending (A) and starting (S) at each
    frame, the bias gradient, and the transition partial with ``g_trans =
    sign(gt) * exp(trans + log|gt|)`` left to the caller.  ``g (B,)``: the
    cotangent of logZ, folded into every term."""
    B, T, L = frame.shape
    dev = frame.device
    lengths = lengths.to(dev)
    Dmax = bias.shape[0]
    invd = pool_weights(Dmax, mean_pool, dev)
    tmax, P = forward_factors(trans)
    m_all = row_max(alphas)                        # (B, T, 1)
    e_all = torch.exp(alphas - m_all)
    q_all = m_all + tmax + safe_log(e_all @ P)
    cs_all = torch.zeros_like(frame)
    A, S, F = (torch.zeros_like(frame) for _ in range(3))
    gd = torch.zeros((B, Dmax, L), dtype=frame.dtype, device=dev)
    cum = torch.zeros((B, L), dtype=frame.dtype, device=dev)
    gB = g[:, None, None]
    for t in range(T):
        cum = cum + frame[:, t]
        q, seg = _window(q_all, cs_all, cum, bias, invd, t)
        n, nd = q.shape[1], min(t, Dmax)
        xv = seg + (betas[:, t] - logZ[:, None])[:, None]
        valid = (t < lengths)[:, None, None]
        xi = torch.where(valid, torch.exp(q + xv) * gB, 0.0)
        y = invd[:n, None] * xi
        A[:, t] = y.sum(dim=1)
        S[:, t - n + 1:t + 1] += y.flip(1)         # d starts at frame t - d
        gd[:, :n] += xi
        if nd:                                     # source frames t - 1 - d
            mu = m_all[:, t - nd:t].flip(1)
            F[:, t - nd:t] += torch.where(
                valid, torch.exp(xv[:, :nd] + mu) * gB, 0.0).flip(1)
        cs_all[:, t] = cum
    return A, S, gd.sum(dim=0), torch.einsum("btp,btl->pl", e_all, F)


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
        lib.seg_forward.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.seg_viterbi.argtypes = [ptr] * 9 + [i32] * 5 + [f32, ptr]
        lib.seg_backward.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        lib.seg_grad.argtypes = [ptr] * 16 + [i32] * 4 + [ptr]
        lib.seg_traceback.argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
        for name in ("seg_forward", "seg_viterbi", "seg_backward",
                     "seg_grad", "seg_traceback"):
            getattr(lib, name).restype = i32
        lib.seg_smem_bytes.argtypes = [i32] * 3
        lib.seg_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def smem_bytes(name: str, L: int, max_dur: int) -> int:
    """The dynamic shared memory of kernel ``name`` (a key of ``KINDS``) at
    this shape in bytes; 0: it does not take this ``(L, Dmax)``."""
    return _library().seg_smem_bytes(KINDS[name], L, max_dur)


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
            "block's shared memory (232448 bytes; L <= 205 at Dmax = 16), "
            "the gradient kernel L <= 144")
    return B, T, L, Dmax


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def segmental_forward_cuda(frame, trans, bias, lengths, mean_pool=True):
    """K9 on the card: ``(alphas (B, T, L), logZ (B,))``, as
    :func:`segmental_forward_plain` returns."""
    B, T, L, Dmax = _check("segmental_forward", frame, trans, bias, lengths)
    dev = frame.device
    alphas = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    logZ = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        tmax, P = forward_factors(trans)    # referenced until the launch
        invd = pool_weights(Dmax, mean_pool, dev)
        with torch.cuda.device(dev):
            code = _library().seg_forward(
                frame.data_ptr(), P.data_ptr(), tmax.data_ptr(),
                bias.data_ptr(), invd.data_ptr(), lengths.data_ptr(),
                alphas.data_ptr(), logZ.data_ptr(), B, T, L, Dmax,
                _stream(dev))
        _build.raise_on_error(code, "segmental forward launch")
        launches["segmental_forward"] += 1
    return alphas, logZ


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
        invd = pool_weights(Dmax, mean_pool, dev)
        with torch.cuda.device(dev):
            code = _library().seg_viterbi(
                frame.data_ptr(), trans.data_ptr(), bias.data_ptr(),
                invd.data_ptr(), lengths.data_ptr(), deltas.data_ptr(),
                arg_d.data_ptr(), scores.data_ptr(), lab0.data_ptr(), B, T,
                L, Dmax, int(beam_threshold is not None),
                float(beam_threshold or 0.0), _stream(dev))
        _build.raise_on_error(code, "segmental viterbi launch")
        launches["segmental_viterbi"] += 1
    return deltas, arg_d, lab0, scores


def segmental_backward_cuda(frame, trans, bias, lengths, mean_pool=True):
    """K10 on the card: ``betas (B, T, L)``, as
    :func:`segmental_backward_plain` returns."""
    B, T, L, Dmax = _check("segmental_backward", frame, trans, bias, lengths)
    dev = frame.device
    betas = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    if B:
        tmax_r, Pt = backward_factors(trans)
        invd = pool_weights(Dmax, mean_pool, dev)
        with torch.cuda.device(dev):
            code = _library().seg_backward(
                frame.data_ptr(), Pt.data_ptr(), tmax_r.data_ptr(),
                bias.data_ptr(), invd.data_ptr(), lengths.data_ptr(),
                betas.data_ptr(), B, T, L, Dmax, _stream(dev))
        _build.raise_on_error(code, "segmental backward launch")
        launches["segmental_backward"] += 1
    return betas


def segmental_grad_cuda(frame, trans, bias, lengths, alphas, betas, logZ, g,
                        mean_pool=True):
    """K11 on the card: ``(A, S, gd, gt)``, as :func:`segmental_grad_plain`
    returns.  Each utterance's block sums its own ``gd`` and ``gt`` and a
    second kernel adds the partials in batch order, so the result is the
    same on every run."""
    B, T, L, Dmax = _check("segmental_grad", frame, trans, bias, lengths)
    dev = frame.device
    for name, x in (("alphas", alphas), ("betas", betas)):
        _build.check_tensor(name, x, torch.float32, 3, dev)
        if tuple(x.shape) != (B, T, L):
            raise ValueError(f"{name} {tuple(x.shape)}, expected "
                             f"{(B, T, L)}")
    for name, v in (("logZ", logZ), ("g", g)):
        _build.check_tensor(name, v, torch.float32, 1, dev)
        if v.shape[0] != B:
            raise ValueError(f"{name} has {v.shape[0]} rows, expected {B}")
    A = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    S = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    gd = torch.zeros((Dmax, L), dtype=torch.float32, device=dev)
    gt = torch.zeros((L, L), dtype=torch.float32, device=dev)
    if B:
        tmax, P = forward_factors(trans)
        invd = pool_weights(Dmax, mean_pool, dev)
        gd_part = torch.empty((B, Dmax, L), dtype=torch.float32, device=dev)
        gt_part = torch.empty((B, L, L), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            code = _library().seg_grad(
                frame.data_ptr(), P.data_ptr(), tmax.data_ptr(),
                bias.data_ptr(), invd.data_ptr(), lengths.data_ptr(),
                alphas.data_ptr(), betas.data_ptr(), logZ.data_ptr(),
                g.data_ptr(), A.data_ptr(), S.data_ptr(), gd_part.data_ptr(),
                gt_part.data_ptr(), gd.data_ptr(), gt.data_ptr(), B, T, L,
                Dmax, _stream(dev))
        _build.raise_on_error(code, "segmental grad launch")
        launches["segmental_grad"] += 1
    return A, S, gd, gt


def segmental_viterbi_traceback_cuda(deltas, arg_d, trans, lab0, lengths):
    """K13 on the card: ``(end_lab, end_start)``, as
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
    end_lab = torch.empty((B, T), dtype=torch.int32, device=dev)
    end_start = torch.empty((B, T), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            code = _library().seg_traceback(
                deltas.data_ptr(), arg_d.data_ptr(), trans.data_ptr(),
                lab0.data_ptr(), lengths.data_ptr(), end_lab.data_ptr(),
                end_start.data_ptr(), B, T, L, _stream(dev))
        _build.raise_on_error(code, "segmental traceback launch")
        launches["segmental_viterbi_traceback"] += 1
    return end_lab, end_start


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _i32(t, dev):
    return t.to(device=dev, dtype=torch.int32).contiguous()


def segmental_forward(frame, trans, bias, lengths, mean_pool=True):
    """SCRF alpha pass and logZ: K9 or its plain version."""
    if kernels.use_kernel(frame):
        return segmental_forward_cuda(
            frame.contiguous(), trans.contiguous(), bias.contiguous(),
            _i32(lengths, frame.device), mean_pool)
    return segmental_forward_plain(frame, trans, bias, lengths, mean_pool)


def segmental_backward(frame, trans, bias, lengths, mean_pool=True):
    """SCRF beta pass: K10 or its plain version."""
    if kernels.use_kernel(frame):
        return segmental_backward_cuda(
            frame.contiguous(), trans.contiguous(), bias.contiguous(),
            _i32(lengths, frame.device), mean_pool)
    return segmental_backward_plain(frame, trans, bias, lengths, mean_pool)


def segmental_grad(frame, trans, bias, lengths, alphas, betas, logZ, g,
                   mean_pool=True):
    """The xi pass: K11 or its plain version."""
    if kernels.use_kernel(frame):
        return segmental_grad_cuda(
            frame.contiguous(), trans.contiguous(), bias.contiguous(),
            _i32(lengths, frame.device), alphas.contiguous(),
            betas.contiguous(), logZ.contiguous(), g.contiguous(), mean_pool)
    return segmental_grad_plain(frame, trans, bias, lengths, alphas, betas,
                                logZ, g, mean_pool)


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
