"""K7 and K8: the shared-transition Viterbi decode — CUDA kernels and their
plain twin.

Counterpart of :mod:`asr_craft_tpu.kernels.viterbi_pallas`
(``viterbi_pallas``, ``viterbi_pallas_nstate``).  The forward kernels are in
``csrc/viterbi.cu`` (the note there says what bounds them on the card and
how their frame is laid out); the traceback is the K3 kernel of
``csrc/fdt_viterbi.cu``, which follows the same ``bp (B, T, L)`` layout.
This module checks and launches, and holds what the kernels are compared
with:

- :func:`asr_craft_tpu_torch.ops.viterbi.viterbi_batch`: the plain version
  of both kernels (the n-state one is held to it on the dense masked trans).
- :func:`viterbi_dense_fwd` (K7), :func:`viterbi_nstate_fwd` (K8) and
  :func:`viterbi_traceback`: the kernels.
- :func:`dense_frame`, :func:`nstate_frame`: the layout each kernel takes
  at a width, chosen here at launch (never on failure).
- :func:`factored_weights`: the legal transitions K8 reads from trans.
- :func:`viterbi_shared`: the decode's dispatch, K8 or K7 then the
  traceback for CUDA tensors under ``auto`` (never a silent fallback), the
  plain version for CPU tensors.

Each wrapper counts its launches in the counter ``kernels.<kernel>`` of
:mod:`asr_craft_tpu_torch.utils.diagnostics`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build, fdt_viterbi
from asr_craft_tpu_torch.kernels.wall import MAX_LABELS, SMEM_LIMIT
from asr_craft_tpu_torch.ops import viterbi as ops_viterbi
from asr_craft_tpu_torch.ops.fdt import prune
from asr_craft_tpu_torch.ops.semiring import NEG_INF
from asr_craft_tpu_torch.utils import diagnostics

# The frame's layouts (csrc/viterbi.cu): a group of four lanes owns a
# destination (K7) or a phone (K8), and a lane holds a contiguous quarter of
# 4 QV of the weights that reach it (QV odd, so a quarter-warp's 16-byte
# loads fall on distinct banks): K7's column of trans in registers while it
# fits (L <= 48, 80, 144), else in shared memory (QV = 15, L <= 232), and
# above that the wide kernel (the first frame, trans from L2); K8's cross
# column in registers (P <= 48, 80, 128) with two states a lane at most.
REG_QV = (3, 5, 9)
DENSE_SHARED_QV = 15
DENSE_MAX_L = 232
NSTATE_MAX_STATES = 8

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = fdt_viterbi._library()       # one library: csrc/*.cu
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.viterbi_dense_fwd.argtypes = ([ptr] * 6 + [i32] * 4
                                          + [f32] + [i32] * 3 + [ptr])
        lib.viterbi_dense_fwd.restype = i32
        lib.viterbi_nstate_fwd.argtypes = ([ptr] * 6 + [i32] * 5
                                           + [f32] + [i32] * 2 + [ptr])
        lib.viterbi_nstate_fwd.restype = i32
        lib.viterbi_dense_smem_bytes.argtypes = [i32] * 3
        lib.viterbi_dense_smem_bytes.restype = ctypes.c_size_t
        lib.viterbi_nstate_smem_bytes.argtypes = [i32] * 3
        lib.viterbi_nstate_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def dense_frame(L: int):
    """``(QV, shared)``: K7's layout at width ``L``, template parameters of
    its kernel: the smallest register layout whose quarters ``4 QV`` cover
    a quarter of the predecessors, else the shared-memory one; None above
    ``DENSE_MAX_L``, where the wide kernel runs."""
    if not 1 <= L <= DENSE_MAX_L:
        return None
    qv = next((q for q in REG_QV if 16 * q >= L), None)
    return (qv, False) if qv else (DENSE_SHARED_QV, True)


def nstate_frame(P: int, ns: int):
    """K8's ``QV`` at ``P`` phones of ``ns`` states: the cross column's
    quarters in registers; None where K8 does not take them (``P >
    MAX_LABELS`` or ``ns`` outside ``2 ... NSTATE_MAX_STATES``)."""
    if not (1 <= P <= MAX_LABELS and 2 <= ns <= NSTATE_MAX_STATES):
        return None
    return next(q for q in REG_QV if 16 * q >= P)


def factored_weights(trans, P: int, ns: int):
    """The legal transitions of a topology-masked ``trans (L', L')``,
    state-major (``l = q * ns + s``): ``w_self (L',)`` = ``trans[l, l]``,
    ``w_adv (L',)`` = ``trans[l - 1, l]`` for ``s > 0`` (NEG_INF at
    ``s = 0``) and ``w_cross (P, P)`` = ``trans[q' * ns + ns - 1, q * ns]``:
    the entries K8 reads from trans.  The JAX ``_factored_weights`` without
    the TPU's plane-major relayout."""
    lab = torch.arange(ns * P, device=trans.device)
    w_self = trans[lab, lab]
    w_adv = torch.where(lab % ns > 0, trans[(lab - 1).clamp(min=0), lab],
                        NEG_INF)
    q = torch.arange(P, device=trans.device)
    w_cross = trans[(q * ns + ns - 1)[:, None], (q * ns)[None, :]]
    return (w_self.contiguous(), w_adv.contiguous(), w_cross.contiguous())


def nstate_rescans(state, trans, lengths, ns: int,
                   beam_threshold: Optional[float] = None,
                   beam_width: Optional[int] = None) -> int:
    """The dead destinations K8 re-scans over all L' predecessors on these
    inputs: at each frame ``1 <= t < length``, the states whose best legal
    predecessor (self, advance, cross) is at or below NEG_INF / 2.  The
    work ``utils.roofline`` counts for it; the plain forward's own loop."""
    B, T, L = state.shape
    P = L // ns
    w_self, w_adv, w_cross = factored_weights(trans, P, ns)
    first = torch.arange(L, device=state.device) % ns == 0
    lengths = lengths.to(state.device)
    delta = prune(state[:, 0], beam_threshold, beam_width)
    dead = torch.zeros((), dtype=torch.int64, device=state.device)
    for t in range(1, T):
        cross = (delta[:, ns - 1::ns, None] + w_cross).amax(1)      # (B, P)
        inner = torch.where(first, cross.repeat_interleave(ns, 1),
                            torch.roll(delta, 1, 1) + w_adv)
        legal = torch.maximum(delta + w_self, inner)
        valid = (t < lengths)[:, None]
        dead += (valid & ~(legal > 0.5 * NEG_INF)).sum()
        best = (delta[:, :, None] + trans).amax(1)
        delta = torch.where(valid, prune(best + state[:, t], beam_threshold,
                                         beam_width), delta)
    return int(dead)


def _check(state, trans, lengths, beam_width):
    """Validate what both forward kernels take; returns (B, T, L, bw)
    with ``bw = 0`` for no top-k."""
    dev = state.device
    _build.check_tensor("state", state, torch.float32, 3, dev)
    _build.check_tensor("trans", trans, torch.float32, 2, dev)
    _build.check_tensor("lengths", lengths, torch.int32, 1, dev)
    B, T, L = state.shape
    if tuple(trans.shape) != (L, L):
        raise ValueError(f"trans {tuple(trans.shape)} is not ({L}, {L}): "
                         "the kernels take one shared transition matrix")
    if tuple(lengths.shape) != (B,) or T < 1:
        raise ValueError(f"lengths {tuple(lengths.shape)} vs state "
                         f"{tuple(state.shape)}")
    if beam_width is not None and beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    bw = 0 if beam_width is None or beam_width >= L else beam_width
    return B, T, L, bw


def _outputs(B, T, L, dev):
    return (torch.empty((B, T, L), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.float32, device=dev))


def viterbi_dense_fwd(state, trans, lengths,
                      beam_threshold: Optional[float] = None,
                      beam_width: Optional[int] = None):
    """K7 forward on the card: (bp (B, T, L) int32, last (B,) int32,
    scores (B,)), as :func:`asr_craft_tpu_torch.ops.viterbi.viterbi_forward`
    returns them.  Any L: the frame's layout (:func:`dense_frame`) up to
    L = 232, the wide kernel above."""
    B, T, L, bw = _check(state, trans, lengths, beam_width)
    qv, shared = dense_frame(L) or (0, False)
    lib = _library()
    smem = lib.viterbi_dense_smem_bytes(L, qv, int(shared))
    if not 0 < smem <= SMEM_LIMIT:
        raise ValueError(f"dense Viterbi kernel needs {smem} B of shared "
                         f"memory at L = {L}, over the {SMEM_LIMIT} B a "
                         "block can use")
    bp, last, scores = _outputs(B, T, L, state.device)
    if B == 0:
        return bp, last, scores
    with torch.cuda.device(state.device):
        code = lib.viterbi_dense_fwd(
            state.data_ptr(), trans.data_ptr(), lengths.data_ptr(),
            bp.data_ptr(), last.data_ptr(), scores.data_ptr(), B, T, L,
            int(beam_threshold is not None), float(beam_threshold or 0.0),
            bw, qv, int(shared),
            torch.cuda.current_stream(state.device).cuda_stream)
    _build.raise_on_error(code, "viterbi_dense_fwd launch")
    diagnostics.count("kernels.viterbi_dense_fwd")
    return bp, last, scores


def viterbi_nstate_fwd(state, trans, lengths, ns: int,
                       beam_threshold: Optional[float] = None,
                       beam_width: Optional[int] = None):
    """K8 forward on the card, for ``2 <= ns <= 8`` states per phone and
    P <= 128 phones: the outputs of :func:`viterbi_dense_fwd`, equal to
    the dense plain version's on a topology-masked ``trans``."""
    B, T, L, bw = _check(state, trans, lengths, beam_width)
    P = L // ns
    if not 2 <= ns <= NSTATE_MAX_STATES or P * ns != L:
        raise ValueError(f"the n-state kernel needs ns >= 2 dividing "
                         f"L' = {L}, at most {NSTATE_MAX_STATES}, got "
                         f"ns = {ns}")
    if P > MAX_LABELS:
        raise ValueError(f"the n-state kernel supports P <= {MAX_LABELS} "
                         f"phones, got {P}")
    qv = nstate_frame(P, ns)
    lib = _library()
    smem = lib.viterbi_nstate_smem_bytes(ns, P, qv)
    if not 0 < smem <= SMEM_LIMIT:
        raise ValueError(f"n-state Viterbi kernel needs {smem} B of shared "
                         f"memory, over the {SMEM_LIMIT} B a block can use")
    bp, last, scores = _outputs(B, T, L, state.device)
    if B == 0:
        return bp, last, scores
    with torch.cuda.device(state.device):
        code = lib.viterbi_nstate_fwd(
            state.data_ptr(), trans.data_ptr(), lengths.data_ptr(),
            bp.data_ptr(), last.data_ptr(), scores.data_ptr(), B, T, ns, P,
            int(beam_threshold is not None), float(beam_threshold or 0.0),
            bw, qv, torch.cuda.current_stream(state.device).cuda_stream)
    _build.raise_on_error(code, "viterbi_nstate_fwd launch")
    diagnostics.count("kernels.viterbi_nstate_fwd")
    return bp, last, scores


def viterbi_traceback(bp, last, lengths):
    """The traceback kernel (K3's, ``fdt_vit_tb_kernel``) on a shared-
    transition forward's backpointers: (B, T) int32 paths, as
    :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_traceback` returns."""
    return fdt_viterbi.launch_traceback(bp, last, lengths,
                                        "kernels.viterbi_traceback")


def viterbi_shared(state, trans, lengths, ns: int = 1,
                   beam_threshold: Optional[float] = None,
                   beam_width: Optional[int] = None):
    """(paths (B, T) int32, scores (B,)) over a shared ``trans`` with ``ns``
    states per phone.  By :func:`asr_craft_tpu_torch.kernels.use_kernel`:
    K8 (``2 <= ns <= 8``, at most ``MAX_LABELS`` phones:
    :func:`nstate_frame`) or K7, then the traceback kernel; or
    :func:`asr_craft_tpu_torch.ops.viterbi.viterbi_batch`.  The JAX
    ``models.crf.decode`` routes between its kernels the same way (it
    takes K8 for any ``ns > 1``)."""
    if not kernels.use_kernel(state):
        return ops_viterbi.viterbi_batch(state, trans, lengths, beam_width,
                                         beam_threshold)
    if ns > 1 and nstate_frame(state.shape[-1] // ns, ns) is not None:
        bp, last, scores = viterbi_nstate_fwd(state, trans, lengths, ns,
                                              beam_threshold, beam_width)
    else:
        bp, last, scores = viterbi_dense_fwd(state, trans, lengths,
                                             beam_threshold, beam_width)
    return viterbi_traceback(bp, last, lengths), scores
