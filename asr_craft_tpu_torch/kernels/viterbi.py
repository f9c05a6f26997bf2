"""K7 and K8: the shared-transition Viterbi decode — CUDA kernels and their
plain twin.

Counterpart of :mod:`asr_craft_tpu.kernels.viterbi_pallas`
(``viterbi_pallas``, ``viterbi_pallas_nstate``).  The forward kernels are in
``csrc/viterbi.cu`` (the note there says what bounds them on the card); the
traceback is the K3 kernel of ``csrc/fdt_viterbi.cu``, which follows the
same ``bp (B, T, L)`` layout.  This module checks and launches, and holds
what the kernels are compared with:

- :func:`asr_craft_tpu_torch.ops.viterbi.viterbi`: the plain version of
  both kernels (the n-state one is held to it on the dense masked trans).
- :func:`viterbi_dense_fwd` (K7), :func:`viterbi_nstate_fwd` (K8) and
  :func:`viterbi_traceback`: the kernels.
- :func:`factored_weights`: the n-state kernel's legal-transition weights.
- :func:`viterbi_shared`: the decode's dispatch, K8 or K7 then the
  traceback for CUDA tensors under ``auto`` (never a silent fallback), the
  plain version for CPU tensors.

``launches`` counts the kernel launches of each wrapper, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build, fdt_viterbi
from asr_craft_tpu_torch.kernels.wall import MAX_LABELS, SMEM_LIMIT
from asr_craft_tpu_torch.ops import viterbi as ops_viterbi
from asr_craft_tpu_torch.ops.semiring import NEG_INF

launches = {"viterbi_dense_fwd": 0, "viterbi_nstate_fwd": 0,
            "viterbi_traceback": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = fdt_viterbi._library()       # one library: csrc/*.cu
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.viterbi_dense_fwd.argtypes = ([ptr] * 6 + [i32] * 4
                                          + [f32, i32, ptr])
        lib.viterbi_dense_fwd.restype = i32
        lib.viterbi_nstate_fwd.argtypes = ([ptr] * 9 + [i32] * 5
                                           + [f32, i32, ptr])
        lib.viterbi_nstate_fwd.restype = i32
        lib.viterbi_dense_smem_bytes.argtypes = [i32]
        lib.viterbi_dense_smem_bytes.restype = ctypes.c_size_t
        lib.viterbi_nstate_smem_bytes.argtypes = [i32, i32]
        lib.viterbi_nstate_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def factored_weights(trans, P: int, ns: int):
    """The legal transitions of a topology-masked ``trans (L', L')``,
    state-major (``l = q * ns + s``): ``w_self (L',)`` = ``trans[l, l]``,
    ``w_adv (L',)`` = ``trans[l - 1, l]`` for ``s > 0`` (NEG_INF at
    ``s = 0``) and ``w_cross (P, P)`` = ``trans[q' * ns + ns - 1, q * ns]``.
    The JAX ``_factored_weights`` without the TPU's plane-major relayout."""
    lab = torch.arange(ns * P, device=trans.device)
    w_self = trans[lab, lab]
    w_adv = torch.where(lab % ns > 0, trans[(lab - 1).clamp(min=0), lab],
                        NEG_INF)
    q = torch.arange(P, device=trans.device)
    w_cross = trans[(q * ns + ns - 1)[:, None], (q * ns)[None, :]]
    return (w_self.contiguous(), w_adv.contiguous(), w_cross.contiguous())


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
    returns them.  Any L (trans leaves shared memory above L = 240)."""
    B, T, L, bw = _check(state, trans, lengths, beam_width)
    lib = _library()
    smem = lib.viterbi_dense_smem_bytes(L)
    if smem > SMEM_LIMIT:
        raise ValueError(f"dense Viterbi kernel needs {smem} B of shared "
                         f"memory, over the {SMEM_LIMIT} B a block can use")
    bp, last, scores = _outputs(B, T, L, state.device)
    if B == 0:
        return bp, last, scores
    with torch.cuda.device(state.device):
        code = lib.viterbi_dense_fwd(
            state.data_ptr(), trans.data_ptr(), lengths.data_ptr(),
            bp.data_ptr(), last.data_ptr(), scores.data_ptr(), B, T, L,
            int(beam_threshold is not None), float(beam_threshold or 0.0),
            bw, torch.cuda.current_stream(state.device).cuda_stream)
    _build.raise_on_error(code, "viterbi_dense_fwd launch")
    launches["viterbi_dense_fwd"] += 1
    return bp, last, scores


def viterbi_nstate_fwd(state, trans, lengths, ns: int,
                       beam_threshold: Optional[float] = None,
                       beam_width: Optional[int] = None):
    """K8 forward on the card, for ``ns > 1`` states per phone and
    P <= 128 phones: the outputs of :func:`viterbi_dense_fwd`, equal to
    the dense plain version's on a topology-masked ``trans``."""
    B, T, L, bw = _check(state, trans, lengths, beam_width)
    P = L // ns
    if ns < 2 or P * ns != L:
        raise ValueError(f"the n-state kernel needs ns >= 2 dividing "
                         f"L' = {L}, got ns = {ns}")
    if P > MAX_LABELS:
        raise ValueError(f"the n-state kernel supports P <= {MAX_LABELS} "
                         f"phones, got {P}")
    lib = _library()
    smem = lib.viterbi_nstate_smem_bytes(ns, P)
    if smem > SMEM_LIMIT:
        raise ValueError(f"n-state Viterbi kernel needs {smem} B of shared "
                         f"memory, over the {SMEM_LIMIT} B a block can use")
    w_self, w_adv, w_cross = factored_weights(trans, P, ns)
    bp, last, scores = _outputs(B, T, L, state.device)
    if B == 0:
        return bp, last, scores
    with torch.cuda.device(state.device):
        code = lib.viterbi_nstate_fwd(
            state.data_ptr(), trans.data_ptr(), w_self.data_ptr(),
            w_adv.data_ptr(), w_cross.data_ptr(), lengths.data_ptr(),
            bp.data_ptr(), last.data_ptr(), scores.data_ptr(), B, T, ns, P,
            int(beam_threshold is not None), float(beam_threshold or 0.0),
            bw, torch.cuda.current_stream(state.device).cuda_stream)
    _build.raise_on_error(code, "viterbi_nstate_fwd launch")
    launches["viterbi_nstate_fwd"] += 1
    return bp, last, scores


def viterbi_traceback(bp, last, lengths):
    """The traceback kernel (K3's, ``fdt_vit_tb_kernel``) on a shared-
    transition forward's backpointers: (B, T) int32 paths, as
    :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_traceback` returns."""
    return fdt_viterbi.launch_traceback(bp, last, lengths, launches,
                                        "viterbi_traceback")


def viterbi_shared(state, trans, lengths, ns: int = 1,
                   beam_threshold: Optional[float] = None,
                   beam_width: Optional[int] = None):
    """(paths (B, T) int32, scores (B,)) over a shared ``trans`` with ``ns``
    states per phone.  By :func:`asr_craft_tpu_torch.kernels.use_kernel`:
    K8 (``ns > 1``, at most ``MAX_LABELS`` phones) or K7, then the
    traceback kernel; or :func:`asr_craft_tpu_torch.ops.viterbi.viterbi`.
    The JAX ``models.crf.decode`` routes between its kernels the same way."""
    if not kernels.use_kernel(state):
        return ops_viterbi.viterbi(state, trans, lengths, beam_width,
                                   beam_threshold)
    if ns > 1 and state.shape[-1] // ns <= MAX_LABELS:
        bp, last, scores = viterbi_nstate_fwd(state, trans, lengths, ns,
                                              beam_threshold, beam_width)
    else:
        bp, last, scores = viterbi_dense_fwd(state, trans, lengths,
                                             beam_threshold, beam_width)
    return viterbi_traceback(bp, last, lengths), scores
