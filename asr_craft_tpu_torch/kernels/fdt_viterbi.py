"""K3: the factored Viterbi decode — CUDA kernels and their plain twin.

Counterpart of the decode half of :mod:`asr_craft_tpu.kernels.fdt_pallas`
(``build_wall`` + ``fdt_viterbi_pallas``).  The kernels are in
``csrc/fdt_viterbi.cu`` (the note there says what bounds them on the card);
this module packs the parameters, checks and launches, and holds the plain
PyTorch version the kernels are compared with:

- :func:`fdt_viterbi_wall_torch`: the plain version — planes ``[x; 1] @
  Wall^T`` (:func:`asr_craft_tpu_torch.kernels.wall.wall_planes`) then
  :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi`.
- :func:`fdt_viterbi_cuda`: the kernels (forward, then traceback).
- :func:`fdt_viterbi_wall`: the dispatch of :mod:`asr_craft_tpu_torch.kernels`
  (kernel for CUDA tensors under ``auto``; never a silent fallback).

The parameters are packed by
:func:`asr_craft_tpu_torch.kernels.wall.build_wall`.
``launches`` counts the kernel launches of each wrapper, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.kernels.wall import (SMEM_LIMIT, check_inputs,
                                              wall_planes, wall_t4)
from asr_craft_tpu_torch.ops import fdt

launches = {"fdt_viterbi_fwd": 0, "fdt_viterbi_traceback": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def fdt_viterbi_wall_torch(Wall, feats, lengths, *, u0: int, u1: int,
                           ns: int, P: int, boundaries: bool = True,
                           beam_threshold: Optional[float] = None,
                           beam_width: Optional[int] = None):
    """The plain version of :func:`fdt_viterbi_cuda`: same arguments, same
    (paths (B, T) int32 state-major, scores (B,)) results."""
    return fdt.fdt_viterbi(*wall_planes(Wall, feats, u0, u1, ns, P),
                           lengths, ns, boundaries, beam_width,
                           beam_threshold)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fdt_viterbi_fwd.argtypes = ([ptr] * 6 + [i32] * 8
                                        + [i32, f32, i32, ptr])
        lib.fdt_viterbi_fwd.restype = i32
        lib.fdt_viterbi_traceback.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.fdt_viterbi_traceback.restype = i32
        lib.fdt_viterbi_fwd_smem_bytes.argtypes = [i32] * 3
        lib.fdt_viterbi_fwd_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def viterbi_forward_cuda(Wall, feats, lengths, *, u0: int, u1: int, ns: int,
                         P: int, boundaries: bool = True,
                         beam_threshold: Optional[float] = None,
                         beam_width: Optional[int] = None):
    """Forward kernel: (bp (B, T, L') int32, last (B,) int32, scores (B,)),
    as :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_forward` returns."""
    dev = feats.device
    B, T, D = check_inputs("fdt Viterbi", Wall, feats, lengths, u0=u0,
                           u1=u1, ns=ns, P=P)
    Lp = ns * P
    if beam_width is not None and beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    lib = _library()
    smem = lib.fdt_viterbi_fwd_smem_bytes(u1 - u0, ns, P)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fdt Viterbi kernel needs {smem} B of shared "
                         f"memory, over the {SMEM_LIMIT} B a block can use")
    bw = 0 if beam_width is None or beam_width >= Lp else beam_width
    bp = torch.empty((B, T, Lp), dtype=torch.int32, device=dev)
    last = torch.empty((B,), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return bp, last, scores
    wall_t = wall_t4(Wall)          # referenced until the launch returns
    with torch.cuda.device(dev):
        code = lib.fdt_viterbi_fwd(
            wall_t.data_ptr(), feats.data_ptr(), lengths.data_ptr(),
            bp.data_ptr(), last.data_ptr(), scores.data_ptr(),
            B, T, D, u0, u1 - u0, ns, P, int(boundaries),
            int(beam_threshold is not None), float(beam_threshold or 0.0),
            bw, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(code, "fdt_viterbi_fwd launch")
    launches["fdt_viterbi_fwd"] += 1
    return bp, last, scores


def viterbi_traceback_cuda(bp, last, lengths):
    """Traceback kernel: (B, T) int32 paths, as
    :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_traceback` returns."""
    dev = bp.device
    _build.check_tensor("bp", bp, torch.int32, 3, dev)
    _build.check_tensor("last", last, torch.int32, 1, dev)
    _build.check_tensor("lengths", lengths, torch.int32, 1, dev)
    B, T, Lp = bp.shape
    if last.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("bp, last and lengths disagree on the batch size")
    paths = torch.empty((B, T), dtype=torch.int32, device=dev)
    if B == 0:
        return paths
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.fdt_viterbi_traceback(
            bp.data_ptr(), last.data_ptr(), lengths.data_ptr(),
            paths.data_ptr(), B, T, Lp,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(code, "fdt_viterbi_traceback launch")
    launches["fdt_viterbi_traceback"] += 1
    return paths


def fdt_viterbi_cuda(Wall, feats, lengths, *, u0: int, u1: int, ns: int,
                     P: int, boundaries: bool = True,
                     beam_threshold: Optional[float] = None,
                     beam_width: Optional[int] = None):
    """Factored max-plus decode on the card: (paths (B, T) int32
    state-major expanded labels, scores (B,)).  Raises on what the kernels
    do not take (CPU tensors, P > 128, wrong dtype/shape/layout)."""
    bp, last, scores = viterbi_forward_cuda(
        Wall, feats, lengths, u0=u0, u1=u1, ns=ns, P=P,
        boundaries=boundaries, beam_threshold=beam_threshold,
        beam_width=beam_width)
    return viterbi_traceback_cuda(bp, last, lengths), scores


def fdt_viterbi_wall(Wall, feats, lengths, *, u0: int, u1: int, ns: int,
                     P: int, boundaries: bool = True,
                     beam_threshold: Optional[float] = None,
                     beam_width: Optional[int] = None):
    """Dispatch by :func:`asr_craft_tpu_torch.kernels.use_kernel`: the
    kernels or :func:`fdt_viterbi_wall_torch`."""
    fn = (fdt_viterbi_cuda if kernels.use_kernel(feats)
          else fdt_viterbi_wall_torch)
    return fn(Wall, feats, lengths, u0=u0, u1=u1, ns=ns, P=P,
              boundaries=boundaries, beam_threshold=beam_threshold,
              beam_width=beam_width)
