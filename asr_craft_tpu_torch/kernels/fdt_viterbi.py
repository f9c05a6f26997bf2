"""K3: the factored Viterbi decode — CUDA kernels and their plain twin.

Counterpart of the decode half of :mod:`asr_craft_tpu.kernels.fdt_pallas`
(``build_wall`` + ``fdt_viterbi_pallas``).  The kernels are the plane
kernel (``csrc/fdt_mma.cu``, shared with training, launched through
:func:`asr_craft_tpu_torch.kernels.fdt_train.fdt_planes_cuda` and counted
here as ``kernels.fdt_viterbi_plane[<design>]``), then the recursion and
the traceback (``csrc/fdt_viterbi.cu``; the notes there say what bounds
them on the card).  This module checks and launches them, and holds the
plain PyTorch versions the kernels are compared with:

- :func:`fdt_viterbi_planes_torch`: the plain version of the recursion and
  the traceback on given plane rows (:func:`asr_craft_tpu_torch.ops.fdt.
  fdt_viterbi` on their blocks), and :func:`fdt_viterbi_wall_torch`, the
  planes ``[x; 1] @ Wall^T`` followed by it.
- :func:`fdt_viterbi_cuda`: the kernels (planes and recursion over
  sub-batches of at most ``PLANE_BUDGET`` bytes of planes, then the
  traceback).  The recursion takes one of two designs by
  :func:`recursion_path` (a cluster of two blocks an utterance, or one
  block an utterance), counted in ``kernels.fdt_viterbi_fwd[<path>]``.
- :func:`fdt_viterbi_wall`: the dispatch of :mod:`asr_craft_tpu_torch.kernels`
  (kernel for CUDA tensors under ``auto``; never a silent fallback).

The parameters are packed by
:func:`asr_craft_tpu_torch.kernels.wall.build_wall`.
Each wrapper counts its launches in the counter ``kernels.<kernel>[...]``
of :mod:`asr_craft_tpu_torch.utils.diagnostics`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.kernels.fdt_train import (fdt_planes_cuda,
                                                   fdt_planes_torch)
from asr_craft_tpu_torch.kernels.wall import (MAX_LABELS, SMEM_LIMIT,
                                              check_inputs, plane_blocks)
from asr_craft_tpu_torch.ops import fdt
from asr_craft_tpu_torch.utils import diagnostics

# The tracebacks' stream (csrc/fdt_common.cuh; K13 shares it): a ring of
# TB_RING shared-memory slots, each a block of C frames of rows, C as many
# as fill TB_SLOT_BYTES, at most TB_MAX_FRAMES, fewer where the block would
# pass SMEM_LIMIT.
TB_RING, TB_MAX_FRAMES, TB_SLOT_BYTES = 3, 128, 32768
# The most bytes of planes a decode holds at once: the batch is decoded in
# sub-batches of utterances whose (b, T, R4) planes fit (191 utterances at
# the flagship's T = 512, R4 = 2736), at least one at a time.
PLANE_BUDGET = 1 << 30
# The plane rows in flight in the recursion's ring (fewer where a block's
# shared memory would pass SMEM_LIMIT).
VIT_RING = 8

_lib = None


def fdt_viterbi_planes_torch(planes, lengths, *, ns: int, P: int,
                             boundaries: bool = True,
                             beam_threshold: Optional[float] = None,
                             beam_width: Optional[int] = None):
    """The plain version of the recursion and the traceback on plane rows
    ``(B, T, >= R)`` (columns past R ignored): (paths (B, T) int32
    state-major, scores (B,))."""
    return fdt.fdt_viterbi(*plane_blocks(planes, ns, P), lengths, ns,
                           boundaries, beam_width, beam_threshold)


def fdt_viterbi_wall_torch(Wall, feats, lengths, *, u0: int, u1: int,
                           ns: int, P: int, boundaries: bool = True,
                           beam_threshold: Optional[float] = None,
                           beam_width: Optional[int] = None,
                           precision: str = "highest"):
    """The plain version of :func:`fdt_viterbi_cuda`: the planes of
    :func:`asr_craft_tpu_torch.kernels.fdt_train.fdt_planes_torch`, then
    :func:`fdt_viterbi_planes_torch`; same arguments, same (paths (B, T)
    int32 state-major, scores (B,)) results."""
    return fdt_viterbi_planes_torch(
        fdt_planes_torch(Wall, feats, u0=u0, u1=u1, precision=precision),
        lengths, ns=ns, P=P, boundaries=boundaries,
        beam_threshold=beam_threshold, beam_width=beam_width)


def stream_bytes(C: int, row: int, streams: int, extra: int) -> int:
    """The shared memory of a traceback block: the ring of ``streams``
    arrays of ``row`` 4-byte elements a frame, C frames a slot (each slot
    with room for a block's 16-byte alignment offset), ``extra`` bytes and
    the ring's barriers (``tb_bytes``)."""
    slot = (C * row + 3 + 3) // 4 * 4
    return 4 * TB_RING * streams * slot + extra + 16 * TB_RING


def stream_frames(row: int, streams: int, extra: int) -> int:
    """The frames C of a stream block (``tb_frames``); 0 where one frame
    does not fit a block's shared memory."""
    C = max(1, min(TB_MAX_FRAMES, TB_SLOT_BYTES // (4 * row * streams)))
    while C >= 1 and stream_bytes(C, row, streams, extra) > SMEM_LIMIT:
        C -= 1
    return C


def traceback_frames(Lp: int) -> int:
    """The frames C of the traceback's stream blocks at L' = ``Lp`` (the
    kernel's ``fdt_viterbi_traceback_frames``; its labels take
    ``TB_MAX_FRAMES`` ints beside the ring); 0 where one frame does not
    fit."""
    return stream_frames(Lp, 1, 4 * TB_MAX_FRAMES)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fdt_viterbi_fwd.argtypes = ([ptr] * 5 + [i32] * 5
                                        + [i32, f32] + [i32] * 3 + [ptr])
        lib.fdt_viterbi_fwd.restype = i32
        lib.fdt_viterbi_traceback.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.fdt_viterbi_traceback.restype = i32
        lib.fdt_viterbi_traceback_frames.argtypes = [i32]
        lib.fdt_viterbi_traceback_frames.restype = i32
        lib.fdt_viterbi_fwd_smem_bytes.argtypes = [i32] * 4
        lib.fdt_viterbi_fwd_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def sub_batches(B: int, T: int, R: int, budget: int):
    """``(start, stop)`` of the sub-batches a decode of B utterances runs:
    as many utterances as keep their (b, T, R4) fp32 planes within
    ``budget`` bytes, at least one."""
    per = max(1, budget // (4 * T * ((R + 3) // 4 * 4)))
    return [(s, min(s + per, B)) for s in range(0, B, per)]


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def recursion_path(B: int, device, *, beams: bool = False) -> str:
    """The design the recursion takes for B utterances on ``device``:
    ``"cluster"`` (a cluster of two blocks an utterance, each half of its
    destination phones, the plane rows multicast to both) where the decode
    is exact and its 2 B blocks run at once, at most two an SM (B up to the
    SM count: faster than one block an utterance at B = 64-132 on an H100,
    slower at 160 and 191, whose clusters take two waves); else
    ``"block"``, one block an utterance (a beam's pruning reads the whole
    row of every frame)."""
    if beams or B > _sm_count(torch.device(device)):
        return "block"
    return "cluster"


def forward_stages(lib, ns: int, P: int, path: str) -> int:
    """The plane rows the recursion's ring holds: ``VIT_RING``, fewer where
    a block's shared memory would pass ``SMEM_LIMIT``; 0 where two rows do
    not fit."""
    cluster = 2 if path == "cluster" else 1
    for stages in range(VIT_RING, 1, -1):
        if lib.fdt_viterbi_fwd_smem_bytes(ns, P, stages,
                                          cluster) <= SMEM_LIMIT:
            return stages
    return 0


def viterbi_forward_planes_cuda(planes, lengths, bp, last, scores, *,
                                ns: int, P: int, boundaries: bool = True,
                                beam_threshold: Optional[float] = None,
                                beam_width: Optional[int] = None):
    """The recursion kernel on every frame's plane row (the plane kernel's
    (B, T, R4) layout): writes ``bp (B, T, L')`` int32, ``last (B,)`` int32
    and ``scores (B,)`` (contiguous, on the planes' device; a sub-batch's
    rows of the decode's outputs), as
    :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_forward` returns them.
    Takes the design :func:`recursion_path` chooses and counts the launch
    in the diagnostics counter ``kernels.fdt_viterbi_fwd[<path>]``."""
    dev = planes.device
    _build.check_tensor("planes", planes, torch.float32, 3, dev)
    _build.check_tensor("lengths", lengths, torch.int32, 1, dev)
    B, T, R4 = planes.shape
    Lp = ns * P
    if P > MAX_LABELS:
        raise ValueError(f"the fdt Viterbi kernel supports P <= "
                         f"{MAX_LABELS} phones, got {P}")
    if R4 != (3 * Lp + P * P + 3) // 4 * 4 or tuple(lengths.shape) != (B,):
        raise ValueError(f"planes {tuple(planes.shape)} and lengths "
                         f"{tuple(lengths.shape)} do not match ns={ns}, "
                         f"P={P}")
    for name, t, dtype, shape in (("bp", bp, torch.int32, (B, T, Lp)),
                                  ("last", last, torch.int32, (B,)),
                                  ("scores", scores, torch.float32, (B,))):
        _build.check_tensor(name, t, dtype, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, expected {shape}")
    if beam_width is not None and beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    bw = 0 if beam_width is None or beam_width >= Lp else beam_width
    lib = _library()
    path = recursion_path(B, dev, beams=beam_threshold is not None or bw > 0)
    stages = forward_stages(lib, ns, P, path)
    if not stages:
        smem = lib.fdt_viterbi_fwd_smem_bytes(
            ns, P, 2, 2 if path == "cluster" else 1)
        raise ValueError(f"fdt Viterbi kernel needs {smem} B of shared "
                         f"memory, over the {SMEM_LIMIT} B a block can use")
    if B == 0:
        return
    with torch.cuda.device(dev):
        code = lib.fdt_viterbi_fwd(
            planes.data_ptr(), lengths.data_ptr(), bp.data_ptr(),
            last.data_ptr(), scores.data_ptr(), B, T, ns, P,
            int(boundaries), int(beam_threshold is not None),
            float(beam_threshold or 0.0), bw, stages,
            2 if path == "cluster" else 1,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(code, "fdt_viterbi_fwd launch")
    diagnostics.count(f"kernels.fdt_viterbi_fwd[{path}]")


def viterbi_forward_cuda(Wall, feats, lengths, *, u0: int, u1: int, ns: int,
                         P: int, boundaries: bool = True,
                         beam_threshold: Optional[float] = None,
                         beam_width: Optional[int] = None,
                         precision: str = "highest"):
    """The plane kernel (its products in ``precision``) and the recursion
    kernel: (bp (B, T, L') int32, last
    (B,) int32, scores (B,)), as
    :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_forward` returns them.
    The utterances run in :func:`sub_batches` of at most ``PLANE_BUDGET``
    bytes of planes, each sub-batch's planes formed and read before the
    next's; utterances are independent, so the results are those of one
    call."""
    dev = feats.device
    B, T, D = check_inputs("fdt Viterbi", Wall, feats, lengths, u0=u0,
                           u1=u1, ns=ns, P=P)
    if beam_width is not None and beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    Lp = ns * P
    bp = torch.empty((B, T, Lp), dtype=torch.int32, device=dev)
    last = torch.empty((B,), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    for s, e in sub_batches(B, T, Wall.shape[0], PLANE_BUDGET):
        planes = fdt_planes_cuda(Wall, feats[s:e], u0=u0, u1=u1,
                                 key="kernels.fdt_viterbi_plane",
                                 precision=precision)
        viterbi_forward_planes_cuda(
            planes, lengths[s:e], bp[s:e], last[s:e], scores[s:e], ns=ns,
            P=P, boundaries=boundaries, beam_threshold=beam_threshold,
            beam_width=beam_width)
    return bp, last, scores


def launch_traceback(bp, last, lengths, key: str):
    """Launch the traceback kernel (one block an utterance, its rows
    streamed through shared memory in blocks of :func:`traceback_frames`
    frames): (B, T) int32 paths, as
    :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_traceback` returns on
    labels clamped into ``[0, L')``.  Each decode counts its launches in
    its own diagnostics counter ``key`` (here and in
    ``kernels/viterbi.py``)."""
    dev = bp.device
    _build.check_tensor("bp", bp, torch.int32, 3, dev)
    _build.check_tensor("last", last, torch.int32, 1, dev)
    _build.check_tensor("lengths", lengths, torch.int32, 1, dev)
    B, T, Lp = bp.shape
    if last.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("bp, last and lengths disagree on the batch size")
    if not traceback_frames(Lp):
        raise ValueError(f"the traceback kernel's stream does not fit one "
                         f"frame of L' = {Lp} labels in the {SMEM_LIMIT} B "
                         "of shared memory a block can use")
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
    diagnostics.count(key)
    return paths


def viterbi_traceback_cuda(bp, last, lengths):
    """Traceback kernel on the fdt decode's backpointers: (B, T) int32
    paths, as :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_traceback`
    returns."""
    return launch_traceback(bp, last, lengths,
                            "kernels.fdt_viterbi_traceback")


def fdt_viterbi_cuda(Wall, feats, lengths, *, u0: int, u1: int, ns: int,
                     P: int, boundaries: bool = True,
                     beam_threshold: Optional[float] = None,
                     beam_width: Optional[int] = None,
                     precision: str = "highest"):
    """Factored max-plus decode on the card: (paths (B, T) int32
    state-major expanded labels, scores (B,)), the planes' products in
    ``precision``.  Raises on what the kernels do not take (CPU tensors,
    P > 128, wrong dtype/shape/layout)."""
    bp, last, scores = viterbi_forward_cuda(
        Wall, feats, lengths, u0=u0, u1=u1, ns=ns, P=P,
        boundaries=boundaries, beam_threshold=beam_threshold,
        beam_width=beam_width, precision=precision)
    return viterbi_traceback_cuda(bp, last, lengths), scores


def fdt_viterbi_wall(Wall, feats, lengths, *, u0: int, u1: int, ns: int,
                     P: int, boundaries: bool = True,
                     beam_threshold: Optional[float] = None,
                     beam_width: Optional[int] = None,
                     precision: str = "highest"):
    """Dispatch by :func:`asr_craft_tpu_torch.kernels.use_kernel`: the
    kernels or :func:`fdt_viterbi_wall_torch`."""
    fn = (fdt_viterbi_cuda if kernels.use_kernel(feats)
          else fdt_viterbi_wall_torch)
    return fn(Wall, feats, lengths, u0=u0, u1=u1, ns=ns, P=P,
              boundaries=boundaries, beam_threshold=beam_threshold,
              beam_width=beam_width, precision=precision)
