"""K3: the factored Viterbi decode — CUDA kernels and their plain twin.

Counterpart of the decode half of :mod:`asr_craft_tpu.kernels.fdt_pallas`
(``build_wall`` + ``fdt_viterbi_pallas``).  The kernels are in
``csrc/fdt_viterbi.cu`` (the note there says what bounds them on the card);
this module packs the parameters, checks and launches, and holds the plain
PyTorch version the kernels are compared with:

- :func:`build_wall`: plain gathers into the state-major ``Wall (R, Du+1)``
  with rows ``[state L' | self L' | adv L' | cross P^2]`` and the bias in
  the last column (no TPU padding).
- :func:`fdt_viterbi_wall_torch`: the plain version — planes ``[x; 1] @
  Wall^T`` then :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi`.
- :func:`fdt_viterbi_cuda`: the kernels (forward, then traceback).
- :func:`fdt_viterbi_wall`: the dispatch of :mod:`asr_craft_tpu_torch.kernels`
  (kernel for CUDA tensors under ``auto``; never a silent fallback).

``launches`` counts the kernel launches of each wrapper, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.ops import fdt

MAX_LABELS = 128          # phone cap of the kernel path, as in JAX
SMEM_LIMIT = 232448       # bytes of shared memory a Hopper block may opt into

launches = {"fdt_viterbi_fwd": 0, "fdt_viterbi_traceback": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build_wall(params: dict, fmap_cfg, ns: int):
    """Pack the canonical parameters into ``Wall (R, Du+1)``.

    ``R = 3 L' + P^2``; row blocks state | self | adv | cross (pi-major,
    ``pi * P + pj``), all state-major; columns are the input dims
    ``[u0, u1)`` covering both feature ranges, then the bias.  Returns
    ``(Wall, u0, u1, {"P": P, "ns": ns})``.
    """
    Lp = fmap_cfg.num_expanded
    P = Lp // ns
    s0, s1 = fmap_cfg.state_range
    t0, t1 = fmap_cfg.trans_range
    u0, u1 = min(s0, t0), max(s1, t1)
    Du = u1 - u0
    w_state = params["w_state"]
    dev = w_state.device

    def rows(w, b, lo, hi):
        """(hi - lo, n) weights + (n,) bias -> (n, Du + 1) rows."""
        out = torch.zeros((w.shape[1], Du + 1), dtype=torch.float32,
                          device=dev)
        out[:, lo - u0:hi - u0] = w.T
        out[:, Du] = b
        return out

    zb = torch.zeros((Lp,), dtype=torch.float32, device=dev)
    b_state = params.get("b_state", zb) if fmap_cfg.use_state_bias else zb
    w_self, b_self, w_adv, b_adv, w_cross, b_cross = \
        fdt.factored_trans_weights(params, Lp, ns)
    Wall = torch.cat([
        rows(w_state, b_state, s0, s1),
        rows(w_self, b_self, t0, t1),
        rows(w_adv, b_adv, t0, t1),
        rows(w_cross.reshape(w_cross.shape[0], P * P),
             b_cross.reshape(P * P), t0, t1),
    ])
    return Wall, u0, u1, {"P": P, "ns": ns}


def wall_planes(Wall, feats, u0: int, u1: int, ns: int, P: int):
    """The factored planes ``[x; 1] @ Wall^T`` as
    ``(state, selfp, advp, crossp)``, shaped as ``ops.fdt.factored_planes``
    returns them (``selfp``/``advp`` None for ``ns == 1``)."""
    B, T, _ = feats.shape
    Lp = ns * P
    xu = torch.cat([feats[..., u0:u1],
                    torch.ones((B, T, 1), dtype=feats.dtype,
                               device=feats.device)], dim=-1)
    plane = xu @ Wall.T                                     # (B, T, R)
    state = plane[..., :Lp]
    crossp = plane[..., 3 * Lp:].reshape(B, T, P, P)
    if ns == 1:
        return state, None, None, crossp
    return state, plane[..., Lp:2 * Lp], plane[..., 2 * Lp:3 * Lp], crossp


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
        lib.fdt_cuda_error_string.argtypes = [i32]
        lib.fdt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on_error(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.fdt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _check(name: str, t, dtype, ndim: int, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor for the kernel "
                         f"(got {t.device}); use the 'torch' backend on CPU")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D {dtype}, got "
                         f"{t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def viterbi_forward_cuda(Wall, feats, lengths, *, u0: int, u1: int, ns: int,
                         P: int, boundaries: bool = True,
                         beam_threshold: Optional[float] = None,
                         beam_width: Optional[int] = None):
    """Forward kernel: (bp (B, T, L') int32, last (B,) int32, scores (B,)),
    as :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_forward` returns."""
    dev = feats.device
    _check("feats", feats, torch.float32, 3, dev)
    _check("Wall", Wall, torch.float32, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    B, T, D = feats.shape
    Lp = ns * P
    if P > MAX_LABELS:
        raise ValueError(f"the fdt Viterbi kernel supports P <= "
                         f"{MAX_LABELS} phones, got {P}")
    if not 0 <= u0 <= u1 <= D:
        raise ValueError(f"feature range [{u0}, {u1}) outside [0, {D}]")
    if tuple(Wall.shape) != (3 * Lp + P * P, u1 - u0 + 1):
        raise ValueError(f"Wall shape {tuple(Wall.shape)} does not match "
                         f"ns={ns}, P={P}, Du={u1 - u0}")
    if tuple(lengths.shape) != (B,) or T < 1:
        raise ValueError(f"lengths {tuple(lengths.shape)} vs feats "
                         f"{tuple(feats.shape)}")
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
    # (Du+1, R4): transposed for coalesced reads of 4-row groups
    R = Wall.shape[0]
    wall_t = torch.zeros((u1 - u0 + 1, (R + 3) // 4 * 4),
                         dtype=torch.float32, device=dev)
    wall_t[:, :R] = Wall.T
    with torch.cuda.device(dev):
        code = lib.fdt_viterbi_fwd(
            wall_t.data_ptr(), feats.data_ptr(), lengths.data_ptr(),
            bp.data_ptr(), last.data_ptr(), scores.data_ptr(),
            B, T, D, u0, u1 - u0, ns, P, int(boundaries),
            int(beam_threshold is not None), float(beam_threshold or 0.0),
            bw, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(lib, code, "fdt_viterbi_fwd launch")
    launches["fdt_viterbi_fwd"] += 1
    return bp, last, scores


def viterbi_traceback_cuda(bp, last, lengths):
    """Traceback kernel: (B, T) int32 paths, as
    :func:`asr_craft_tpu_torch.ops.fdt.fdt_viterbi_traceback` returns."""
    dev = bp.device
    _check("bp", bp, torch.int32, 3, dev)
    _check("last", last, torch.int32, 1, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
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
    _raise_on_error(lib, code, "fdt_viterbi_traceback launch")
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
