"""K1 + K2: the factored dual-lattice forward and backward — CUDA kernels,
their plain twins, and the autograd Function that joins them.

Counterpart of the training half of :mod:`asr_craft_tpu.kernels.fdt_pallas`
(``fdt_forward_pallas``, ``fdt_backward_grad_pallas`` and the custom-VJP
core ``_fdt_core``).  The kernels are in ``csrc/fdt_train.cu`` (K1's and
K2's recursions) and ``csrc/fdt_mma.cu`` (the tensor-core products: the
planes, which K3 reads too, and K2's contraction); the notes there say what
bounds them on the card.  This module checks, launches and holds the plain
PyTorch versions the kernels are compared with:

- the planes of every frame (:func:`fdt_planes_torch` /
  :func:`fdt_planes_cuda`), ``[x; 1] @ Wall^T`` on the tensor cores, (B,
  T, R4) rows of R rounded up to 4 floats;
- K1 (:func:`fdt_forward_wall_torch` / :func:`fdt_forward_cuda`):
  ``(Wall, feats, labels, lengths) -> (alphas (B, T, 2, L'), zf, zc)``,
  the kernel path also returning the planes it read; its recursion alone
  (:func:`fdt_forward_planes_torch` / :func:`fdt_forward_planes_cuda`)
  reads the planes and forms none;
- K2 (:func:`fdt_backward_grad_wall_torch` /
  :func:`fdt_backward_grad_cuda`): ``(..., alphas, zf, zc, wf, wc) ->
  dWall (R, Du+1)`` and, with ``want_dfeats``, ``dfeats (B, T, D)``: the
  recursion (:func:`fdt_dplane_wall_torch` / :func:`fdt_dplane_cuda`), an
  explicit beta / xi / gamma recursion (not autograd of the forward, so
  the CPU tests check its arithmetic) that reads the planes and writes
  ``dplane (B, T, R)``, then the contraction (:func:`contract_wall_torch`
  / :func:`contract_cuda`) that forms ``dWall`` and ``dfeats`` from it.
- :class:`FdtNllDual`: forward K1, backward K2 with ``(gzf, gzc)`` as the
  lattice weights, the planes formed once, in the forward, and read again
  by the backward; the kernels for CUDA tensors under ``auto``, the plain
  versions for CPU tensors.
- :func:`fdt_nll_dual_wall`: the entry point ``ops.fdt.fdt_nll_dual``
  calls on the kernel path.

``Wall`` comes from :func:`asr_craft_tpu_torch.kernels.wall.build_wall`,
whose gathers autograd differentiates, so ``dWall`` flows back into the
canonical parameters.  Each wrapper counts its launches in the counter
``kernels.<kernel>[...]`` of :mod:`asr_craft_tpu_torch.utils.diagnostics`.
"""
from __future__ import annotations

import ctypes

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.kernels.wall import (MAX_LABELS, SMEM_LIMIT,
                                              check_inputs, feats_xu, wall_k4,
                                              plane_blocks)
from asr_craft_tpu_torch.ops import fdt, precision as prec
from asr_craft_tpu_torch.ops.semiring import NEG_INF
from asr_craft_tpu_torch.utils import diagnostics

# the deepest Du the plane kernel's wgmma path holds (csrc/fdt_mma.cu
# kPlaneKP)
PLANE_WGMMA_DEPTH = 144
# dWall's split of the frames: chunks of at least CONTRACT_CHUNK frames, at
# most CONTRACT_SPLITS of them
CONTRACT_SPLITS, CONTRACT_CHUNK = 16, 4096
# the deepest ring of frames K2's recursion keeps (csrc/fdt_train.cu)
BWD_RING = 8

_lib = None

def contract_splits(N: int, R: int, *, tile_rows: int, blocks: int) -> int:
    """The chunks dWall's contraction splits ``N`` frames into: enough
    blocks of ``tile_rows`` rows of dWall to give about ``blocks`` (what the
    card holds at once), each chunk at least ``CONTRACT_CHUNK`` frames, at
    most ``CONTRACT_SPLITS`` chunks (1 for a small N).  The chunk sums are
    added in chunk order, so the result does not depend on the split's
    timing."""
    tiles = -(-R // tile_rows)
    return max(1, min(CONTRACT_SPLITS, -(-blocks // tiles),
                      N // CONTRACT_CHUNK))


def fdt_planes_torch(Wall, feats, *, u0: int, u1: int,
                     precision: str = "highest"):
    """The plain version of :func:`fdt_planes_cuda`: every frame's plane
    ``[x; 1] @ Wall^T``, (B, T, R), as :func:`wall_planes` forms it, in
    ``precision`` (:func:`asr_craft_tpu_torch.ops.precision.kernel_matmul`:
    the bias column meets xu's ones as one more product term)."""
    return prec.kernel_matmul(feats_xu(feats, u0, u1), Wall.T, precision)


def _state2(state, labels, t: int, clamp_ns: int):
    """(B, 2, L') state rows of frame ``t`` for the free and the clamped
    lattice.  ``state`` is the plane's (B, T, L') state block with the
    boundary masks already folded in (``ops.fdt._boundary_state``)."""
    s = state[:, t]
    return torch.stack(
        [s, s + fdt._clamp_row(labels[:, t], s.shape[-1], clamp_ns)], dim=1)


def fdt_forward_planes_torch(planes, labels, lengths, *, ns: int, P: int,
                             clamp_ns: int, boundaries: bool = True):
    """The plain version of :func:`fdt_forward_planes_cuda`: the factored
    log-semiring loop of :mod:`asr_craft_tpu_torch.ops.fdt` on both
    lattices, over plane rows ``(B, T, >= R)`` (columns past R ignored).
    Returns ``(alphas (B, T, 2, L'), zf (B,), zc (B,))``."""
    state, selfp, advp, crossp = plane_blocks(planes, ns, P)
    B, T, Lp = state.shape
    lengths = lengths.to(state.device)
    state = fdt._boundary_state(state, lengths, ns, boundaries)
    a = _state2(state, labels, 0, clamp_ns)
    alphas = [a]
    two = lambda p: p.repeat_interleave(2, dim=0)   # one plane, 2 lattices
    for t in range(1, T):
        cand = fdt._factored_update(
            a.reshape(2 * B, Lp), two(selfp[:, t]) if ns > 1 else None,
            two(advp[:, t]) if ns > 1 else None, two(crossp[:, t]), ns)
        cand = cand.reshape(B, 2, Lp) + _state2(state, labels, t, clamp_ns)
        a = torch.where((t < lengths)[:, None, None], cand, a)
        alphas.append(a)
    z = fdt._lse(a, -1)
    return (torch.stack(alphas, dim=1), z[:, 0].contiguous(),
            z[:, 1].contiguous())


def fdt_forward_wall_torch(Wall, feats, labels, lengths, *, u0: int, u1: int,
                           ns: int, P: int, clamp_ns: int,
                           boundaries: bool = True,
                           precision: str = "highest"):
    """The plain version of :func:`fdt_forward_cuda`: the planes of
    :func:`fdt_planes_torch`, then :func:`fdt_forward_planes_torch`.
    Returns ``(alphas (B, T, 2, L'), zf (B,), zc (B,))``."""
    return fdt_forward_planes_torch(
        fdt_planes_torch(Wall, feats, u0=u0, u1=u1, precision=precision),
        labels, lengths, ns=ns, P=P, clamp_ns=clamp_ns,
        boundaries=boundaries)


def fdt_dplane_wall_torch(Wall, feats, labels, lengths, alphas, zf, zc,
                          wf, wc, *, u0: int, u1: int, ns: int, P: int,
                          clamp_ns: int, boundaries: bool = True,
                          precision: str = "highest"):
    """The plain version of :func:`fdt_dplane_cuda`: ``dplane (B, T, R)``,
    the cotangent of ``wf zf + wc zc`` on every plane row of every frame.

    Walks t down from T-1: ``x = beta_{t+1} + state2_{t+1}``; the xi of the
    self / advance / cross transitions into frame t+1; ``beta_t`` (0 where
    frame t+1 does not exist); ``gamma_t``.  Each is gated by
    ``exp(min(s - z, 40)) * w`` where the lattice is live (z > NEG_INF/2)
    and the frame exists, and the two lattices sum into one row.
    """
    B, T, _ = feats.shape
    Lp = ns * P
    R = Wall.shape[0]
    dev = feats.device
    lengths = lengths.to(dev)
    plane = fdt_planes_torch(Wall, feats, u0=u0, u1=u1, precision=precision)
    state = fdt._boundary_state(plane[..., :Lp], lengths, ns, boundaries)
    cross = plane[..., 3 * Lp:].reshape(B, T, P, P)
    st = torch.arange(Lp, device=dev) % ns
    z = torch.stack([zf, zc], dim=1)[..., None]                  # (B, 2, 1)
    w = torch.stack([wf, wc], dim=1)[..., None]
    live = z > NEG_INF * 0.5

    def gate(s, ok):
        """exp(min(s - z, 40)) * w where ``ok`` (B,) and the lattice lives;
        ``s`` (B, 2, ...)."""
        extra = (1,) * (s.dim() - 3)
        zz, ww = z.reshape(B, 2, 1, *extra), w.reshape(B, 2, 1, *extra)
        keep = (live & ok[:, None, None]).reshape(B, 2, 1, *extra)
        return torch.where(keep, torch.exp(torch.clamp(s - zz, max=40.0))
                           * ww, 0.0)

    dplane = torch.zeros((B, T, R), dtype=torch.float32, device=dev)
    beta = torch.zeros((B, 2, Lp), dtype=torch.float32, device=dev)
    for t in range(T - 1, -1, -1):
        alpha_t = alphas[:, t]
        if t < T - 1:
            n = t + 1
            valid_n = lengths > n
            x = beta + _state2(state, labels, n, clamp_ns)
            c = cross[:, n, None]                                # (B,1,P,P)
            a_last = alpha_t[..., ns - 1::ns]                    # (B, 2, P)
            x_first = x[..., 0::ns]
            xi = gate(a_last[..., :, None] + c + x_first[..., None, :],
                      valid_n)
            dplane[:, n, 3 * Lp:] = xi.sum(1).reshape(B, P * P)
            crossb = fdt._lse(x_first[..., None, :] + c, dim=-1)  # (B, 2, P)
            if ns == 1:
                nb = crossb
            else:
                f = plane[:, n, None, Lp:2 * Lp]
                a = plane[:, n, None, 2 * Lp:3 * Lp]
                x_next = torch.roll(x, -1, dims=-1)
                adv_ok = st < ns - 1
                dplane[:, n, Lp:2 * Lp] = gate(alpha_t + f + x,
                                               valid_n).sum(1)
                dplane[:, n, 2 * Lp:3 * Lp] = torch.where(
                    adv_ok, gate(alpha_t + a + x_next, valid_n), 0.0).sum(1)
                adv_c = torch.where(adv_ok, x_next + a, NEG_INF)
                cross_c = torch.where(st == ns - 1,
                                      torch.repeat_interleave(crossb, ns, -1),
                                      NEG_INF)
                nb = torch.logaddexp(x + f, torch.logaddexp(adv_c, cross_c))
            beta = torch.where(valid_n[:, None, None], nb, 0.0)
        dplane[:, t, :Lp] = gate(alpha_t + beta, lengths > t).sum(1)
    return dplane


def contract_wall_torch(dplane, src, *, mode: int, u0: int, u1: int,
                        precision: str = "highest"):
    """The plain version of :func:`contract_cuda`: mode 0 returns ``dWall
    = dplane^T @ [x; 1]`` from ``src = feats``; mode 1 returns ``dfeats``
    with ``dfeats[..., u0:u1] = dplane @ Wall[:, :Du]`` from ``src =
    (Wall, feats)``; the products in ``precision``."""
    B, T, R = dplane.shape
    if mode == 0:
        xu = feats_xu(src, u0, u1)
        return prec.kernel_matmul(dplane.reshape(B * T, R).T,
                                  xu.reshape(B * T, -1), precision)
    Wall, feats = src
    dfeats = torch.zeros_like(feats)
    dfeats[..., u0:u1] = prec.kernel_matmul(dplane, Wall[:, :u1 - u0],
                                            precision)
    return dfeats


def fdt_backward_grad_wall_torch(Wall, feats, labels, lengths, alphas, zf,
                                 zc, wf, wc, *, u0: int, u1: int, ns: int,
                                 P: int, clamp_ns: int,
                                 boundaries: bool = True,
                                 want_dfeats: bool = False,
                                 precision: str = "highest"):
    """The plain version of :func:`fdt_backward_grad_cuda`:
    :func:`fdt_dplane_wall_torch`, then ``dWall = dplane^T @ [x; 1]`` and,
    with ``want_dfeats``, ``dfeats[..., u0:u1] = dplane @ Wall[:, :Du]``.
    """
    dplane = fdt_dplane_wall_torch(
        Wall, feats, labels, lengths, alphas, zf, zc, wf, wc, u0=u0, u1=u1,
        ns=ns, P=P, clamp_ns=clamp_ns, boundaries=boundaries,
        precision=precision)
    dWall = contract_wall_torch(dplane, feats, mode=0, u0=u0, u1=u1,
                                precision=precision)
    if not want_dfeats:
        return dWall
    return dWall, contract_wall_torch(dplane, (Wall, feats), mode=1, u0=u0,
                                      u1=u1, precision=precision)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library()
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fdt_train_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.fdt_train_fwd.restype = i32
        lib.fdt_train_plane.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
        lib.fdt_train_plane.restype = i32
        lib.fdt_train_bwd.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
        lib.fdt_train_bwd.restype = i32
        lib.fdt_train_contract.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
        lib.fdt_train_contract.restype = i32
        lib.fdt_mma_tile_rows.restype = i32
        lib.fdt_mma_blocks_per_sm.restype = i32
        lib.fdt_train_fwd_smem_bytes.argtypes = [i32] * 2
        lib.fdt_train_bwd_smem_bytes.argtypes = [i32] * 3
        for name in ("fdt_train_fwd_smem_bytes", "fdt_train_bwd_smem_bytes"):
            getattr(lib, name).restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _check_train(Wall, feats, labels, lengths, *, u0, u1, ns, P, clamp_ns):
    B, T, D = check_inputs("fdt training", Wall, feats, lengths, u0=u0,
                           u1=u1, ns=ns, P=P)
    _build.check_tensor("labels", labels, torch.int32, 2, feats.device)
    if tuple(labels.shape) != (B, T):
        raise ValueError(f"labels {tuple(labels.shape)} vs feats "
                         f"{tuple(feats.shape)}")
    if clamp_ns not in (1, ns):
        raise ValueError(f"clamp_ns must be 1 or ns={ns}, got {clamp_ns}")
    return B, T, D


def _smem(lib, which: str, *dims: int) -> int:
    smem = getattr(lib, f"fdt_train_{which}_smem_bytes")(*dims)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fdt_train_{which} needs {smem} B of shared "
                         f"memory, over the {SMEM_LIMIT} B a block can use")
    return smem


def backward_stages(lib, ns: int, P: int) -> int:
    """The frames K2's ring holds (a slot: the plane row, alpha and the
    label the feeder loads, the chain's xs, cross max and beta):
    ``BWD_RING``, fewer where a block's shared memory would pass
    ``SMEM_LIMIT``; 0 where two do not fit.  At the flagship (P=48, ns=3) a
    slot is 14.8 KB, so the ring is ``BWD_RING`` deep; at P=128, ns=3 it is
    80 KB, so 2."""
    for stages in range(BWD_RING, 1, -1):
        if lib.fdt_train_bwd_smem_bytes(ns, P, stages) <= SMEM_LIMIT:
            return stages
    return 0


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_planes(planes, B: int, T: int, R: int, dev) -> None:
    _build.check_tensor("planes", planes, torch.float32, 3, dev)
    if tuple(planes.shape) != (B, T, (R + 3) // 4 * 4):
        raise ValueError(f"planes {tuple(planes.shape)}, expected "
                         f"{(B, T, (R + 3) // 4 * 4)}")


def fdt_forward_planes_cuda(planes, labels, lengths, *, ns: int, P: int,
                            clamp_ns: int, boundaries: bool = True):
    """K1's recursion kernel: ``(alphas (B, T, 2, L'), zf (B,), zc (B,))``
    from every frame's plane row in :func:`fdt_planes_cuda`'s (B, T, R4)
    layout, as :func:`fdt_forward_planes_torch` returns them.  Raises on
    what the kernel does not take (CPU tensors, P > 128, wrong
    dtype/shape/layout)."""
    dev = planes.device
    _build.check_tensor("planes", planes, torch.float32, 3, dev)
    _build.check_tensor("labels", labels, torch.int32, 2, dev)
    _build.check_tensor("lengths", lengths, torch.int32, 1, dev)
    B, T, _ = planes.shape
    if P > MAX_LABELS:
        raise ValueError(f"the fdt training kernel supports P <= "
                         f"{MAX_LABELS} phones, got {P}")
    if clamp_ns not in (1, ns):
        raise ValueError(f"clamp_ns must be 1 or ns={ns}, got {clamp_ns}")
    _check_planes(planes, B, T, 3 * ns * P + P * P, dev)
    if tuple(labels.shape) != (B, T) or tuple(lengths.shape) != (B,) \
            or T < 1:
        raise ValueError(f"labels {tuple(labels.shape)} and lengths "
                         f"{tuple(lengths.shape)} vs planes "
                         f"{tuple(planes.shape)}")
    lib = _library()
    _smem(lib, "fwd", ns, P)
    Lp = ns * P
    alphas = torch.empty((B, T, 2, Lp), dtype=torch.float32, device=dev)
    zf = torch.empty((B,), dtype=torch.float32, device=dev)
    zc = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return alphas, zf, zc
    with torch.cuda.device(dev):
        code = lib.fdt_train_fwd(
            planes.data_ptr(), labels.data_ptr(), lengths.data_ptr(),
            alphas.data_ptr(), zf.data_ptr(), zc.data_ptr(), B, T, ns, P,
            clamp_ns, int(boundaries), _stream(dev))
    _build.raise_on_error(code, "fdt_train_fwd launch")
    diagnostics.count("kernels.fdt_train_fwd")
    return alphas, zf, zc


def fdt_forward_cuda(Wall, feats, labels, lengths, *, u0: int, u1: int,
                     ns: int, P: int, clamp_ns: int, boundaries: bool = True,
                     planes=None, precision: str = "highest"):
    """K1 on the card: the plane kernel forms every frame's plane (unless
    ``planes`` are given, in its (B, T, R4) layout), then the recursion
    kernel reads them.  Returns ``(alphas (B, T, 2, L'), zf (B,), zc (B,),
    planes)``: what :func:`fdt_forward_wall_torch` returns, and the planes,
    which K2 reads again (:func:`fdt_backward_grad_cuda`).  Raises on what
    the kernels do not take (CPU tensors, P > 128, wrong
    dtype/shape/layout)."""
    _check_train(Wall, feats, labels, lengths, u0=u0, u1=u1, ns=ns, P=P,
                 clamp_ns=clamp_ns)
    if planes is None:
        planes = fdt_planes_cuda(Wall, feats, u0=u0, u1=u1,
                                 precision=precision)
    alphas, zf, zc = fdt_forward_planes_cuda(
        planes, labels, lengths, ns=ns, P=P, clamp_ns=clamp_ns,
        boundaries=boundaries)
    return alphas, zf, zc, planes


def plane_path(feats, *, u0: int, Du: int) -> str:
    """The design the plane kernel takes for these inputs: ``"wgmma"`` (a
    persistent block an SM, tiles of frames read and tiles of planes
    written by TMA, warpgroup products), which needs 16-byte aligned rows
    of ``Du`` floats (the base of ``feats``, ``D``, ``u0`` and ``Du``
    multiples of 4) and ``0 < Du <= PLANE_WGMMA_DEPTH``; else
    ``"mma_sync"``, the tiles the contraction shares."""
    D = feats.shape[-1]
    ok = (feats.data_ptr() % 16 == 0 and D % 4 == 0 and u0 % 4 == 0
          and Du % 4 == 0 and 0 < Du <= PLANE_WGMMA_DEPTH)
    return "wgmma" if ok else "mma_sync"


def fdt_planes_cuda(Wall, feats, *, u0: int, u1: int,
                    key: str = "kernels.fdt_train_plane",
                    precision: str = "highest"):
    """The plane kernel: every frame's plane ``[x; 1] @ Wall^T`` on the
    tensor cores in ``precision`` (``highest``: 3xTF32; ``bf16x3``: the
    split on the bf16 tensor cores; ``default``: one TF32 pass), as
    :func:`fdt_planes_torch` returns it, but in
    rows of R4 = R rounded up to 4 floats, (B, T, R4), the pad zero: the
    layout the recursions (K1, K2, K3) copy a frame's row from.  Counts its
    launch, with the design it took (:func:`plane_path`), in the
    diagnostics counter ``<key>[<path>]`` (the decode counts its planes as
    ``kernels.fdt_viterbi_plane``)."""
    dev = feats.device
    _build.check_tensor("feats", feats, torch.float32, 3, dev)
    _build.check_tensor("Wall", Wall, torch.float32, 2, dev)
    B, T, D = feats.shape
    R, Du = Wall.shape[0], u1 - u0
    if not 0 <= u0 <= u1 <= D or Wall.shape[1] != Du + 1:
        raise ValueError(f"Wall {tuple(Wall.shape)} and feature range "
                         f"[{u0}, {u1}) do not match feats "
                         f"{tuple(feats.shape)}")
    R4 = (R + 3) // 4 * 4
    planes = torch.empty((B, T, R4), dtype=torch.float32, device=dev)
    if B * T == 0:
        return planes
    wall_k = wall_k4(Wall)          # referenced until the launch returns
    path = plane_path(feats, u0=u0, Du=Du)
    with torch.cuda.device(dev):
        code = _library().fdt_train_plane(
            feats.data_ptr(), wall_k.data_ptr(), Wall.data_ptr(),
            planes.data_ptr(), B * T, D, u0, Du, wall_k.shape[1], R, R4,
            prec.CODES[prec.check(precision)], int(path == "wgmma"),
            _stream(dev))
    _build.raise_on_error(code, f"{key} launch")
    diagnostics.count(f"{key}[{path}]")
    return planes


def contract_cuda(dplane, src, out, *, mode: int, D: int, u0: int, Du: int,
                  precision: str = "highest"):
    """The contraction kernel, on the tensor cores in ``precision`` (as
    :func:`fdt_planes_cuda`'s): ``mode`` 0
    writes ``out (R, Du+1) = dplane^T @ [x; 1]`` from ``src = feats`` (the
    frames summed in :func:`contract_splits` chunks, then the chunks in
    order: the same result on every run); mode 1 writes ``out[..., u0:u0+Du]
    = dplane @ Wall[:, :Du]`` from ``src = Wall``."""
    dev = dplane.device
    _build.check_tensor("dplane", dplane, torch.float32, 3, dev)
    B, T, R = dplane.shape
    _build.check_tensor("src", src, torch.float32, 3 - mode, dev)
    _build.check_tensor("out", out, torch.float32, 2 + mode, dev)
    if B * T == 0:
        out.zero_()
        return out
    lib, splits = _library(), 1
    if mode == 0:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = contract_splits(B * T, R, tile_rows=lib.fdt_mma_tile_rows(),
                                 blocks=sms * lib.fdt_mma_blocks_per_sm())
    part = (torch.empty((splits, R, Du + 1), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    # mode 1 reads Wall[:, :Du] in 16-byte aligned rows
    src = wall_k4(src) if mode == 1 else src
    Dk = src.shape[1] if mode == 1 else 0
    with torch.cuda.device(dev):
        code = lib.fdt_train_contract(
            dplane.data_ptr(), src.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), mode, B * T, R, D,
            u0, Du, Dk, splits, prec.CODES[prec.check(precision)],
            _stream(dev))
    _build.raise_on_error(code, "fdt_train_contract launch")
    diagnostics.count("kernels.fdt_train_contract")
    return out


def fdt_dplane_cuda(Wall, feats, labels, lengths, alphas, zf, zc, wf, wc,
                    *, u0: int, u1: int, ns: int, P: int, clamp_ns: int,
                    boundaries: bool = True, planes=None,
                    precision: str = "highest"):
    """K2's recursion kernel: ``dplane (B, T, R)``, as
    :func:`fdt_dplane_wall_torch` returns.  It reads every frame's plane
    from ``planes`` (:func:`fdt_planes_cuda`'s (B, T, R4) layout), which
    the plane kernel forms first when none is given, through a ring of
    :func:`backward_stages` rows, and counts the launch in the diagnostics
    counter ``kernels.fdt_train_bwd[ring<stages>]``."""
    B, T, D = _check_train(Wall, feats, labels, lengths, u0=u0, u1=u1,
                           ns=ns, P=P, clamp_ns=clamp_ns)
    dev, Lp = feats.device, ns * P
    _build.check_tensor("alphas", alphas, torch.float32, 4, dev)
    if tuple(alphas.shape) != (B, T, 2, Lp):
        raise ValueError(f"alphas {tuple(alphas.shape)}, expected "
                         f"{(B, T, 2, Lp)}")
    for name, v in (("zf", zf), ("zc", zc), ("wf", wf), ("wc", wc)):
        _build.check_tensor(name, v, torch.float32, 1, dev)
        if v.shape[0] != B:
            raise ValueError(f"{name} has {v.shape[0]} rows, expected {B}")
    lib = _library()
    stages = backward_stages(lib, ns, P) or _smem(lib, "bwd", ns, P, 2)
    R = Wall.shape[0]
    if planes is None:
        planes = fdt_planes_cuda(Wall, feats, u0=u0, u1=u1,
                                 precision=precision)
    _check_planes(planes, B, T, R, dev)
    dplane = torch.empty((B, T, R), dtype=torch.float32, device=dev)
    if B:
        with torch.cuda.device(dev):
            code = lib.fdt_train_bwd(
                planes.data_ptr(), labels.data_ptr(), lengths.data_ptr(),
                alphas.data_ptr(), zf.data_ptr(), zc.data_ptr(),
                wf.data_ptr(), wc.data_ptr(), dplane.data_ptr(), B, T, ns,
                P, clamp_ns, int(boundaries), stages, _stream(dev))
        _build.raise_on_error(code, "fdt_train_bwd launch")
        diagnostics.count(f"kernels.fdt_train_bwd[ring{stages}]")
    return dplane


def fdt_backward_grad_cuda(Wall, feats, labels, lengths, alphas, zf, zc, wf,
                           wc, *, u0: int, u1: int, ns: int, P: int,
                           clamp_ns: int, boundaries: bool = True,
                           want_dfeats: bool = False, planes=None,
                           precision: str = "highest"):
    """K2 on the card: the recursion kernel reads every frame's plane
    (``planes``, as :func:`fdt_forward_cuda` returns them; the plane kernel
    forms them first when none are given) and writes ``dplane (B, T, R)``,
    then the contraction kernel forms ``dWall`` (and ``dfeats`` with
    ``want_dfeats``), as :func:`fdt_backward_grad_wall_torch` returns."""
    dplane = fdt_dplane_cuda(
        Wall, feats, labels, lengths, alphas, zf, zc, wf, wc, u0=u0, u1=u1,
        ns=ns, P=P, clamp_ns=clamp_ns, boundaries=boundaries, planes=planes,
        precision=precision)
    D, Du, dev = feats.shape[2], u1 - u0, feats.device
    dWall = torch.empty((Wall.shape[0], Du + 1), dtype=torch.float32,
                        device=dev)
    contract_cuda(dplane, feats, dWall, mode=0, D=D, u0=u0, Du=Du,
                  precision=precision)
    if not want_dfeats:
        return dWall
    dfeats = torch.zeros_like(feats)
    contract_cuda(dplane, Wall, dfeats, mode=1, D=D, u0=u0, Du=Du,
                  precision=precision)
    return dWall, dfeats


class FdtNllDual(torch.autograd.Function):
    """``(zf, zc) = FdtNllDual.apply(Wall, feats, labels, lengths, u0, u1,
    ns, P, clamp_ns, boundaries, grad_feats, precision)``: K1 forward, K2
    backward, their products in ``precision``.

    Replaces ``_fdt_core``'s custom VJP.  On the kernel path the forward's
    planes are kept for the backward, so a step forms them once.  The
    backward returns ``dWall`` and, only when ``grad_feats`` is set, the
    feature cotangent; a dead lattice (z <= NEG_INF/2) gets zero gradient
    (K2's ``live`` gate, the plain path's ``_dead_guard``)."""

    @staticmethod
    def forward(ctx, Wall, feats, labels, lengths, u0, u1, ns, P, clamp_ns,
                boundaries, grad_feats, precision="highest"):
        kw = dict(u0=u0, u1=u1, ns=ns, P=P, clamp_ns=clamp_ns,
                  boundaries=boundaries, precision=precision)
        use = kernels.use_kernel(feats)
        if use:
            alphas, zf, zc, planes = fdt_forward_cuda(Wall, feats, labels,
                                                      lengths, **kw)
        else:
            alphas, zf, zc = fdt_forward_wall_torch(Wall, feats, labels,
                                                    lengths, **kw)
            planes = None
        ctx.save_for_backward(Wall, feats, labels, lengths, alphas, zf, zc,
                              planes)
        ctx.kw, ctx.use, ctx.grad_feats = kw, use, grad_feats
        return zf, zc

    @staticmethod
    def backward(ctx, gzf, gzc):
        Wall, feats, labels, lengths, alphas, zf, zc, planes = \
            ctx.saved_tensors
        gzf = torch.zeros_like(zf) if gzf is None else gzf.contiguous()
        gzc = torch.zeros_like(zc) if gzc is None else gzc.contiguous()
        want = ctx.grad_feats and ctx.needs_input_grad[1]
        args = (Wall, feats, labels, lengths, alphas, zf, zc, gzf, gzc)
        if ctx.use:
            out = fdt_backward_grad_cuda(*args, **ctx.kw, want_dfeats=want,
                                         planes=planes)
        else:
            out = fdt_backward_grad_wall_torch(*args, **ctx.kw,
                                               want_dfeats=want)
        dWall, dfeats = out if want else (out, None)
        return (dWall, dfeats) + (None,) * 10


def fdt_nll_dual_wall(Wall, feats, labels, lengths, *, u0: int, u1: int,
                      ns: int, P: int, clamp_ns: int, boundaries: bool = True,
                      grad_feats: bool = False, precision: str = "highest"):
    """``(zf, zc)`` over the packed ``Wall`` through :class:`FdtNllDual`,
    the products in ``precision``:
    the kernels for CUDA tensors under ``auto`` (or always under ``cuda``,
    which raises for a CPU tensor), the plain versions otherwise."""
    return FdtNllDual.apply(Wall, feats.contiguous(),
                            labels.to(torch.int32).contiguous(),
                            lengths.to(device=feats.device,
                                       dtype=torch.int32).contiguous(),
                            u0, u1, ns, P, clamp_ns, boundaries, grad_feats,
                            prec.check(precision))
