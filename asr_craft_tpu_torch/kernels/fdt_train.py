"""K1 + K2: the factored dual-lattice forward and backward — CUDA kernels,
their plain twins, and the autograd Function that joins them.

Counterpart of the training half of :mod:`asr_craft_tpu.kernels.fdt_pallas`
(``fdt_forward_pallas``, ``fdt_backward_grad_pallas`` and the custom-VJP
core ``_fdt_core``).  The kernels are in ``csrc/fdt_train.cu`` (the note
there says what bounds them on the card); this module checks, launches and
holds the plain PyTorch versions the kernels are compared with:

- :func:`fdt_forward_wall_torch` / :func:`fdt_forward_cuda` (K1):
  ``(Wall, feats, labels, lengths) -> (alphas (B, T, 2, L'), zf, zc)``.
- :func:`fdt_backward_grad_wall_torch` / :func:`fdt_backward_grad_cuda`
  (K2): ``(..., alphas, zf, zc, wf, wc) -> dWall (R, Du+1)`` and, with
  ``want_dfeats``, ``dfeats (B, T, D)``.  K2 is two kernels, each with its
  plain twin: the recursion (:func:`fdt_dplane_wall_torch` /
  :func:`fdt_dplane_cuda`), an explicit beta / xi / gamma recursion (not
  autograd of the forward, so the CPU tests check its arithmetic) that
  writes ``dplane (B, T, R)``; and the contraction
  (:func:`contract_wall_torch` / :func:`contract_cuda`) that forms
  ``dWall`` and ``dfeats`` from it.
- :class:`FdtNllDual`: forward K1, backward K2 with ``(gzf, gzc)`` as the
  lattice weights; the kernels for CUDA tensors under ``auto``, the plain
  versions for CPU tensors.
- :func:`fdt_nll_dual_wall`: the entry point ``ops.fdt.fdt_nll_dual``
  calls on the kernel path.

``Wall`` comes from :func:`asr_craft_tpu_torch.kernels.wall.build_wall`,
whose gathers autograd differentiates, so ``dWall`` flows back into the
canonical parameters.  ``launches`` counts each wrapper's launches.
"""
from __future__ import annotations

import ctypes

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.kernels.wall import (SMEM_LIMIT, check_inputs,
                                              feats_xu, wall_planes, wall_t4)
from asr_craft_tpu_torch.ops import fdt
from asr_craft_tpu_torch.ops.semiring import NEG_INF

launches = {"fdt_train_fwd": 0, "fdt_train_bwd": 0, "fdt_train_contract": 0}
CONTRACT_SPLITS, CONTRACT_CHUNK = 16, 4096  # dWall's split of the frames

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _state2(state, labels, t: int, clamp_ns: int):
    """(B, 2, L') state rows of frame ``t`` for the free and the clamped
    lattice.  ``state`` is the plane's (B, T, L') state block with the
    boundary masks already folded in (``ops.fdt._boundary_state``)."""
    s = state[:, t]
    return torch.stack(
        [s, s + fdt._clamp_row(labels[:, t], s.shape[-1], clamp_ns)], dim=1)


def fdt_forward_wall_torch(Wall, feats, labels, lengths, *, u0: int, u1: int,
                           ns: int, P: int, clamp_ns: int,
                           boundaries: bool = True):
    """The plain version of :func:`fdt_forward_cuda`: planes from
    :func:`wall_planes`, then the factored log-semiring loop of
    :mod:`asr_craft_tpu_torch.ops.fdt` on both lattices.  Returns
    ``(alphas (B, T, 2, L'), zf (B,), zc (B,))``."""
    state, selfp, advp, crossp = wall_planes(Wall, feats, u0, u1, ns, P)
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


def fdt_dplane_wall_torch(Wall, feats, labels, lengths, alphas, zf, zc,
                          wf, wc, *, u0: int, u1: int, ns: int, P: int,
                          clamp_ns: int, boundaries: bool = True):
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
    plane = feats_xu(feats, u0, u1) @ Wall.T
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


def contract_wall_torch(dplane, src, *, mode: int, u0: int, u1: int):
    """The plain version of :func:`contract_cuda`: mode 0 returns ``dWall
    = dplane^T @ [x; 1]`` from ``src = feats``; mode 1 returns ``dfeats``
    with ``dfeats[..., u0:u1] = dplane @ Wall[:, :Du]`` from ``src =
    (Wall, feats)``."""
    B, T, R = dplane.shape
    if mode == 0:
        xu = feats_xu(src, u0, u1)
        return dplane.reshape(B * T, R).T @ xu.reshape(B * T, -1)
    Wall, feats = src
    dfeats = torch.zeros_like(feats)
    dfeats[..., u0:u1] = dplane @ Wall[:, :u1 - u0]
    return dfeats


def fdt_backward_grad_wall_torch(Wall, feats, labels, lengths, alphas, zf,
                                 zc, wf, wc, *, u0: int, u1: int, ns: int,
                                 P: int, clamp_ns: int,
                                 boundaries: bool = True,
                                 want_dfeats: bool = False):
    """The plain version of :func:`fdt_backward_grad_cuda`:
    :func:`fdt_dplane_wall_torch`, then ``dWall = dplane^T @ [x; 1]`` and,
    with ``want_dfeats``, ``dfeats[..., u0:u1] = dplane @ Wall[:, :Du]``.
    """
    dplane = fdt_dplane_wall_torch(
        Wall, feats, labels, lengths, alphas, zf, zc, wf, wc, u0=u0, u1=u1,
        ns=ns, P=P, clamp_ns=clamp_ns, boundaries=boundaries)
    dWall = contract_wall_torch(dplane, feats, mode=0, u0=u0, u1=u1)
    if not want_dfeats:
        return dWall
    return dWall, contract_wall_torch(dplane, (Wall, feats), mode=1, u0=u0,
                                      u1=u1)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library()
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fdt_train_fwd.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
        lib.fdt_train_fwd.restype = i32
        lib.fdt_train_bwd.argtypes = [ptr] * 10 + [i32] * 9 + [ptr]
        lib.fdt_train_bwd.restype = i32
        lib.fdt_train_contract.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        lib.fdt_train_contract.restype = i32
        for name in ("fdt_train_fwd_smem_bytes", "fdt_train_bwd_smem_bytes"):
            getattr(lib, name).argtypes = [i32] * 3
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


def _smem(lib, which: str, Du: int, ns: int, P: int) -> int:
    smem = getattr(lib, f"fdt_train_{which}_smem_bytes")(Du, ns, P)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fdt_train_{which} needs {smem} B of shared "
                         f"memory, over the {SMEM_LIMIT} B a block can use")
    return smem


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def fdt_forward_cuda(Wall, feats, labels, lengths, *, u0: int, u1: int,
                     ns: int, P: int, clamp_ns: int, boundaries: bool = True):
    """K1 on the card: ``(alphas (B, T, 2, L'), zf (B,), zc (B,))``, as
    :func:`fdt_forward_wall_torch` returns.  Raises on what the kernel does
    not take (CPU tensors, P > 128, wrong dtype/shape/layout)."""
    B, T, D = _check_train(Wall, feats, labels, lengths, u0=u0, u1=u1,
                           ns=ns, P=P, clamp_ns=clamp_ns)
    dev, Lp = feats.device, ns * P
    lib = _library()
    _smem(lib, "fwd", u1 - u0, ns, P)
    alphas = torch.empty((B, T, 2, Lp), dtype=torch.float32, device=dev)
    zf = torch.empty((B,), dtype=torch.float32, device=dev)
    zc = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return alphas, zf, zc
    wall_t = wall_t4(Wall)          # referenced until the launch returns
    with torch.cuda.device(dev):
        code = lib.fdt_train_fwd(
            wall_t.data_ptr(), feats.data_ptr(), labels.data_ptr(),
            lengths.data_ptr(), alphas.data_ptr(), zf.data_ptr(),
            zc.data_ptr(), B, T, D, u0, u1 - u0, ns, P, clamp_ns,
            int(boundaries), _stream(dev))
    _build.raise_on_error(code, "fdt_train_fwd launch")
    launches["fdt_train_fwd"] += 1
    return alphas, zf, zc


def contract_cuda(dplane, src, out, *, mode: int, D: int, u0: int, Du: int):
    """The contraction kernel: ``mode`` 0 writes ``out (R, Du+1) =
    dplane^T @ [x; 1]`` from ``src = feats`` (the frames summed in chunks,
    then the chunks in order: the same result on every run); mode 1 writes
    ``out[..., u0:u0+Du] = dplane @ Wall[:, :Du]`` from ``src = Wall``."""
    dev = dplane.device
    _build.check_tensor("dplane", dplane, torch.float32, 3, dev)
    B, T, R = dplane.shape
    _build.check_tensor("src", src, torch.float32, 3 - mode, dev)
    _build.check_tensor("out", out, torch.float32, 2 + mode, dev)
    if B * T == 0:
        out.zero_()
        return out
    # dWall: split the frames into chunks of >= CONTRACT_CHUNK, at most
    # CONTRACT_SPLITS of them, summed by the kernel in a fixed order
    splits = (min(CONTRACT_SPLITS, max(1, B * T // CONTRACT_CHUNK))
              if mode == 0 else 1)
    part = (torch.empty((splits, R, Du + 1), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    with torch.cuda.device(dev):
        code = _library().fdt_train_contract(
            dplane.data_ptr(), src.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), mode, B * T, R, D,
            u0, Du, splits, _stream(dev))
    _build.raise_on_error(code, "fdt_train_contract launch")
    launches["fdt_train_contract"] += 1
    return out


def fdt_dplane_cuda(Wall, feats, labels, lengths, alphas, zf, zc, wf, wc,
                    *, u0: int, u1: int, ns: int, P: int, clamp_ns: int,
                    boundaries: bool = True):
    """K2's recursion kernel: ``dplane (B, T, R)``, as
    :func:`fdt_dplane_wall_torch` returns."""
    B, T, D = _check_train(Wall, feats, labels, lengths, u0=u0, u1=u1,
                           ns=ns, P=P, clamp_ns=clamp_ns)
    dev, Lp, Du = feats.device, ns * P, u1 - u0
    _build.check_tensor("alphas", alphas, torch.float32, 4, dev)
    if tuple(alphas.shape) != (B, T, 2, Lp):
        raise ValueError(f"alphas {tuple(alphas.shape)}, expected "
                         f"{(B, T, 2, Lp)}")
    for name, v in (("zf", zf), ("zc", zc), ("wf", wf), ("wc", wc)):
        _build.check_tensor(name, v, torch.float32, 1, dev)
        if v.shape[0] != B:
            raise ValueError(f"{name} has {v.shape[0]} rows, expected {B}")
    lib = _library()
    _smem(lib, "bwd", Du, ns, P)
    R = Wall.shape[0]
    dplane = torch.empty((B, T, R), dtype=torch.float32, device=dev)
    if B:
        wall_t = wall_t4(Wall)      # referenced until the launch returns
        with torch.cuda.device(dev):
            code = lib.fdt_train_bwd(
                wall_t.data_ptr(), feats.data_ptr(),
                labels.data_ptr(), lengths.data_ptr(), alphas.data_ptr(),
                zf.data_ptr(), zc.data_ptr(), wf.data_ptr(), wc.data_ptr(),
                dplane.data_ptr(), B, T, D, u0, Du, ns, P, clamp_ns,
                int(boundaries), _stream(dev))
        _build.raise_on_error(code, "fdt_train_bwd launch")
        launches["fdt_train_bwd"] += 1
    return dplane


def fdt_backward_grad_cuda(Wall, feats, labels, lengths, alphas, zf, zc, wf,
                           wc, *, u0: int, u1: int, ns: int, P: int,
                           clamp_ns: int, boundaries: bool = True,
                           want_dfeats: bool = False):
    """K2 on the card: the recursion kernel writes ``dplane (B, T, R)``,
    then the contraction kernel forms ``dWall`` (and ``dfeats`` with
    ``want_dfeats``), as :func:`fdt_backward_grad_wall_torch` returns."""
    dplane = fdt_dplane_cuda(
        Wall, feats, labels, lengths, alphas, zf, zc, wf, wc, u0=u0, u1=u1,
        ns=ns, P=P, clamp_ns=clamp_ns, boundaries=boundaries)
    D, Du, dev = feats.shape[2], u1 - u0, feats.device
    dWall = torch.empty((Wall.shape[0], Du + 1), dtype=torch.float32,
                        device=dev)
    contract_cuda(dplane, feats, dWall, mode=0, D=D, u0=u0, Du=Du)
    if not want_dfeats:
        return dWall
    dfeats = torch.zeros_like(feats)
    contract_cuda(dplane, Wall, dfeats, mode=1, D=D, u0=u0, Du=Du)
    return dWall, dfeats


class FdtNllDual(torch.autograd.Function):
    """``(zf, zc) = FdtNllDual.apply(Wall, feats, labels, lengths, u0, u1,
    ns, P, clamp_ns, boundaries, grad_feats)``: K1 forward, K2 backward.

    Replaces ``_fdt_core``'s custom VJP.  The backward returns ``dWall``
    and, only when ``grad_feats`` is set, the feature cotangent; a dead
    lattice (z <= NEG_INF/2) gets zero gradient (K2's ``live`` gate, the
    plain path's ``_dead_guard``)."""

    @staticmethod
    def forward(ctx, Wall, feats, labels, lengths, u0, u1, ns, P, clamp_ns,
                boundaries, grad_feats):
        kw = dict(u0=u0, u1=u1, ns=ns, P=P, clamp_ns=clamp_ns,
                  boundaries=boundaries)
        use = kernels.use_kernel(feats)
        fwd = fdt_forward_cuda if use else fdt_forward_wall_torch
        alphas, zf, zc = fwd(Wall, feats, labels, lengths, **kw)
        ctx.save_for_backward(Wall, feats, labels, lengths, alphas, zf, zc)
        ctx.kw, ctx.use, ctx.grad_feats = kw, use, grad_feats
        return zf, zc

    @staticmethod
    def backward(ctx, gzf, gzc):
        Wall, feats, labels, lengths, alphas, zf, zc = ctx.saved_tensors
        gzf = torch.zeros_like(zf) if gzf is None else gzf.contiguous()
        gzc = torch.zeros_like(zc) if gzc is None else gzc.contiguous()
        bwd = (fdt_backward_grad_cuda if ctx.use
               else fdt_backward_grad_wall_torch)
        want = ctx.grad_feats and ctx.needs_input_grad[1]
        out = bwd(Wall, feats, labels, lengths, alphas, zf, zc, gzf, gzc,
                  **ctx.kw, want_dfeats=want)
        dWall, dfeats = out if want else (out, None)
        return (dWall, dfeats) + (None,) * 9


def fdt_nll_dual_wall(Wall, feats, labels, lengths, *, u0: int, u1: int,
                      ns: int, P: int, clamp_ns: int, boundaries: bool = True,
                      grad_feats: bool = False):
    """``(zf, zc)`` over the packed ``Wall`` through :class:`FdtNllDual`:
    the kernels for CUDA tensors under ``auto`` (or always under ``cuda``,
    which raises for a CPU tensor), the plain versions otherwise."""
    return FdtNllDual.apply(Wall, feats.contiguous(),
                            labels.to(torch.int32).contiguous(),
                            lengths.to(device=feats.device,
                                       dtype=torch.int32).contiguous(),
                            u0, u1, ns, P, clamp_ns, boundaries, grad_feats)
