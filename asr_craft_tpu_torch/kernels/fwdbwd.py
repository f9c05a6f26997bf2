"""K4, K5, K6a, K6b, K14: forward-backward over a shared transition matrix —
CUDA kernels, their plain twins and the dispatch between them.

Counterpart of :mod:`asr_craft_tpu.kernels.fwdbwd_pallas` (``forward_pallas``,
``backward_pallas``) and :mod:`asr_craft_tpu.kernels.dual_pallas`
(``forward_dual_pallas``, ``backward_dual_pallas``,
``backward_dual_grad_pallas``).  The kernels are in ``csrc/fwdbwd.cu`` (the
note there says what bounds them on the card): two templated recursions, a
forward over 1 or 2 lattices and a backward over 1 or 2 lattices that writes
betas or the fused classical gradient.  This module checks, launches and
holds the plain PyTorch version of each, the explicit rescaled-exp
recursion of the JAX ``ops.mxu``:

============================  =====================  =======================
dispatch                      kernel wrapper         plain version
============================  =====================  =======================
:func:`forward` (K6a)         ``forward_cuda``       ``forward_plain``
:func:`backward` (K6b)        ``backward_cuda``      ``backward_plain``
:func:`forward_dual` (K4)     ``forward_dual_cuda``  ``forward_dual_plain``
:func:`backward_dual` (K14)   ``backward_dual_cuda`` ``backward_dual_plain``
:func:`backward_dual_grad`    ``backward_dual_grad_  ``backward_dual_grad_
(K5)                          cuda``                 plain``
============================  =====================  =======================

Everything is batch-major: ``state (B, T, L)`` float32 with the boundary
masks folded in, ``trans (L, L)``, ``labels (B, T)`` int32 at ``clamp_ns``
granularity (frame label ``y`` admits states ``[y * clamp_ns, (y + 1) *
clamp_ns)``; 1 = state equality), ``lengths (B,)`` int32.  The transition
factors (``tmax``, ``P = exp(trans - tmax)`` and their transposed twins)
are formed here, outside the kernels, as the JAX wrappers form them.  A
kernel takes the widths at which its transition factor and working vectors
fit a block's shared memory (``L <= 232``) and, for K5, at which the block's
register tiles cover its ``(L, L)`` partial (``L <= 144``); the wrappers
raise beyond.

The dispatchers follow :func:`asr_craft_tpu_torch.kernels.use_kernel`: a
CUDA tensor under ``auto`` launches the kernel or raises, a CPU tensor takes
the plain version.  ``launches`` counts each wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.ops.fdt import _clamp_row
from asr_craft_tpu_torch.ops.semiring import NEG_INF

launches = {"forward": 0, "backward": 0, "forward_dual": 0,
            "backward_dual": 0, "backward_dual_grad": 0}
LOG_FLOOR = 1e-38            # the reference's floor under every log

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def row_max(x):
    """The row maximum, clamped at NEG_INF as everywhere in the
    reference."""
    return torch.clamp(x.amax(dim=-1, keepdim=True), min=NEG_INF)


def safe_log(x):
    return torch.log(torch.clamp(x, min=LOG_FLOOR))


def forward_factors(trans):
    """``(tmax (L,), P (L, L))``: the column maxima clamped at NEG_INF and
    ``exp(trans - tmax[None, :])``, every entry in [0, 1]."""
    tmax = torch.clamp(trans.amax(dim=0), min=NEG_INF)
    return tmax, torch.exp(trans - tmax[None, :]).contiguous()


def backward_factors(trans):
    """``(tmax_r (L,), Pt (L, L))``: the row maxima clamped at NEG_INF and
    ``exp(trans^T - tmax_r[None, :])``."""
    tmax_r = torch.clamp(trans.amax(dim=1), min=NEG_INF)
    return tmax_r, torch.exp(trans.T - tmax_r[None, :]).contiguous()


def _rows(state, labels, t: int, clamp_ns: int):
    """(B, N, L) state rows of frame ``t``: the free lattice and, with
    ``labels``, the clamped one."""
    s = state[:, t]
    if labels is None:
        return s[:, None]
    return torch.stack(
        [s, s + _clamp_row(labels[:, t], s.shape[-1], clamp_ns).to(s.dtype)],
        dim=1)


def _forward_plain(state, trans, lengths, labels, clamp_ns):
    """Alphas ``(B, T, N, L)`` and logZ ``(B, N)`` over N = 1 or 2
    lattices."""
    B, T, L = state.shape
    lengths = lengths.to(state.device)
    tmax, P = forward_factors(trans)
    a = _rows(state, labels, 0, clamp_ns)
    alphas = [a]
    for t in range(1, T):
        m = row_max(a)
        new = (m + tmax + safe_log(torch.exp(a - m) @ P)
               + _rows(state, labels, t, clamp_ns))
        a = torch.where((t < lengths)[:, None, None], new, a)
        alphas.append(a)
    m = row_max(a)
    z = m + safe_log(torch.exp(a - m).sum(dim=-1, keepdim=True))
    return torch.stack(alphas, dim=1), z[..., 0]


def _backward_plain(state, trans, lengths, labels, clamp_ns, grad=None):
    """The beta recursion over N = 1 or 2 lattices.  Without ``grad``:
    betas ``(B, T, N, L)``.  With ``grad = (alphas (B, T, N, L), z (B, N),
    w (B, N))``: ``(g_state (B, T, L), UV (L, L))``, the fused classical
    gradient, with no beta kept."""
    B, T, L = state.shape
    lengths = lengths.to(state.device)
    tmax_r, Pt = backward_factors(trans)
    n_lat = 1 if labels is None else 2
    beta = torch.zeros((B, n_lat, L), dtype=state.dtype, device=state.device)
    rows = [None] * T
    Us, Vs = [], []
    if grad is not None:
        alphas, z, w = grad[0], grad[1][..., None], grad[2][..., None]
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            x = beta + _rows(state, labels, t + 1, clamp_ns)
            m = row_max(x)
            V = torch.exp(x - m)
            new = m + tmax_r + safe_log(V @ Pt)
            valid_next = (t + 1 < lengths)[:, None, None]
            if grad is not None:
                a2 = alphas[:, t]
                mU = row_max(a2)
                scale = torch.where(valid_next, torch.exp(mU + m - z) * w,
                                    0.0)
                Us.append(torch.exp(a2 - mU) * scale)
                Vs.append(V)
            beta = torch.where(valid_next, new, 0.0)
        if grad is None:
            rows[t] = beta
        else:
            g2 = torch.where((t < lengths)[:, None, None],
                             torch.exp(alphas[:, t] + beta - z) * w, 0.0)
            rows[t] = g2.sum(dim=1)
    if grad is None:
        return torch.stack(rows, dim=1)
    if Us:
        UV = torch.einsum("fbnp,fbnl->pl", torch.stack(Us), torch.stack(Vs))
    else:
        UV = torch.zeros((L, L), dtype=state.dtype, device=state.device)
    return torch.stack(rows, dim=1), UV


def forward_plain(state, trans, lengths):
    """The plain version of :func:`forward_cuda` (K6a): ``(alphas (B, T, L),
    logZ (B,))``."""
    alphas, z = _forward_plain(state, trans, lengths, None, 1)
    return alphas[:, :, 0], z[:, 0]


def backward_plain(state, trans, lengths):
    """The plain version of :func:`backward_cuda` (K6b): ``betas (B, T,
    L)``."""
    return _backward_plain(state, trans, lengths, None, 1)[:, :, 0]


def forward_dual_plain(state, trans, labels, lengths, clamp_ns: int = 1):
    """The plain version of :func:`forward_dual_cuda` (K4): ``(af, ac (B, T,
    L), zf, zc (B,))``."""
    alphas, z = _forward_plain(state, trans, lengths, labels, clamp_ns)
    return alphas[:, :, 0], alphas[:, :, 1], z[:, 0], z[:, 1]


def backward_dual_plain(state, trans, labels, lengths, clamp_ns: int = 1):
    """The plain version of :func:`backward_dual_cuda` (K14): ``(bf, bc (B,
    T, L))``."""
    betas = _backward_plain(state, trans, lengths, labels, clamp_ns)
    return betas[:, :, 0], betas[:, :, 1]


def backward_dual_grad_plain(state, trans, labels, lengths, af, ac, zf, zc,
                             wf, wc, clamp_ns: int = 1):
    """The plain version of :func:`backward_dual_grad_cuda` (K5):
    ``(g_state (B, T, L) = wf * gamma_f + wc * gamma_c, UV (L, L))`` with
    ``g_trans = sign(UV) * exp(trans + log|UV|)`` left to the caller."""
    return _backward_plain(
        state, trans, lengths, labels, clamp_ns,
        grad=(torch.stack([af, ac], dim=2), torch.stack([zf, zc], dim=1),
              torch.stack([wf, wc], dim=1)))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library()
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fwdbwd_forward.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
        lib.fwdbwd_backward.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        lib.fwdbwd_backward_grad.argtypes = [ptr] * 14 + [i32] * 4 + [ptr]
        for name in ("fwdbwd_forward", "fwdbwd_backward",
                     "fwdbwd_backward_grad"):
            getattr(lib, name).restype = i32
        lib.fwdbwd_smem_bytes.argtypes = [i32] * 4
        lib.fwdbwd_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def smem_bytes(L: int, n_lat: int, grad: bool, forward: bool) -> int:
    """The dynamic shared memory of the kernel of this shape in bytes; 0: it
    does not take this L."""
    return _library().fwdbwd_smem_bytes(L, n_lat, int(grad), int(forward))


def _check(state, trans, lengths, labels, clamp_ns, n_lat, grad, forward):
    """Validate what every kernel here takes; returns (B, T, L)."""
    dev = state.device
    _build.check_tensor("state", state, torch.float32, 3, dev)
    _build.check_tensor("trans", trans, torch.float32, 2, dev)
    _build.check_tensor("lengths", lengths, torch.int32, 1, dev)
    B, T, L = state.shape
    if tuple(trans.shape) != (L, L):
        raise ValueError(f"trans {tuple(trans.shape)} is not ({L}, {L}): "
                         "the kernels take one shared transition matrix")
    if tuple(lengths.shape) != (B,) or T < 1 or L < 1:
        raise ValueError(f"lengths {tuple(lengths.shape)} vs state "
                         f"{tuple(state.shape)}")
    if labels is not None:
        _build.check_tensor("labels", labels, torch.int32, 2, dev)
        if tuple(labels.shape) != (B, T):
            raise ValueError(f"labels {tuple(labels.shape)} vs state "
                             f"{tuple(state.shape)}")
        if clamp_ns < 1:
            raise ValueError(f"clamp_ns must be >= 1, got {clamp_ns}")
    if smem_bytes(L, n_lat, grad, forward) == 0:
        raise ValueError(f"L = {L}: the forward-backward kernels take L <= "
                         "232 (the transition factor must fit a block's "
                         "shared memory), the fused gradient kernel L <= 144")
    return B, T, L


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_forward(name, state, trans, labels, lengths, clamp_ns):
    n_lat = 1 if labels is None else 2
    B, T, L = _check(state, trans, lengths, labels, clamp_ns, n_lat, False,
                     True)
    dev = state.device
    alphas = [torch.empty((B, T, L), dtype=torch.float32, device=dev)
              for _ in range(n_lat)]
    z = [torch.empty((B,), dtype=torch.float32, device=dev)
         for _ in range(n_lat)]
    if B:
        tmax, P = forward_factors(trans)    # referenced until the launch
        with torch.cuda.device(dev):
            code = _library().fwdbwd_forward(
                state.data_ptr(), P.data_ptr(), tmax.data_ptr(),
                None if labels is None else labels.data_ptr(),
                lengths.data_ptr(), alphas[0].data_ptr(),
                alphas[-1].data_ptr(), z[0].data_ptr(), z[-1].data_ptr(),
                B, T, L, n_lat, clamp_ns, _stream(dev))
        _build.raise_on_error(code, f"fwdbwd {name} launch")
        launches[name] += 1
    return alphas, z


def _launch_backward(name, state, trans, labels, lengths, clamp_ns):
    n_lat = 1 if labels is None else 2
    B, T, L = _check(state, trans, lengths, labels, clamp_ns, n_lat, False,
                     False)
    dev = state.device
    betas = [torch.empty((B, T, L), dtype=torch.float32, device=dev)
             for _ in range(n_lat)]
    if B:
        tmax_r, Pt = backward_factors(trans)
        with torch.cuda.device(dev):
            code = _library().fwdbwd_backward(
                state.data_ptr(), Pt.data_ptr(), tmax_r.data_ptr(),
                None if labels is None else labels.data_ptr(),
                lengths.data_ptr(), betas[0].data_ptr(),
                betas[-1].data_ptr(), B, T, L, n_lat, clamp_ns,
                _stream(dev))
        _build.raise_on_error(code, f"fwdbwd {name} launch")
        launches[name] += 1
    return betas


def forward_cuda(state, trans, lengths):
    """K6a on the card: ``(alphas (B, T, L), logZ (B,))``, as
    :func:`forward_plain` returns."""
    alphas, z = _launch_forward("forward", state, trans, None, lengths, 1)
    return alphas[0], z[0]


def backward_cuda(state, trans, lengths):
    """K6b on the card: ``betas (B, T, L)``, as :func:`backward_plain`
    returns."""
    return _launch_backward("backward", state, trans, None, lengths, 1)[0]


def forward_dual_cuda(state, trans, labels, lengths, clamp_ns: int = 1):
    """K4 on the card: ``(af, ac, zf, zc)``, as :func:`forward_dual_plain`
    returns."""
    alphas, z = _launch_forward("forward_dual", state, trans, labels,
                                lengths, clamp_ns)
    return alphas[0], alphas[1], z[0], z[1]


def backward_dual_cuda(state, trans, labels, lengths, clamp_ns: int = 1):
    """K14 on the card: ``(bf, bc)``, as :func:`backward_dual_plain`
    returns."""
    betas = _launch_backward("backward_dual", state, trans, labels, lengths,
                             clamp_ns)
    return betas[0], betas[1]


def backward_dual_grad_cuda(state, trans, labels, lengths, af, ac, zf, zc,
                            wf, wc, clamp_ns: int = 1):
    """K5 on the card: ``(g_state (B, T, L), UV (L, L))``, as
    :func:`backward_dual_grad_plain` returns.  Each utterance's block sums
    its own ``U^T V`` and a second kernel adds the ``(B, L, L)`` partials in
    batch order, so the result is the same on every run."""
    B, T, L = _check(state, trans, lengths, labels, clamp_ns, 2, True, False)
    dev = state.device
    for name, a in (("af", af), ("ac", ac)):
        _build.check_tensor(name, a, torch.float32, 3, dev)
        if tuple(a.shape) != (B, T, L):
            raise ValueError(f"{name} {tuple(a.shape)}, expected "
                             f"{(B, T, L)}")
    for name, v in (("zf", zf), ("zc", zc), ("wf", wf), ("wc", wc)):
        _build.check_tensor(name, v, torch.float32, 1, dev)
        if v.shape[0] != B:
            raise ValueError(f"{name} has {v.shape[0]} rows, expected {B}")
    g_state = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    UV = torch.zeros((L, L), dtype=torch.float32, device=dev)
    if B:
        tmax_r, Pt = backward_factors(trans)
        part = torch.empty((B, L, L), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            code = _library().fwdbwd_backward_grad(
                state.data_ptr(), Pt.data_ptr(), tmax_r.data_ptr(),
                labels.data_ptr(), lengths.data_ptr(), af.data_ptr(),
                ac.data_ptr(), zf.data_ptr(), zc.data_ptr(), wf.data_ptr(),
                wc.data_ptr(), g_state.data_ptr(), part.data_ptr(),
                UV.data_ptr(), B, T, L, clamp_ns, _stream(dev))
        _build.raise_on_error(code, "fwdbwd backward_dual_grad launch")
        launches["backward_dual_grad"] += 1
    return g_state, UV


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _i32(t, dev):
    return t.to(device=dev, dtype=torch.int32).contiguous()


def forward(state, trans, lengths):
    """Single-lattice alpha pass: K6a or its plain version."""
    if kernels.use_kernel(state):
        return forward_cuda(state.contiguous(), trans.contiguous(),
                            _i32(lengths, state.device))
    return forward_plain(state, trans, lengths)


def backward(state, trans, lengths):
    """Single-lattice beta pass: K6b or its plain version."""
    if kernels.use_kernel(state):
        return backward_cuda(state.contiguous(), trans.contiguous(),
                             _i32(lengths, state.device))
    return backward_plain(state, trans, lengths)


def forward_dual(state, trans, labels, lengths, clamp_ns: int = 1):
    """Free and clamped alpha passes: K4 or its plain version."""
    if kernels.use_kernel(state):
        dev = state.device
        return forward_dual_cuda(state.contiguous(), trans.contiguous(),
                                 _i32(labels, dev), _i32(lengths, dev),
                                 clamp_ns)
    return forward_dual_plain(state, trans, labels, lengths, clamp_ns)


def backward_dual(state, trans, labels, lengths, clamp_ns: int = 1):
    """Free and clamped beta passes: K14 or its plain version."""
    if kernels.use_kernel(state):
        dev = state.device
        return backward_dual_cuda(state.contiguous(), trans.contiguous(),
                                  _i32(labels, dev), _i32(lengths, dev),
                                  clamp_ns)
    return backward_dual_plain(state, trans, labels, lengths, clamp_ns)


def backward_dual_grad(state, trans, labels, lengths, af, ac, zf, zc, wf, wc,
                       clamp_ns: int = 1):
    """The fused beta + classical gradient: K5 or its plain version."""
    if kernels.use_kernel(state):
        dev = state.device
        return backward_dual_grad_cuda(
            state.contiguous(), trans.contiguous(), _i32(labels, dev),
            _i32(lengths, dev), af.contiguous(), ac.contiguous(),
            zf.contiguous(), zc.contiguous(), wf.contiguous(),
            wc.contiguous(), clamp_ns)
    return backward_dual_grad_plain(state, trans, labels, lengths, af, ac,
                                    zf, zc, wf, wc, clamp_ns)
