"""K4, K5, K6a, K6b, K14: forward-backward over a shared transition matrix —
CUDA kernels, their plain twins and the dispatch between them.

Counterpart of :mod:`asr_craft_tpu.kernels.fwdbwd_pallas` (``forward_pallas``,
``backward_pallas``) and :mod:`asr_craft_tpu.kernels.dual_pallas`
(``forward_dual_pallas``, ``backward_dual_pallas``,
``backward_dual_grad_pallas``).  The kernels are in ``csrc/fwdbwd.cu`` (the
note there says what bounds them on the card): two templated recursions, a
forward over 1 or 2 lattices and a backward over 1 or 2 lattices that writes
betas or, for K5, the state gradient and the rows ``U_t``, ``V_t`` of the
transition gradient, whose product ``UV = sum_t U_t^T V_t`` is
``csrc/fwdbwd_mma.cu``'s contraction on the tensor cores.  This module
plans, checks, launches and holds the plain PyTorch version of each, the
explicit rescaled-exp recursion of the JAX ``ops.mxu``:

============================  ======================  =======================
dispatch                      kernel wrapper          plain version
============================  ======================  =======================
:func:`forward` (K6a)         ``forward_cuda``        ``forward_plain``
:func:`backward` (K6b)        ``backward_cuda``       ``backward_plain``
:func:`forward_dual` (K4)     ``forward_dual_cuda``   ``forward_dual_plain``
:func:`backward_dual` (K14)   ``backward_dual_cuda``  ``backward_dual_plain``
:func:`backward_dual_grad`    ``backward_dual_grad_   ``backward_dual_grad_
(K5: the two below)           cuda``                  plain``
K5's recursion                ``backward_dual_grad_   ``backward_dual_grad_
                              rows_cuda``             rows_plain``
K5's contraction              ``backward_dual_        ``backward_dual_
                              contract_cuda``         contract_plain``
============================  ======================  =======================

Everything is batch-major: ``state (B, T, L)`` float32 with the boundary
masks folded in, ``trans (L, L)``, ``labels (B, T)`` int32 at ``clamp_ns``
granularity (frame label ``y`` admits states ``[y * clamp_ns, (y + 1) *
clamp_ns)``; 1 = state equality), ``lengths (B,)`` int32.  The transition
factors (``tmax``, ``P = exp(trans - tmax)`` and their transposed twins)
are formed here, outside the kernels, as the JAX wrappers form them (the
recursions read them destination-major, a row a destination).  A recursion
takes ``L <= 232``: a group of four lanes owns two or four destinations,
each lane a quarter of their factor rows, in registers up to ``L = 144``
and in shared memory beyond (:func:`factor_layout`); the wrappers raise
beyond.  The contraction takes any ``L`` (:func:`contract_tile` tiles
it).

The dispatchers follow :func:`asr_craft_tpu_torch.kernels.use_kernel`: a
CUDA tensor under ``auto`` launches the kernel or raises, a CPU tensor takes
the plain version.  Each wrapper counts its launches in the counter
``kernels.<kernel>`` of :mod:`asr_craft_tpu_torch.utils.diagnostics`.
"""
from __future__ import annotations

import ctypes

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.ops.fdt import _clamp_row
from asr_craft_tpu_torch.ops.semiring import NEG_INF
from asr_craft_tpu_torch.utils import diagnostics

LOG_FLOOR = 1e-38            # the reference's floor under every log
MAX_L = 232                  # the widest lattice the recursions take
# The recursions' layouts of the factor, (QV, D, shared): a group of four
# lanes owns D destinations, and a lane holds QV float4 chunks (4 QV
# predecessors; QV odd, so a quarter-warp's 16-byte loads fall on distinct
# banks) of each of their factor rows, in registers while they fit (L <= 48,
# 80, 144), else in shared memory (L <= 240).
REG_LAYOUTS = ((3, 2, False), (5, 2, False), (9, 2, False))
SHARED_LAYOUT = (15, 4, True)
# K5's contraction: its square output tiles (``csrc/fwdbwd_mma.cu``), and the
# rows a chunk of the frames holds at least
CONTRACT_TILES, CONTRACT_MIN_ROWS = (48, 96, 144), 256

_lib = None


# ---------------------------------------------------------------------------
# host-side planning
# ---------------------------------------------------------------------------

def factor_layout(L: int):
    """``(QV, D, shared)``: the recursions' layout of the factor at width
    ``L``, template parameters of each kernel (no branch in the frame loop):
    the smallest register layout whose quarters ``4 QV`` cover a quarter of
    the predecessors, else the shared-memory one; None above ``MAX_L``."""
    if not 1 <= L <= MAX_L:
        return None
    return next((lay for lay in REG_LAYOUTS if 16 * lay[0] >= L),
                SHARED_LAYOUT)


def contract_tile(L: int) -> int:
    """The square output tile of K5's contraction at width ``L``: the
    smallest that holds ``L``, else the widest (tiled over ``UV``)."""
    return next((t for t in CONTRACT_TILES if t >= L), CONTRACT_TILES[-1])


def contract_splits(K: int, L: int, *, blocks: int) -> int:
    """The chunks K5's contraction splits ``K`` rows into: enough that about
    ``blocks`` blocks (what the card holds at once) run over the output's
    tiles, each chunk at least ``CONTRACT_MIN_ROWS`` rows (one for a small
    K).  The chunks' partials are added in chunk order, so the result does
    not depend on the split's timing."""
    tiles = (-(-L // contract_tile(L))) ** 2
    return max(1, min(-(-blocks // tiles), K // CONTRACT_MIN_ROWS))


def row_width(L: int) -> int:
    """``ld``: the floats of a row of K5's ``U``, ``V`` on the card, ``L``
    rounded up to 4 so every row starts 16-byte aligned for the
    contraction's copies."""
    return (L + 3) // 4 * 4


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
    w (B, N))``: ``(g_state (B, T, L), U, V (B, T, N, L))``, the state
    gradient and the rows of the transition gradient ``UV = sum U^T V``,
    with no beta kept.  ``U_t = exp(alpha_t + m - z) * w``, the reference's
    ``exp(alpha_t - mU) * exp(mU + m - z) * w`` in one exponent (its range
    or wider: see ``csrc/fwdbwd.cu``); ``U_t`` and ``V_t = exp(x - m)`` are 0
    where frame ``t + 1`` is past the length."""
    B, T, L = state.shape
    lengths = lengths.to(state.device)
    tmax_r, Pt = backward_factors(trans)
    n_lat = 1 if labels is None else 2
    beta = torch.zeros((B, n_lat, L), dtype=state.dtype, device=state.device)
    rows = [None] * T
    zero = torch.zeros_like(beta)
    Us, Vs = [zero] * T, [zero] * T
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
                Us[t] = torch.where(
                    valid_next, torch.exp(alphas[:, t] + m - z) * w, 0.0)
                Vs[t] = torch.where(valid_next, V, 0.0)
            beta = torch.where(valid_next, new, 0.0)
        if grad is None:
            rows[t] = beta
        else:
            g2 = torch.where((t < lengths)[:, None, None],
                             torch.exp(alphas[:, t] + beta - z) * w, 0.0)
            rows[t] = g2.sum(dim=1)
    if grad is None:
        return torch.stack(rows, dim=1)
    return (torch.stack(rows, dim=1), torch.stack(Us, dim=1),
            torch.stack(Vs, dim=1))


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


def backward_dual_grad_rows_plain(state, trans, labels, lengths, af, ac, zf,
                                  zc, wf, wc, clamp_ns: int = 1):
    """The plain version of :func:`backward_dual_grad_rows_cuda` (K5's
    recursion): ``(g_state (B, T, L) = wf * gamma_f + wc * gamma_c, U, V
    (B, T, 2, L))``, lattice 0 the free one."""
    return _backward_plain(
        state, trans, lengths, labels, clamp_ns,
        grad=(torch.stack([af, ac], dim=2), torch.stack([zf, zc], dim=1),
              torch.stack([wf, wc], dim=1)))


def backward_dual_contract_plain(U, V, L: int | None = None):
    """The plain version of :func:`backward_dual_contract_cuda` (K5's
    contraction): ``UV (L, L) = sum over rows of U^T V``, the rows of ``U``
    and ``V`` (any leading shape) cut to their first ``L`` columns."""
    L = U.shape[-1] if L is None else L
    return U[..., :L].reshape(-1, L).T @ V[..., :L].reshape(-1, L)


def backward_dual_grad_plain(state, trans, labels, lengths, af, ac, zf, zc,
                             wf, wc, clamp_ns: int = 1):
    """The plain version of :func:`backward_dual_grad_cuda` (K5): ``(g_state
    (B, T, L) = wf * gamma_f + wc * gamma_c, UV (L, L))`` with ``g_trans =
    sign(UV) * exp(trans + log|UV|)`` left to the caller; the recursion's
    plain version, then the contraction's."""
    g_state, U, V = backward_dual_grad_rows_plain(
        state, trans, labels, lengths, af, ac, zf, zc, wf, wc, clamp_ns)
    return g_state, backward_dual_contract_plain(U, V)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library()
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fwdbwd_forward.argtypes = [ptr] * 9 + [i32] * 8 + [ptr]
        lib.fwdbwd_backward.argtypes = [ptr] * 7 + [i32] * 8 + [ptr]
        lib.fwdbwd_backward_grad.argtypes = [ptr] * 14 + [i32] * 8 + [ptr]
        lib.fb_contract.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        for name in ("fwdbwd_forward", "fwdbwd_backward",
                     "fwdbwd_backward_grad", "fb_contract",
                     "fb_contract_blocks_per_sm"):
            getattr(lib, name).restype = i32
        lib.fb_contract_blocks_per_sm.argtypes = [i32]
        lib.fwdbwd_smem_bytes.argtypes = [i32] * 6
        lib.fwdbwd_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def smem_bytes(L: int, n_lat: int, grad: bool = False) -> int:
    """The dynamic shared memory of a recursion over ``n_lat`` lattices at
    width ``L`` in bytes (``grad``: K5's), in the layout
    :func:`factor_layout` picks; 0: no recursion takes this L."""
    layout = factor_layout(L)
    if layout is None:
        return 0
    qv, D, shared = layout
    return _library().fwdbwd_smem_bytes(L, n_lat, qv, D, int(shared),
                                        int(grad))


def destination_rows(trans, forward: bool):
    """``(tmax (L,), F (L, L))``: the recursions' factor, row ``l`` what
    reaches destination ``l``: ``P^T`` (:func:`forward_factors`) forward,
    ``Pt^T`` (:func:`backward_factors`) backward."""
    tmax, P = (forward_factors if forward else backward_factors)(trans)
    return tmax, P.T.contiguous()


def _check(state, trans, lengths, labels, clamp_ns, n_lat, grad=False):
    """Validate what every recursion here takes; returns (B, T, L)."""
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
    if smem_bytes(L, n_lat, grad) == 0:
        raise ValueError(f"L = {L}: the forward-backward kernels take L <= "
                         f"{MAX_L} (a lane holds a quarter of its "
                         "destination's factor row, in registers or in "
                         "shared memory)")
    return B, T, L


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_forward(counter, state, trans, labels, lengths, clamp_ns):
    n_lat = 1 if labels is None else 2
    B, T, L = _check(state, trans, lengths, labels, clamp_ns, n_lat)
    dev = state.device
    alphas = [torch.empty((B, T, L), dtype=torch.float32, device=dev)
              for _ in range(n_lat)]
    z = [torch.empty((B,), dtype=torch.float32, device=dev)
         for _ in range(n_lat)]
    if B:
        qv, D, shared = factor_layout(L)
        tmax, F = destination_rows(trans, True)   # referenced until launch
        with torch.cuda.device(dev):
            code = _library().fwdbwd_forward(
                state.data_ptr(), F.data_ptr(), tmax.data_ptr(),
                None if labels is None else labels.data_ptr(),
                lengths.data_ptr(), alphas[0].data_ptr(),
                alphas[-1].data_ptr(), z[0].data_ptr(), z[-1].data_ptr(),
                B, T, L, n_lat, clamp_ns, qv, D, int(shared), _stream(dev))
        _build.raise_on_error(code, f"{counter} launch")
        diagnostics.count(counter)
    return alphas, z


def _launch_backward(counter, state, trans, labels, lengths, clamp_ns):
    n_lat = 1 if labels is None else 2
    B, T, L = _check(state, trans, lengths, labels, clamp_ns, n_lat)
    dev = state.device
    betas = [torch.empty((B, T, L), dtype=torch.float32, device=dev)
             for _ in range(n_lat)]
    if B:
        qv, D, shared = factor_layout(L)
        tmax_r, F = destination_rows(trans, False)
        with torch.cuda.device(dev):
            code = _library().fwdbwd_backward(
                state.data_ptr(), F.data_ptr(), tmax_r.data_ptr(),
                None if labels is None else labels.data_ptr(),
                lengths.data_ptr(), betas[0].data_ptr(),
                betas[-1].data_ptr(), B, T, L, n_lat, clamp_ns, qv, D,
                int(shared), _stream(dev))
        _build.raise_on_error(code, f"{counter} launch")
        diagnostics.count(counter)
    return betas


def forward_cuda(state, trans, lengths):
    """K6a on the card: ``(alphas (B, T, L), logZ (B,))``, as
    :func:`forward_plain` returns."""
    alphas, z = _launch_forward("kernels.forward", state, trans, None,
                                lengths, 1)
    return alphas[0], z[0]


def backward_cuda(state, trans, lengths):
    """K6b on the card: ``betas (B, T, L)``, as :func:`backward_plain`
    returns."""
    return _launch_backward("kernels.backward", state, trans, None,
                            lengths, 1)[0]


def forward_dual_cuda(state, trans, labels, lengths, clamp_ns: int = 1):
    """K4 on the card: ``(af, ac, zf, zc)``, as :func:`forward_dual_plain`
    returns."""
    alphas, z = _launch_forward("kernels.forward_dual", state, trans, labels,
                                lengths, clamp_ns)
    return alphas[0], alphas[1], z[0], z[1]


def backward_dual_cuda(state, trans, labels, lengths, clamp_ns: int = 1):
    """K14 on the card: ``(bf, bc)``, as :func:`backward_dual_plain`
    returns."""
    betas = _launch_backward("kernels.backward_dual", state, trans, labels,
                             lengths, clamp_ns)
    return betas[0], betas[1]


def backward_dual_grad_rows_cuda(state, trans, labels, lengths, af, ac, zf,
                                 zc, wf, wc, clamp_ns: int = 1):
    """K5's recursion on the card: ``(g_state (B, T, L), U, V (B, T, 2,
    ld))`` with ``ld = row_width(L)``; columns ``:L`` hold what
    :func:`backward_dual_grad_rows_plain` returns, the rest is not
    written."""
    B, T, L = _check(state, trans, lengths, labels, clamp_ns, 2, grad=True)
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
    ld = row_width(L)
    g_state = torch.empty((B, T, L), dtype=torch.float32, device=dev)
    U, V = (torch.empty((B, T, 2, ld), dtype=torch.float32, device=dev)
            for _ in range(2))
    if B:
        qv, D, shared = factor_layout(L)
        tmax_r, F = destination_rows(trans, False)
        with torch.cuda.device(dev):
            code = _library().fwdbwd_backward_grad(
                state.data_ptr(), F.data_ptr(), tmax_r.data_ptr(),
                labels.data_ptr(), lengths.data_ptr(), af.data_ptr(),
                ac.data_ptr(), zf.data_ptr(), zc.data_ptr(), wf.data_ptr(),
                wc.data_ptr(), g_state.data_ptr(), U.data_ptr(),
                V.data_ptr(), B, T, L, ld, clamp_ns, qv, D, int(shared),
                _stream(dev))
        _build.raise_on_error(code, "fwdbwd backward_dual_grad launch")
        diagnostics.count("kernels.backward_dual_grad")
    return g_state, U, V


def backward_dual_contract_cuda(U, V, L: int):
    """K5's contraction on the card, on the tensor cores (3xTF32): ``UV (L,
    L) = sum over rows of U^T V``, as :func:`backward_dual_contract_plain`
    returns, from rows of ``ld = row_width(L)`` floats (what
    :func:`backward_dual_grad_rows_cuda` writes).  The rows are summed in
    :func:`contract_splits` chunks, then the chunks in order: the same result
    on every run."""
    UV = contract_rows(U, V, L)
    diagnostics.count("kernels.backward_dual_contract")
    return UV


def contract_rows(U, V, L: int):
    """The launch of :func:`backward_dual_contract_cuda`, uncounted: K11's
    ``E^T F`` (``kernels.segmental``) runs the same kernel and counts it
    under its own name."""
    dev = U.device
    ld = row_width(L)
    for name, x in (("U", U), ("V", V)):
        _build.check_tensor(name, x, torch.float32, U.dim(), dev)
        if x.shape[-1] != ld or x.shape != U.shape:
            raise ValueError(f"{name} {tuple(x.shape)}: rows of {ld} floats "
                             f"expected for L = {L}, U and V alike")
    K = U.numel() // ld
    UV = torch.empty((L, L), dtype=torch.float32, device=dev)
    lib = _library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = contract_tile(L)
    splits = contract_splits(
        K, L, blocks=sms * lib.fb_contract_blocks_per_sm(tile))
    part = (torch.empty((splits, L, L), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    with torch.cuda.device(dev):
        code = lib.fb_contract(U.data_ptr(), V.data_ptr(),
                               None if part is None else part.data_ptr(),
                               UV.data_ptr(), K, L, ld, tile, splits,
                               _stream(dev))
    _build.raise_on_error(code, "fwdbwd backward_dual_contract launch")
    return UV


def backward_dual_grad_cuda(state, trans, labels, lengths, af, ac, zf, zc,
                            wf, wc, clamp_ns: int = 1):
    """K5 on the card: ``(g_state (B, T, L), UV (L, L))``, as
    :func:`backward_dual_grad_plain` returns: the recursion writes the rows
    of the transition gradient, the contraction adds up their products in a
    fixed order, so the result is the same on every run."""
    g_state, U, V = backward_dual_grad_rows_cuda(
        state, trans, labels, lengths, af, ac, zf, zc, wf, wc, clamp_ns)
    return g_state, backward_dual_contract_cuda(U, V, state.shape[-1])


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
