"""The packed parameter matrix ``Wall`` shared by the fdt kernels (K1-K3).

Counterpart of ``build_wall`` in :mod:`asr_craft_tpu.kernels.fdt_pallas`,
without the TPU padding (no ``P8`` phone rows, no ``Du8`` columns).  Both
the decode (``kernels/fdt_viterbi.py``) and the training path
(``kernels/fdt_train.py``) pack the canonical parameters here, so there is
one layout:

    Wall (R, Du+1),  R = 3 L' + P^2,  rows [state L' | self L' | adv L' |
    cross P^2 (pi-major, pi * P + pj)], all state-major; columns the input
    dims [u0, u1) covering both feature ranges, then the bias.

:func:`build_wall` is plain differentiable gathers and slice assignments,
so autograd scatters a ``dWall`` cotangent back into ``w_state / b_state /
w_trans / b_trans``, and illegal transition pairs get exactly zero.
"""
from __future__ import annotations

import torch

from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.ops import fdt

MAX_LABELS = 128          # phone cap of the kernel path, as in JAX
SMEM_LIMIT = 232448       # bytes of shared memory a Hopper block may opt into


def build_wall(params: dict, fmap_cfg, ns: int):
    """Pack the canonical parameters into ``Wall (R, Du+1)``.

    Returns ``(Wall, u0, u1, {"P": P, "ns": ns})``.
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


def feats_xu(feats, u0: int, u1: int):
    """``[x_t[u0:u1]; 1]`` for every frame: (B, T, Du + 1)."""
    B, T, _ = feats.shape
    return torch.cat([feats[..., u0:u1],
                      torch.ones((B, T, 1), dtype=feats.dtype,
                                 device=feats.device)], dim=-1)


def wall_planes(Wall, feats, u0: int, u1: int, ns: int, P: int):
    """The factored planes ``[x; 1] @ Wall^T`` as
    ``(state, selfp, advp, crossp)``, shaped as ``ops.fdt.factored_planes``
    returns them (``selfp``/``advp`` None for ``ns == 1``)."""
    B, T, _ = feats.shape
    Lp = ns * P
    plane = feats_xu(feats, u0, u1) @ Wall.T                 # (B, T, R)
    state = plane[..., :Lp]
    crossp = plane[..., 3 * Lp:].reshape(B, T, P, P)
    if ns == 1:
        return state, None, None, crossp
    return state, plane[..., Lp:2 * Lp], plane[..., 2 * Lp:3 * Lp], crossp


def wall_t4(Wall):
    """The kernels' copy of Wall: transposed to (Du+1, R4) and zero-padded
    to R4 = R rounded up to 4 rows, for coalesced 16-byte reads of 4-row
    groups (csrc/fdt_common.cuh form_plane)."""
    R = Wall.shape[0]
    wall_t = torch.zeros((Wall.shape[1], (R + 3) // 4 * 4),
                         dtype=torch.float32, device=Wall.device)
    wall_t[:, :R] = Wall.T
    return wall_t


def check_inputs(name: str, Wall, feats, lengths, *, u0: int, u1: int,
                 ns: int, P: int):
    """Validate what every fdt kernel takes (CUDA, float32/int32,
    contiguous, P <= 128, a Wall of the right shape); returns (B, T, D)."""
    dev = feats.device
    _build.check_tensor("feats", feats, torch.float32, 3, dev)
    _build.check_tensor("Wall", Wall, torch.float32, 2, dev)
    _build.check_tensor("lengths", lengths, torch.int32, 1, dev)
    B, T, D = feats.shape
    if P > MAX_LABELS:
        raise ValueError(f"the {name} kernel supports P <= {MAX_LABELS} "
                         f"phones, got {P}")
    if not 0 <= u0 <= u1 <= D:
        raise ValueError(f"feature range [{u0}, {u1}) outside [0, {D}]")
    if tuple(Wall.shape) != (3 * ns * P + P * P, u1 - u0 + 1):
        raise ValueError(f"Wall shape {tuple(Wall.shape)} does not match "
                         f"ns={ns}, P={P}, Du={u1 - u0}")
    if tuple(lengths.shape) != (B,) or T < 1:
        raise ValueError(f"lengths {tuple(lengths.shape)} vs feats "
                         f"{tuple(feats.shape)}")
    return B, T, D
