"""Dense feature map: (acoustic frame, label) -> log potential, as matmuls.

Counterpart of :mod:`asr_craft_tpu.models.feature_map`: the dense map,
the sparse map (``sparse_potentials``: a gather and a weighted sum, which
the shared-transition path uses) and ``densify_sparse``, the exact bridge
that lets sparse inputs ride the frame-dependent-transition path.
Parameters are a plain dict of tensors with the JAX package's keys and
shapes:

    w_state (Ds, L')   b_state (L',)   w_trans (Dt, L', L')   b_trans (L', L')

so a weight file or a numpy parameter dict moves between the packages
unchanged (:mod:`asr_craft_tpu_torch.models.weights`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from asr_craft_tpu_torch.ops.precision import product


@dataclasses.dataclass(frozen=True)
class FeatureMapConfig:
    """Mirrors the JAX ``FeatureMapConfig``: ``state_range`` /
    ``trans_range`` are half-open slices of the input dims; a zero-width
    ``trans_range`` means bias-only (shared) transitions."""

    feat_dim: int
    num_expanded: int                          # L' = num_labels * num_states
    state_range: Optional[Tuple[int, int]] = None   # default: all dims
    trans_range: Tuple[int, int] = (0, 0)
    use_state_bias: bool = True
    use_trans_bias: bool = True
    # the potentials' products: "highest" | "bf16x3" | "default"
    # (asr_craft_tpu_torch.ops.precision)
    precision: str = "highest"

    def __post_init__(self):
        if self.state_range is None:
            object.__setattr__(self, "state_range", (0, self.feat_dim))
        for name in ("state_range", "trans_range"):
            s, e = getattr(self, name)
            if not (0 <= s <= e <= self.feat_dim):
                raise ValueError(
                    f"{name}={(s, e)} out of [0, {self.feat_dim}]")

    @property
    def state_dim(self) -> int:
        return self.state_range[1] - self.state_range[0]

    @property
    def trans_dim(self) -> int:
        return self.trans_range[1] - self.trans_range[0]

    @property
    def frame_dependent_trans(self) -> bool:
        return self.trans_dim > 0

    def param_shapes(self) -> dict:
        L = self.num_expanded
        shapes = {"w_state": (self.state_dim, L)}
        if self.use_state_bias:
            shapes["b_state"] = (L,)
        if self.frame_dependent_trans:
            shapes["w_trans"] = (self.trans_dim, L, L)
        if self.use_trans_bias or not self.frame_dependent_trans:
            shapes["b_trans"] = (L, L)
        return shapes

    def num_params(self) -> int:
        return sum(int(np.prod(s)) for s in self.param_shapes().values())

    def init_params(self, generator: Optional[torch.Generator] = None,
                    scale: float = 0.0, device="cpu") -> dict:
        """Zero lambdas (the reference's start), or ``scale * N(0, 1)`` drawn
        from ``generator`` in sorted-name order.  Draws happen on the CPU
        and are moved to ``device``, so one seed gives one model anywhere.
        The numbers differ from the JAX package's ``jax.random`` draws:
        cross-package tests build numpy parameters and convert them with
        ``weights.params_from_numpy``."""
        out = {}
        for name, shape in sorted(self.param_shapes().items()):
            if scale:
                w = scale * torch.randn(shape, generator=generator)
            else:
                w = torch.zeros(shape)
            out[name] = w.to(device)
        return out


def dense_potentials(cfg: FeatureMapConfig, params: dict, feats):
    """feats (..., T, D) -> (state (..., T, L'),
    trans (L', L') or (..., T, L', L')), the products in ``cfg.precision``
    (:func:`asr_craft_tpu_torch.ops.precision.product`)."""
    L = cfg.num_expanded
    s0, s1 = cfg.state_range
    state = product(torch.matmul, feats[..., s0:s1], params["w_state"],
                    cfg.precision)
    if cfg.use_state_bias:
        state = state + params["b_state"]
    if cfg.frame_dependent_trans:
        t0, t1 = cfg.trans_range
        w = params["w_trans"].reshape(cfg.trans_dim, L * L)
        trans = product(torch.matmul, feats[..., t0:t1], w,
                        cfg.precision).reshape(*feats.shape[:-1], L, L)
        if cfg.use_trans_bias:
            trans = trans + params["b_trans"]
    else:
        trans = params["b_trans"]
    return state, trans


def densify_sparse(indices, values, D: int):
    """(B, T, K) sparse (index, value) pairs -> dense (B, T, D) frames.

    Exact: ``sum_k val_k * w[idx_k, l]`` equals ``densify(pairs) @ w``
    term for term.  Padding slots (index 0, value 0) land harmlessly on
    dim 0, and duplicate indices accumulate (a scatter-add)."""
    B, T, K = indices.shape
    out = torch.zeros((B, T, D), dtype=values.dtype, device=values.device)
    return out.scatter_add(2, indices.long(), values)


def sparse_potentials(cfg: FeatureMapConfig, params: dict, indices, values):
    """Sparse frames ``indices (..., T, K)`` int, ``values (..., T, K)`` ->
    the outputs of :func:`dense_potentials`.

    Pair k scores ``values[k] * w[indices[k], label]``; padding slots are
    index 0 with value 0.  Range routing: only indices inside a function's
    dim range feed it, out-of-range pairs add nothing (the JAX version's
    semantics)."""
    def seg(w, lo, hi, n_out_dims):
        in_rng = (indices >= lo) & (indices < hi)
        idx = torch.clamp(indices.long() - lo, 0, w.shape[0] - 1)
        val = torch.where(in_rng, values, 0.0)
        val = val.reshape(val.shape + (1,) * n_out_dims)
        return (val * w[idx]).sum(dim=indices.dim() - 1)

    state = seg(params["w_state"], *cfg.state_range, 1)
    if cfg.use_state_bias:
        state = state + params["b_state"]
    if cfg.frame_dependent_trans:
        trans = seg(params["w_trans"], *cfg.trans_range, 2)
        if cfg.use_trans_bias:
            trans = trans + params["b_trans"]
    else:
        trans = params["b_trans"]
    return state, trans
