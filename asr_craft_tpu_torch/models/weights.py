"""Flat lambda-vector weight files, interchangeable with the JAX package's.

Counterpart of :mod:`asr_craft_tpu.models.weights`: the canonical flat
ordering is the parameter names sorted alphabetically, row-major within
each array, stored as raw little-endian float64 — the reference's on-disk
format.  A file written by either package loads in the other.  So does the
``.npz`` of named arrays that the segmental recipe writes.
"""
from __future__ import annotations

import numpy as np
import torch

from asr_craft_tpu_torch.models.feature_map import FeatureMapConfig


def flatten_params(cfg: FeatureMapConfig, params: dict) -> np.ndarray:
    """Canonical flat float64 lambda vector (names sorted alphabetically)."""
    shapes = cfg.param_shapes()
    missing = set(shapes) - set(params)
    if missing:
        raise ValueError(f"params missing {sorted(missing)}")
    return np.concatenate([
        np.asarray(torch.as_tensor(params[name]).detach().cpu(),
                   dtype=np.float64).reshape(-1)
        for name in sorted(shapes)
    ])


def unflatten_params(cfg: FeatureMapConfig, flat: np.ndarray,
                     device="cpu") -> dict:
    """Flat vector -> dict of float32 tensors on ``device``."""
    shapes = cfg.param_shapes()
    if flat.size != cfg.num_params():
        raise ValueError(
            f"weight vector has {flat.size} entries, config needs "
            f"{cfg.num_params()}")
    out, off = {}, 0
    for name in sorted(shapes):
        n = int(np.prod(shapes[name]))
        out[name] = torch.from_numpy(
            flat[off:off + n].reshape(shapes[name]).astype(np.float32)
        ).to(device)
        off += n
    return out


def params_from_numpy(np_params: dict, device="cpu") -> dict:
    """The JAX package's parameters (as numpy arrays) -> the port's:
    same keys and shapes, float32 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy())
            .to(device) for k, v in np_params.items()}


def save_raw(path, cfg: FeatureMapConfig, params: dict) -> None:
    """Raw little-endian float64 flat file."""
    flatten_params(cfg, params).astype("<f8").tofile(path)


def load_raw(path, cfg: FeatureMapConfig, device="cpu") -> dict:
    return unflatten_params(cfg, np.fromfile(path, dtype="<f8"), device)


def save_npz(path, params: dict) -> None:
    """One named array per parameter, in the parameters' own types: the
    JAX package's ``save_npz`` format."""
    np.savez(path, **{k: torch.as_tensor(v).detach().cpu().numpy()
                      for k, v in params.items()})


def load_npz(path, device="cpu") -> dict:
    """A ``save_npz`` file of either package -> dict of float32 tensors on
    ``device``."""
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in z.files}, device)
