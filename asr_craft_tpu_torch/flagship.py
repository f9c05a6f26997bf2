"""The flagship model and numpy-seeded inputs, shared by tests and chip_smoke.

Counterpart of ``__graft_entry__._flagship`` / ``_tiny_batch`` /
``entry``: BASELINE
config 2, a TIMIT-shaped triphone-state CRF — 48 phones x 3 states over
MLP-posterior features with a +/-1 context window (144 dims), and
frame-dependent transition features over all dims.  Inputs come from
``numpy.random.default_rng`` so both packages can be fed the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from asr_craft_tpu_torch.models.crf import CrfConfig, crf_loss


def flagship() -> CrfConfig:
    return CrfConfig(num_labels=48, feat_dim=144, num_states=3,
                     trans_range=(0, 144))


def tiny_batch(cfg: CrfConfig, B: int = 8, T: int = 64, seed: int = 0,
               device="cpu") -> dict:
    """The JAX ``_tiny_batch``: N(0, 1) frames, phone runs of 4 frames,
    full lengths; tensors on ``device``."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, cfg.feat_dim)).astype(np.float32)
    runs = np.repeat(rng.integers(0, cfg.num_labels, size=(B, T // 4)), 4,
                     axis=1)
    return {"feats": torch.from_numpy(feats).to(device),
            "labels": torch.from_numpy(
                runs[:, :T].astype(np.int32)).to(device),
            "lengths": torch.full((B,), T, dtype=torch.int32, device=device)}


def entry(device="cpu"):
    """``(fn, args)``: the flagship forward step, ``fn(*args)`` the mean
    per-frame loss of :func:`crf_loss` on :func:`tiny_batch`, with params
    ``init_params`` at scale 0.01 from a generator seeded 0."""
    cfg = flagship()
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.01, device)
    batch = tiny_batch(cfg, device=device)

    def fn(params, feats, labels, lengths):
        loss, _ = crf_loss(cfg, params, feats, labels, lengths)
        return loss

    return fn, (params, batch["feats"], batch["labels"], batch["lengths"])


def ragged_lengths(B: int, T: int, seed: int = 0) -> np.ndarray:
    """(B,) int32 lengths in [1, T] with row 0 full and the last row empty,
    the loader's padding row (uid < 0)."""
    lengths = np.random.default_rng(seed).integers(1, T + 1, size=B)
    lengths[0] = T
    lengths[-1] = 0
    return lengths.astype(np.int32)


def posterior_model(cfg: CrfConfig, window_extent: int = 1, seed: int = 0,
                    trans_scale: float = 0.01) -> dict:
    """A hand-set model (numpy arrays) that decodes posterior features:
    the centre window's posterior of phone p feeds p's states with weight
    4, transition weights are ``trans_scale * N(0, 1)`` from ``seed``, and
    everything else is zero.  Needs the synthetic corpus's layout:
    ``feat_dim = num_labels * (2 * window_extent + 1)``."""
    P, ns = cfg.num_labels, cfg.num_states
    if cfg.feat_dim != P * (2 * window_extent + 1):
        raise ValueError(f"feat_dim {cfg.feat_dim} is not {P} posteriors "
                         f"x {2 * window_extent + 1} frames")
    params = {k: np.zeros(s, np.float32)
              for k, s in cfg.fmap.param_shapes().items()}
    centre = window_extent * P
    for p in range(P):
        params["w_state"][centre + p - cfg.fmap.state_range[0],
                          ns * p:ns * p + ns] = 4.0
    if "w_trans" in params:
        rng = np.random.default_rng(seed)
        params["w_trans"] = (trans_scale * rng.normal(
            size=params["w_trans"].shape)).astype(np.float32)
    return params
