"""The CRF model: config, parameters and decode.

Counterpart of :mod:`asr_craft_tpu.models.crf`.  Ported so far: the
frame-dependent-transition (fdt) decode, which runs the factored Viterbi
(kernel or plain version, :mod:`asr_craft_tpu_torch.kernels.fdt_viterbi`),
and ``frame_accuracy``.  The training criterion, the shared-transition
branches and sparse inputs raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels.fdt_viterbi import (build_wall,
                                                     fdt_viterbi_wall)
from asr_craft_tpu_torch.models.feature_map import FeatureMapConfig
from asr_craft_tpu_torch.models.topology import Topology


@dataclasses.dataclass(frozen=True)
class CrfConfig:
    """Model hyperparameters (the reference's ``crf_*`` flags); the fields
    and defaults are the JAX ``CrfConfig``'s."""

    num_labels: int
    feat_dim: int
    num_states: int = 1
    state_range: Optional[Tuple[int, int]] = None
    trans_range: Tuple[int, int] = (0, 0)
    use_state_bias: bool = True
    use_trans_bias: bool = True
    featuremap: str = "dense"
    precision: str = "highest"
    enforce_boundaries: bool = True

    @property
    def topology(self) -> Topology:
        return Topology(self.num_labels, self.num_states)

    @property
    def fmap(self) -> FeatureMapConfig:
        return FeatureMapConfig(
            feat_dim=self.feat_dim,
            num_expanded=self.topology.num_expanded,
            state_range=self.state_range,
            trans_range=self.trans_range,
            use_state_bias=self.use_state_bias,
            use_trans_bias=self.use_trans_bias,
        )

    def init_params(self, generator: Optional[torch.Generator] = None,
                    scale: float = 0.0, device="cpu") -> dict:
        return self.fmap.init_params(generator, scale, device)


def decode(cfg: CrfConfig, params: dict, feats, lengths, sparse=None,
           beam_width: Optional[int] = None,
           beam_threshold: Optional[float] = None):
    """Batched Viterbi over expanded states, collapsed to per-frame phones.

    ``feats (B, T, D)`` float32 and ``lengths (B,)`` on one device; beam
    options as in the JAX package (both None = exact).  Returns
    (phone_frames (B, T), state_paths (B, T), scores (B,)), on that device.
    """
    if sparse is not None or cfg.featuremap != "dense":
        raise NotImplementedError(
            f"feature map {cfg.featuremap!r} with sparse={sparse is not None}"
            ": only dense inputs are ported (sparse: ROADMAP.md Queue 1, "
            "slice 2)")
    if not cfg.fmap.frame_dependent_trans:
        raise NotImplementedError(
            "shared-transition decode (trans_range of zero width) is not "
            "ported yet (ROADMAP.md Queue 1, slice 3)")
    feats = feats.contiguous()
    if kernels.use_kernel(feats) and cfg.precision != "highest":
        raise NotImplementedError(
            f"precision {cfg.precision!r} on the CUDA kernel (only "
            "'highest', IEEE fp32, is ported; ROADMAP.md Queue 2, K3)")
    Wall, u0, u1, dims = build_wall(params, cfg.fmap, cfg.num_states)
    paths, scores = fdt_viterbi_wall(
        Wall, feats, lengths.to(device=feats.device, dtype=torch.int32),
        u0=u0, u1=u1, ns=cfg.num_states, P=dims["P"],
        boundaries=cfg.enforce_boundaries, beam_threshold=beam_threshold,
        beam_width=beam_width)
    return cfg.topology.path_to_phones(paths), paths, scores


def frame_accuracy(phone_frames, labels, lengths):
    """Fraction of valid frames whose phone label is right."""
    T = labels.shape[-1]
    valid = (torch.arange(T, device=labels.device)[None, :]
             < lengths[:, None])
    correct = (phone_frames == labels) & valid
    return correct.sum() / valid.sum().clamp(min=1)
