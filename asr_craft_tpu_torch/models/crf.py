"""The CRF model: config, parameters, potentials, training criterion and
decode.

Counterpart of :mod:`asr_craft_tpu.models.crf`.  Ported so far:

- the frame-dependent-transition (fdt) path — ``crf_loss`` (the
  dual-lattice objective of :func:`asr_craft_tpu_torch.ops.fdt.fdt_nll_dual`:
  the K1/K2 kernels or the plain autograd loop), ``decode`` (the factored
  Viterbi, :mod:`asr_craft_tpu_torch.kernels.fdt_viterbi`),
  ``frame_posteriors`` — for dense and sparse inputs (sparse frames are
  densified exactly);
- the shared-transition ``decode`` (``potentials``, then the K7/K8 kernels
  of :mod:`asr_craft_tpu_torch.kernels.viterbi`), dense and sparse;
- ``potentials``, ``apply_boundaries`` and ``frame_accuracy``.

The shared-transition ``crf_loss`` and ``frame_posteriors`` raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels.fdt_viterbi import fdt_viterbi_wall
from asr_craft_tpu_torch.kernels.viterbi import viterbi_shared
from asr_craft_tpu_torch.kernels.wall import build_wall
from asr_craft_tpu_torch.models.feature_map import (FeatureMapConfig,
                                                    dense_potentials,
                                                    densify_sparse,
                                                    sparse_potentials)
from asr_craft_tpu_torch.models.topology import Topology
from asr_craft_tpu_torch.ops import fdt


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


def _check_precision(cfg: CrfConfig, tensor) -> None:
    """Raise for a precision other than ``highest`` where a kernel would
    serve ``tensor``: the kernels are IEEE fp32 only."""
    if kernels.use_kernel(tensor) and cfg.precision != "highest":
        raise NotImplementedError(
            f"precision {cfg.precision!r} on the CUDA kernels (only "
            "'highest', IEEE fp32, is ported; ROADMAP.md Queue 2)")


def _fdt_feats(cfg: CrfConfig, feats, sparse, what: str,
               on_kernel: bool = True):
    """The dense frames of the fdt path: ``feats``, or ``sparse =
    (indices, values)`` densified exactly with a sparse feature map.
    Raises for the shared-transition path (whose training criterion and
    posteriors are still to port) and, where a kernel would run
    (``on_kernel``), for a precision other than ``highest``."""
    if not cfg.fmap.frame_dependent_trans:
        raise NotImplementedError(
            f"shared-transition {what} (trans_range of zero width) is not "
            "ported yet (ROADMAP.md Queue 1, slice 3b)")
    if cfg.featuremap == "sparse":
        if sparse is None:
            raise ValueError(
                "sparse feature map needs sparse=(indices, values)")
        feats = densify_sparse(sparse[0], sparse[1], cfg.feat_dim)
    feats = feats.contiguous()
    if on_kernel:
        _check_precision(cfg, feats)
    return feats


@functools.lru_cache(maxsize=None)
def _penalties(topo: Topology, device: torch.device):
    """The topology's (transition (L', L'), start (L',), end (L',))
    penalties on ``device``, copied there once: a copy from pageable host
    memory in every call would wait for the device's queue to drain."""
    return tuple(torch.from_numpy(a).to(device) for a in (
        topo.transition_penalty(), topo.start_penalty(), topo.end_penalty()))


def potentials(cfg: CrfConfig, params: dict, feats, sparse=None):
    """Feature frames -> (state (B, T, L'), trans (L', L') or (B, T, L',
    L')), the n-state structural mask folded into ``trans`` as an additive
    NEG_INF penalty.  ``feats (B, T, D)``, or ``sparse = (indices, values)``
    (B, T, K) each with a sparse feature map (``feats`` ignored).  fp32
    matmuls (IEEE: TF32 stays off, the PyTorch default)."""
    if cfg.featuremap == "sparse":
        if sparse is None:
            raise ValueError(
                "sparse feature map needs sparse=(indices, values)")
        state, trans = sparse_potentials(cfg.fmap, params, *sparse)
    else:
        state, trans = dense_potentials(cfg.fmap, params, feats)
    if cfg.num_states > 1:
        trans = trans + _penalties(cfg.topology, trans.device)[0]
    return state, trans


def apply_boundaries(cfg: CrfConfig, state, lengths):
    """Fold start/end state masking into the state potentials ``(B, T,
    L')``: frame 0 is restricted to phone entry states and frame
    ``length-1`` to phone exit states.  Identity for monophone or
    ``enforce_boundaries=False``."""
    if cfg.num_states == 1 or not cfg.enforce_boundaries:
        return state
    T = state.shape[-2]
    _, start, end = _penalties(cfg.topology, state.device)
    state = state.clone()
    state[..., 0, :] += start
    at_end = (torch.arange(T, device=state.device)[None, :]
              == (lengths.to(state.device) - 1)[:, None])
    return state + torch.where(at_end[..., None], end, 0.0)


def crf_loss(cfg: CrfConfig, params: dict, feats, labels, lengths,
             sparse=None, label_kind: str = "phone",
             grad_feats: bool = False):
    """Mean negative conditional log-likelihood per frame.

    ``labels``: (B, T) int32 frame labels — phone labels by default, or
    expanded-state labels with ``label_kind='state'``.  Rows of length 0
    (loader padding) contribute 0, and the sum is divided by
    ``max(sum(lengths), 1)``.  Returns (loss, aux) with per-utterance
    ``logZ``, ``numerator`` and ``nll`` and the ``frames`` count.

    ``grad_feats``: when False (the default) ``feats`` is detached, so no
    gradient reaches it; set True to differentiate through the features.
    """
    feats = _fdt_feats(cfg, feats, sparse, "training criterion")
    lengths = lengths.to(feats.device)
    clamp_ns = 1 if label_kind == "state" else cfg.num_states
    raw_nll, logZ, num = fdt.fdt_nll_dual(
        cfg.fmap, cfg.num_states, params, feats, labels.to(feats.device),
        lengths, clamp_ns, cfg.enforce_boundaries, grad_feats=grad_feats)
    nll = torch.where(lengths > 0, raw_nll, 0.0)
    total_frames = torch.clamp(lengths.sum(), min=1)
    return nll.sum() / total_frames, {
        "logZ": logZ, "numerator": num, "nll": nll, "frames": total_frames}


def decode(cfg: CrfConfig, params: dict, feats, lengths, sparse=None,
           beam_width: Optional[int] = None,
           beam_threshold: Optional[float] = None):
    """Batched Viterbi over expanded states, collapsed to per-frame phones.

    ``feats (B, T, D)`` float32 (or ``sparse = (indices, values)`` with a
    sparse feature map) and ``lengths (B,)`` on one device; beam options as
    in the JAX package (both None = exact).  Returns
    (phone_frames (B, T), state_paths (B, T), scores (B,)), on that device.
    Frame-dependent transitions run the factored K3 decode; shared ones the
    K8 n-state kernel (n states, P <= 128) or the dense K7 kernel.
    """
    if not cfg.fmap.frame_dependent_trans:
        return _decode_shared(cfg, params, feats, lengths, sparse,
                              beam_width, beam_threshold)
    feats = _fdt_feats(cfg, feats, sparse, "decode")
    Wall, u0, u1, dims = build_wall(params, cfg.fmap, cfg.num_states)
    paths, scores = fdt_viterbi_wall(
        Wall, feats, lengths.to(device=feats.device, dtype=torch.int32),
        u0=u0, u1=u1, ns=cfg.num_states, P=dims["P"],
        boundaries=cfg.enforce_boundaries, beam_threshold=beam_threshold,
        beam_width=beam_width)
    return cfg.topology.path_to_phones(paths), paths, scores


def _decode_shared(cfg: CrfConfig, params: dict, feats, lengths, sparse,
                   beam_width, beam_threshold):
    """The shared-transition decode: potentials, boundaries, then K8 (the
    topology-factored kernel, for n states and P <= 128) or K7 (dense)."""
    state, trans = potentials(cfg, params, feats, sparse)
    lengths = lengths.to(device=state.device, dtype=torch.int32)
    state = apply_boundaries(cfg, state, lengths).contiguous()
    trans = trans.contiguous()
    _check_precision(cfg, state)
    paths, scores = viterbi_shared(state, trans, lengths, cfg.num_states,
                                   beam_threshold, beam_width)
    return cfg.topology.path_to_phones(paths), paths, scores


def frame_posteriors(cfg: CrfConfig, params: dict, feats, lengths,
                     sparse=None):
    """(B, T, L') label posteriors over the factored frame-dependent
    lattice (:func:`asr_craft_tpu_torch.ops.fdt.fdt_posteriors`); zero at
    frames past each length."""
    feats = _fdt_feats(cfg, feats, sparse, "posteriors", on_kernel=False)
    planes = fdt.factored_planes(params, feats, cfg.fmap.num_expanded,
                                 cfg.num_states, cfg.fmap.state_range,
                                 cfg.fmap.trans_range,
                                 cfg.fmap.use_state_bias)
    return fdt.fdt_posteriors(*planes, lengths, cfg.num_states,
                              cfg.enforce_boundaries)


def frame_accuracy(phone_frames, labels, lengths):
    """Fraction of valid frames whose phone label is right."""
    T = labels.shape[-1]
    valid = (torch.arange(T, device=labels.device)[None, :]
             < lengths[:, None])
    correct = (phone_frames == labels) & valid
    return correct.sum() / valid.sum().clamp(min=1)
