"""The CRF model: config, parameters, potentials, training criterion and
decode.

Counterpart of :mod:`asr_craft_tpu.models.crf`:

- the frame-dependent-transition (fdt) path — ``crf_loss`` (the
  dual-lattice objective of :func:`asr_craft_tpu_torch.ops.fdt.fdt_nll_dual`:
  the K1/K2 kernels or the plain autograd loop), ``decode`` (the factored
  Viterbi, :mod:`asr_craft_tpu_torch.kernels.fdt_viterbi`),
  ``frame_posteriors`` — for dense and sparse inputs (sparse frames are
  densified exactly);
- the shared-transition path — ``potentials`` and ``apply_boundaries``,
  then ``crf_loss`` (:func:`asr_craft_tpu_torch.ops.mxu.nll_dual`: the K4/K5
  kernels), ``frame_posteriors`` (``posteriors_mxu``: K6a/K6b) and
  ``decode`` (the K7/K8 kernels of
  :mod:`asr_craft_tpu_torch.kernels.viterbi`), dense and sparse;
- ``frame_accuracy``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from asr_craft_tpu_torch.kernels.fdt_viterbi import fdt_viterbi_wall
from asr_craft_tpu_torch.kernels.viterbi import viterbi_shared
from asr_craft_tpu_torch.kernels.wall import build_wall
from asr_craft_tpu_torch.models.feature_map import (FeatureMapConfig,
                                                    dense_potentials,
                                                    densify_sparse,
                                                    sparse_potentials)
from asr_craft_tpu_torch.models import segmental as seg_mod
from asr_craft_tpu_torch.models.topology import Topology
from asr_craft_tpu_torch.ops import fdt, fwdbwd, mxu
from asr_craft_tpu_torch.ops.semiring import NEG_INF


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
            precision=self.precision,
        )

    def init_params(self, generator: Optional[torch.Generator] = None,
                    scale: float = 0.0, device="cpu") -> dict:
        return self.fmap.init_params(generator, scale, device)


def _fdt_feats(cfg: CrfConfig, feats, sparse):
    """The dense frames of the fdt path: ``feats``, or ``sparse =
    (indices, values)`` densified exactly with a sparse feature map."""
    if cfg.featuremap == "sparse":
        if sparse is None:
            raise ValueError(
                "sparse feature map needs sparse=(indices, values)")
        feats = densify_sparse(sparse[0], sparse[1], cfg.feat_dim)
    return feats.contiguous()


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
    (B, T, K) each with a sparse feature map (``feats`` ignored).  The dense
    map's products in ``cfg.precision``
    (:mod:`asr_craft_tpu_torch.ops.precision`; the sparse map is a gather
    and a weighted sum, fp32 in every mode, as in the JAX package)."""
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

    ``grad_feats`` (fdt path): when False (the default) ``feats`` is
    detached, so no gradient reaches it; set True to differentiate through
    the features.  On the shared-transition path, as in the JAX package,
    the flag is not read: autograd carries the state gradient through the
    potentials matmul to whatever requires it.

    The criterion of both CRF families: a segmental CRF's config
    (:class:`asr_craft_tpu_torch.models.segmental.SegCrfConfig`) takes
    :func:`~asr_craft_tpu_torch.models.segmental.scrf_loss_fused` (``sparse``,
    ``label_kind`` and ``grad_feats`` are the linear chain's).
    """
    if isinstance(cfg, seg_mod.SegCrfConfig):
        return seg_mod.scrf_loss_fused(cfg, params, feats, labels, lengths)
    clamp_ns = 1 if label_kind == "state" else cfg.num_states
    if cfg.fmap.frame_dependent_trans:
        feats = _fdt_feats(cfg, feats, sparse)
        lengths = lengths.to(feats.device)
        raw_nll, logZ, num = fdt.fdt_nll_dual(
            cfg.fmap, cfg.num_states, params, feats, labels.to(feats.device),
            lengths, clamp_ns, cfg.enforce_boundaries, grad_feats=grad_feats)
    else:
        raw_nll, logZ, num, lengths = _shared_nll(
            cfg, params, feats, labels, lengths, sparse, clamp_ns)
    # empty rows (length 0: loader batch padding) are inert
    nll = torch.where(lengths > 0, raw_nll, 0.0)
    total_frames = torch.clamp(lengths.sum(), min=1)
    return nll.sum() / total_frames, {
        "logZ": logZ, "numerator": num, "nll": nll, "frames": total_frames}


def _shared_potentials(cfg: CrfConfig, params: dict, feats, lengths, sparse):
    """The shared-transition path's DP inputs: ``(state (B, T, L') with the
    boundaries folded in, trans, lengths)`` on the potentials' device."""
    state, trans = potentials(cfg, params, feats, sparse)
    lengths = lengths.to(device=state.device, dtype=torch.int32)
    return apply_boundaries(cfg, state, lengths), trans, lengths


def _shared_nll(cfg: CrfConfig, params: dict, feats, labels, lengths, sparse,
                clamp_ns: int):
    """``(nll, logZ, numerator, lengths)`` of the shared-transition
    criterion: the fused dual-lattice objective for one ``(L', L')``
    transition matrix (:func:`asr_craft_tpu_torch.ops.mxu.nll_dual`), the
    generic scan otherwise."""
    state, trans, lengths = _shared_potentials(cfg, params, feats, lengths,
                                               sparse)
    labels = labels.to(state.device)
    if trans.dim() == 2:
        return (*mxu.nll_dual(state, trans, labels, lengths, clamp_ns),
                lengths)
    logZ = fwdbwd.log_partition_batch(state, trans, lengths)
    lane = torch.arange(state.shape[-1], device=state.device)
    clamp = torch.where(lane // clamp_ns == labels[..., None].long(), 0.0,
                        NEG_INF)
    num = fwdbwd.log_partition_batch(state + clamp, trans, lengths)
    return logZ - num, logZ, num, lengths


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
    feats = _fdt_feats(cfg, feats, sparse)
    Wall, u0, u1, dims = build_wall(params, cfg.fmap, cfg.num_states)
    paths, scores = fdt_viterbi_wall(
        Wall, feats, lengths.to(device=feats.device, dtype=torch.int32),
        u0=u0, u1=u1, ns=cfg.num_states, P=dims["P"],
        boundaries=cfg.enforce_boundaries, beam_threshold=beam_threshold,
        beam_width=beam_width, precision=cfg.precision)
    return cfg.topology.path_to_phones(paths), paths, scores


def _decode_shared(cfg: CrfConfig, params: dict, feats, lengths, sparse,
                   beam_width, beam_threshold):
    """The shared-transition decode: potentials, boundaries, then K8 (the
    topology-factored kernel, for n states and P <= 128) or K7 (dense)."""
    state, trans, lengths = _shared_potentials(cfg, params, feats, lengths,
                                               sparse)
    paths, scores = viterbi_shared(state.contiguous(), trans.contiguous(),
                                   lengths, cfg.num_states, beam_threshold,
                                   beam_width)
    return cfg.topology.path_to_phones(paths), paths, scores


def frame_posteriors(cfg: CrfConfig, params: dict, feats, lengths,
                     sparse=None):
    """(B, T, L') label posteriors, zero at frames past each length: over
    the factored frame-dependent lattice
    (:func:`asr_craft_tpu_torch.ops.fdt.fdt_posteriors`), or for shared
    transitions :func:`asr_craft_tpu_torch.ops.mxu.posteriors_mxu` (the
    K6a/K6b kernels)."""
    if not cfg.fmap.frame_dependent_trans:
        state, trans, lengths = _shared_potentials(cfg, params, feats,
                                                   lengths, sparse)
        if trans.dim() == 2:
            return mxu.posteriors_mxu(state, trans, lengths)
        return fwdbwd.posteriors_batch(state, trans, lengths)
    feats = _fdt_feats(cfg, feats, sparse)
    planes = fdt.factored_planes(params, feats, cfg.fmap.num_expanded,
                                 cfg.num_states, cfg.fmap.state_range,
                                 cfg.fmap.trans_range,
                                 cfg.fmap.use_state_bias, cfg.precision)
    return fdt.fdt_posteriors(*planes, lengths, cfg.num_states,
                              cfg.enforce_boundaries)


def frame_accuracy(phone_frames, labels, lengths):
    """Fraction of valid frames whose phone label is right."""
    T = labels.shape[-1]
    valid = (torch.arange(T, device=labels.device)[None, :]
             < lengths[:, None])
    correct = (phone_frames == labels) & valid
    return correct.sum() / valid.sum().clamp(min=1)
