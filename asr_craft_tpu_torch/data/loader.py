"""Batched, sharded utterance loader.

Replaces ``CRF_FeatureStreamManager`` (SURVEY.md §2.1): owns the train/cv
split, presentation order, per-utterance windowing/normalization, and — new
here — length-bucketed batching into dense padded ``(B, T)`` tensors and
data-parallel sharding across hosts ("stdin-piped feature streams become a
sharded audio-feature loader", BASELINE.json north_star).

Design notes (TPU-first):
- Batches are padded to a small set of fixed bucket lengths so XLA compiles
  a handful of shapes, not one per utterance.
- Sharding is by utterance index modulo ``(shard_id, num_shards)`` — each
  host constructs only its shard.
- The iterator state (epoch, position, RNG) is a small dict, checkpointable
  for exact resume (SURVEY.md §5 checkpoint/resume).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 16
    # bucket boundaries (max frames); utterances longer than the last bucket
    # are truncated to it.  Defaults cover 20..2000 frames in x2 steps.
    buckets: Sequence[int] = (128, 256, 512, 1024, 2048)
    shuffle: bool = True          # presentation order: random vs sequential
    drop_remainder: bool = False
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    # sparse feature batches (the QuickNet-sparse-stream analogue — data.sparse):
    # when set, batches carry ``sparse_idx``/``sparse_val`` (B, T, K) instead
    # of dense ``feats``.  Dense sources are top-K sparsified after transforms;
    # (indices, values)-tuple sources are padded as-is.
    sparse_k: Optional[int] = None


class UtteranceLoader:
    """Iterates dict batches: feats (B, T, D) f32, labels (B, T) i32,
    lengths (B,) i32, uids (B,) i32 (corpus indices; -1 for pad rows).
    Sparse mode (cfg.sparse_k set, or features given as (indices, values)
    tuples): ``sparse_idx`` (B, T, K) i32 + ``sparse_val`` (B, T, K) f32
    replace ``feats``."""

    def __init__(self, features: List[np.ndarray],
                 labels: Optional[List[np.ndarray]],
                 cfg: LoaderConfig,
                 transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 feat_dim: Optional[int] = None):
        self.cfg = cfg
        idx = np.arange(len(features))
        mine = idx[idx % cfg.num_shards == cfg.shard_id]
        self._features = [features[i] for i in mine]
        self._labels = None if labels is None else [labels[i] for i in mine]
        self._uids = mine.astype(np.int32)
        self._transform = transform
        self._epoch = 0
        self._feat_dim = feat_dim
        self._sparse_input = bool(self._features) and isinstance(
            self._features[0], tuple)
        if self._sparse_input:
            if transform is not None:
                raise ValueError("feature transforms are not supported on "
                                 "sparse (indices, values) inputs")
            if feat_dim is None:
                raise ValueError("sparse inputs need an explicit feat_dim")

    def __len__(self):
        return len(self._features)

    @property
    def is_sparse(self) -> bool:
        return self._sparse_input or self.cfg.sparse_k is not None

    @property
    def feat_dim(self) -> int:
        if self._feat_dim is not None:
            return self._feat_dim
        f = self._features[0]
        return (self._transform(f) if self._transform else f).shape[1]

    def _num_frames(self, i: int) -> int:
        f = self._features[i]
        return len(f[0]) if self._sparse_input else len(f)

    def _bucket_of(self, T: int) -> int:
        for b in self.cfg.buckets:
            if T <= b:
                return b
        return self.cfg.buckets[-1]

    def state(self) -> Dict:
        return {"epoch": self._epoch}

    def restore(self, state: Dict) -> None:
        self._epoch = int(state["epoch"])

    def epoch_batches(self, epoch: Optional[int] = None) -> Iterator[Dict]:
        """One epoch of batches; deterministic given (seed, epoch)."""
        cfg = self.cfg
        epoch = self._epoch if epoch is None else epoch
        order = np.arange(len(self._features))
        if cfg.shuffle:
            np.random.default_rng((cfg.seed, epoch)).shuffle(order)

        # group by bucket, preserve presentation order within a bucket
        groups: Dict[int, List[int]] = {}
        for i in order:
            b = self._bucket_of(self._num_frames(i))
            groups.setdefault(b, []).append(i)

        for b, members in groups.items():
            for k in range(0, len(members), cfg.batch_size):
                chunk = members[k:k + cfg.batch_size]
                if len(chunk) < cfg.batch_size and cfg.drop_remainder:
                    continue
                yield self._make_batch(chunk, b)
        self._epoch = epoch + 1

    def _make_batch(self, idxs: List[int], T: int) -> Dict:
        if self.is_sparse:
            return self._make_sparse_batch(idxs, T)
        B = self.cfg.batch_size
        first = self._features[idxs[0]]
        D = (self._transform(first) if self._transform else first).shape[1]
        feats = np.zeros((B, T, D), np.float32)
        labels = np.zeros((B, T), np.int32)
        lengths = np.zeros((B,), np.int32)
        uids = np.full((B,), -1, np.int32)
        for row, i in enumerate(idxs):
            f = self._features[i]
            if self._transform is not None:
                f = self._transform(f)
            n = min(len(f), T)
            feats[row, :n] = f[:n]
            if self._labels is not None:
                labels[row, :n] = self._labels[i][:n]
            lengths[row] = n
            uids[row] = self._uids[i]
        return {"feats": feats, "labels": labels, "lengths": lengths,
                "uids": uids}

    def _make_sparse_batch(self, idxs: List[int], T: int) -> Dict:
        from asr_craft_tpu_torch.data.sparse import sparsify_frames
        B = self.cfg.batch_size
        if self._sparse_input:
            K = self._features[idxs[0]][0].shape[1]
        else:
            K = min(self.cfg.sparse_k, self.feat_dim)
        sp_idx = np.zeros((B, T, K), np.int32)
        sp_val = np.zeros((B, T, K), np.float32)
        labels = np.zeros((B, T), np.int32)
        lengths = np.zeros((B,), np.int32)
        uids = np.full((B,), -1, np.int32)
        for row, i in enumerate(idxs):
            if self._sparse_input:
                idx_u, val_u = self._features[i]
                if idx_u.shape[1] != K:
                    raise ValueError("inconsistent sparse width K across "
                                     f"utterances ({idx_u.shape[1]} vs {K})")
            else:
                f = self._features[i]
                if self._transform is not None:
                    f = self._transform(f)
                idx_u, val_u = sparsify_frames(f, K)
            n = min(len(idx_u), T)
            sp_idx[row, :n] = idx_u[:n]
            sp_val[row, :n] = val_u[:n]
            if self._labels is not None:
                labels[row, :n] = self._labels[i][:n]
            lengths[row] = n
            uids[row] = self._uids[i]
        return {"sparse_idx": sp_idx, "sparse_val": sp_val, "labels": labels,
                "lengths": lengths, "uids": uids}


def train_cv_split(n: int, cv_fraction: float = 0.1, seed: int = 0):
    """Sentence-range train/cv split (the reference's train/cv stream split)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    ncv = max(1, int(round(n * cv_fraction))) if n > 1 else 0
    return np.sort(order[ncv:]), np.sort(order[:ncv])
