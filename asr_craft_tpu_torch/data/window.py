"""Frame-level feature transforms: context windows, deltas, normalization,
stream concatenation.

Replaces the windowing/concatenation/normalization duties of
``CRF_FeatureStream`` / ``CRF_FeatureStreamManager`` (SURVEY.md §2.1): the
reference concatenates up to three QuickNet streams (e.g. MLP posteriors ⊕
MFCC — "Crandem"), applies a +/-w context window (``window_extent``), and
normalizes.  Here these are pure NumPy array ops applied per utterance in the
loader (host-side, off the TPU hot path).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def context_window(feats: np.ndarray, extent: int) -> np.ndarray:
    """Concatenate +/-extent context frames: (T, D) -> (T, D * (2*extent+1)).

    Edges replicate the first/last frame (QuickNet windowed-stream
    behaviour)."""
    if extent == 0:
        return feats
    T, D = feats.shape
    padded = np.concatenate([
        np.repeat(feats[:1], extent, axis=0),
        feats,
        np.repeat(feats[-1:], extent, axis=0),
    ])
    return np.concatenate(
        [padded[i:i + T] for i in range(2 * extent + 1)], axis=1)


def deltas(feats: np.ndarray, window: int = 2) -> np.ndarray:
    """HTK-style regression deltas: (T, D) -> (T, D)."""
    T, D = feats.shape
    denom = 2 * sum(i * i for i in range(1, window + 1))
    padded = np.concatenate([
        np.repeat(feats[:1], window, axis=0),
        feats,
        np.repeat(feats[-1:], window, axis=0),
    ])
    out = np.zeros_like(feats)
    for i in range(1, window + 1):
        out += i * (padded[window + i:window + i + T]
                    - padded[window - i:window - i + T])
    return out / denom


def add_deltas(feats: np.ndarray, order: int = 2, window: int = 2) -> np.ndarray:
    """Append delta (order>=1) and delta-delta (order>=2) blocks."""
    blocks = [feats]
    cur = feats
    for _ in range(order):
        cur = deltas(cur, window)
        blocks.append(cur)
    return np.concatenate(blocks, axis=1)


class Normalizer:
    """Mean/variance normalization, global or per-utterance.

    Global statistics are accumulated over a training pass (the reference
    reads QuickNet norm files; here stats are computed and stored with the
    checkpoint)."""

    def __init__(self, mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None):
        self.mean, self.std = mean, std

    @classmethod
    def fit(cls, utterances: List[np.ndarray]) -> "Normalizer":
        n, s, ss = 0, 0.0, 0.0
        for u in utterances:
            n += len(u)
            s = s + u.sum(axis=0)
            ss = ss + (u.astype(np.float64) ** 2).sum(axis=0)
        mean = s / n
        var = ss / n - mean ** 2
        return cls(mean.astype(np.float32),
                   np.sqrt(np.maximum(var, 1e-8)).astype(np.float32))

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        return (feats - self.mean) / self.std

    @staticmethod
    def per_utterance(feats: np.ndarray) -> np.ndarray:
        m = feats.mean(axis=0)
        s = feats.std(axis=0) + 1e-8
        return (feats - m) / s


def concat_streams(*streams: np.ndarray) -> np.ndarray:
    """ftr1 ⊕ ftr2 ⊕ ftr3 concatenation (Crandem: posteriors + MFCC)."""
    T = streams[0].shape[0]
    for s in streams[1:]:
        if s.shape[0] != T:
            raise ValueError("stream frame-count mismatch")
    return np.concatenate(streams, axis=1)
