"""The one traffic generator: reads a traffic file's parameters and makes a
cell's inputs and weights from ``--seed``.

A pool is one pass over a corpus of ``utterances`` utterances, batched as
the port's loader (``data/loader.py``) batches an epoch: each utterance
goes to the smallest of ``buckets`` that holds it, each bucket's
utterances are cut into batches of ``batch`` rows in the seed's order, and
a bucket's last batch is filled up with empty rows (length 0).  Every seed
gets the same multiset of lengths (the quantiles of the file's length
distribution), so the same number of batches in each bucket and the same
frames; two seeds differ in which utterances share a batch and in the
numbers of the inputs, not in the amount of work.  The pool lists the
buckets by their count of batches, the largest first.  Frame
features are N(0, 1) (globally normalised features), made on the device in
one call from a ``torch.Generator`` seeded by the seed; padding
frames are zero, as the loader leaves them.  Phone labels come in runs of
``phone_run = [lo, hi]`` frames (at least the topology's states, so every
clamped lattice has a path), the last run ending with the utterance.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

SEED_MIX = 0x9E3779B97F4A7C15        # spreads (seed, stream) over 64 bits


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (the plan, the labels, the
    frames, the weights, the sample checked: ``(0, k)``)."""
    h = int(seed) & ((1 << 64) - 1)
    for s in stream:
        h = (h * SEED_MIX + int(s) + 1) & ((1 << 64) - 1)
    return h >> 1


def length_set(spec: dict, n: int) -> np.ndarray:
    """The ``n`` lengths of a distribution at its quantiles (i + 0.5) / n:
    ``uniform`` over the integers ``[lo, hi]``, or ``lognormal`` with its
    ``median`` (frames) and ``sigma`` (of the log), rounded and held to
    ``[lo, hi]``."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = int(spec["lo"]), int(spec["hi"])
    if spec["dist"] == "uniform":
        return (lo + np.floor(q * (hi - lo + 1))).astype(np.int64)
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in q])
        v = np.rint(float(spec["median"]) * np.exp(float(spec["sigma"]) * z))
        return np.clip(v, lo, hi).astype(np.int64)
    raise ValueError(f"length distribution {spec['dist']!r}")


def bucket_of(n: int, buckets) -> int:
    """The smallest bucket that holds ``n`` frames (the loader's rule)."""
    for b in buckets:
        if n <= b:
            return int(b)
    raise ValueError(f"{n} frames: longer than the last bucket")


def phone_labels(rng: np.random.Generator, lengths: np.ndarray, T: int,
                 run: tuple, n_phones: int) -> np.ndarray:
    """(rows, T) int32 phone labels: runs of ``run[0]..run[1]`` frames, each
    a phone drawn uniformly; a last run shorter than ``run[0]`` joins the
    run before it; zero past each length."""
    lo, hi = int(run[0]), int(run[1])
    rows = len(lengths)
    n_runs = T // lo + 1
    runs = rng.integers(lo, hi + 1, size=(rows, n_runs))
    phones = rng.integers(0, n_phones, size=(rows, n_runs))
    ends = np.cumsum(runs, axis=1)
    out = np.zeros((rows, T), np.int32)
    t = np.arange(T)
    for r, n in enumerate(lengths):
        idx = np.searchsorted(ends[r], t[:n], side="right")
        last = idx[n - 1] if n else 0
        start = ends[r, last - 1] if last else 0
        if last and n - start < lo:                # too short: merge back
            idx[start:n] = last - 1
        out[r, :n] = phones[r, idx]
    return out


def plan_batches(traffic: dict, seed: int) -> list:
    """The pool: ``[(T, lengths (B,))]``, one pass over ``utterances``
    lengths in the seed's order, bucketed and batched as the loader does
    (see the module's docstring)."""
    rng = np.random.default_rng(stream_seed(seed, 0, 1))
    B = int(traffic["batch"])
    lengths = rng.permutation(length_set(traffic["lengths"],
                                         int(traffic["utterances"])))
    groups = {}
    for n in lengths:
        groups.setdefault(bucket_of(int(n), traffic["buckets"]), []).append(n)
    plan = []
    for T in sorted(groups, key=lambda T: (-math.ceil(len(groups[T]) / B),
                                           T)):
        rows = np.asarray(groups[T], np.int64)
        for i in range(0, len(rows), B):
            batch = np.zeros(B, np.int64)
            batch[:len(rows[i:i + B])] = rows[i:i + B]
            plan.append((T, batch))
    return plan


def calls(plan: list, k: int) -> list:
    """The trainer's calls over the pool: consecutive batches of one shape
    ``k`` at a time, a shorter group where the shape changes or the pool
    ends (``Trainer.train_epoch``'s grouping); lists of pool indices."""
    out = []
    for i, (T, _) in enumerate(plan):
        if out and len(out[-1]) < k and plan[out[-1][0]][0] == T:
            out[-1].append(i)
        else:
            out.append([i])
    return out


def make_batches(plan: list, feat_dim: int, n_phones: int, run: tuple,
                 seed: int, device) -> list:
    """The planned batches as device tensors ``{"feats" (B, T, D) f32,
    "labels" (B, T) i32, "lengths" (B,) i32}``: the features of each shape
    drawn in one call."""
    rng = np.random.default_rng(stream_seed(seed, 0, 2))
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 0, 3))
    out = [None] * len(plan)
    for T in sorted({T for T, _ in plan}):
        idx = [i for i, (t, _) in enumerate(plan) if t == T]
        B = len(plan[idx[0]][1])
        feats = torch.randn((len(idx), B, T, feat_dim), generator=gen,
                            device=device)
        lens = np.stack([plan[i][1] for i in idx])
        mask = (torch.arange(T, device=device)[None, None, :]
                < torch.from_numpy(lens).to(device)[:, :, None])
        feats.mul_(mask[..., None])
        for j, i in enumerate(idx):
            labels = phone_labels(rng, lens[j], T, run, n_phones)
            out[i] = {"feats": feats[j],
                      "labels": torch.from_numpy(labels).to(device),
                      "lengths": torch.from_numpy(
                          lens[j].astype(np.int32)).to(device)}
    return out


def init_params(shapes: dict, std: float, seed: int, device) -> dict:
    """Weights N(0, std^2), biases N(0, std^2) too, drawn on the device in
    one call, in sorted-name order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 0, 5))
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    flat = torch.randn(sum(sizes), generator=gen, device=device) * std
    out, at = {}, 0
    for k, n in zip(names, sizes):
        out[k] = flat[at:at + n].reshape(shapes[k]).clone()
        at += n
    return out
