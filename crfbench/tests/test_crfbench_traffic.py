"""The traffic generator: one seed gives one set of inputs, every seed the
same lengths in another order, the lengths in the file's range, and phone
runs the topology can follow.

    python -m pytest crfbench/tests -q
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from crfbench import gen

TRAFFIC = Path(__file__).resolve().parent.parent / "traffic"
SEEDS = (2**31 + 5, 2**31 + 99, 7)


def _traffic(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(p.stem for p in TRAFFIC.glob("*.json")))
def test_every_seed_gets_the_same_lengths_in_its_own_order(name):
    t = _traffic(name)
    plans = [gen.plan_batches(t, s) for s in SEEDS]
    sets = [np.sort(np.concatenate([l for _, l in p])) for p in plans]
    assert all(np.array_equal(sets[0], x) for x in sets[1:])
    orders = [np.concatenate([l for _, l in p]) for p in plans]
    assert not np.array_equal(orders[0], orders[1])
    real = sets[0][sets[0] > 0]
    assert len(real) == t["utterances"]
    assert real.min() >= t["lengths"]["lo"]
    assert real.max() <= t["lengths"]["hi"]
    shapes = [[T for T, _ in p] for p in plans]
    assert all(s == shapes[0] for s in shapes[1:])
    for T, lengths in plans[0]:
        assert lengths.max() <= T
        assert lengths.max() > ([0] + [b for b in t["buckets"] if b < T])[-1]
        assert len(lengths) == t["batch"]


@pytest.mark.parametrize("name", sorted(p.stem for p in TRAFFIC.glob("*.json")))
def test_the_timit_mix_has_the_corpus_mean_and_a_tail_past_512(name):
    t = _traffic(name)
    lengths = gen.length_set(t["lengths"], t["utterances"])
    assert abs(lengths.mean() * 0.01 - 3.08) < 0.01
    assert 0.45 < (lengths < 300).mean() < 0.55
    assert 0.015 < (lengths > 512).mean() < 0.03
    assert 700 < lengths.max() < 800
    plan = gen.plan_batches(t, SEEDS[0])
    assert {T for T, _ in plan} == {128, 256, 512, 1024}
    # the largest bucket first, so a run's first call is a full group
    assert plan[0][0] == 512 and len(plan[0][1]) == (plan[0][1] > 0).sum()


def test_the_loaders_batches_and_the_trainers_groups():
    t = {"batch": 4, "utterances": 23, "buckets": [8, 16, 32],
         "lengths": {"dist": "uniform", "lo": 5, "hi": 30}}
    plan = gen.plan_batches(t, 11)
    for T, lengths in plan:
        assert lengths.max() <= T
    # a bucket's last batch holds empty rows; every other is full
    for T in {T for T, _ in plan}:
        rows = [l for b, l in plan if b == T]
        assert all((l > 0).all() for l in rows[:-1])
    calls = gen.calls(plan, 2)
    assert sorted(i for c in calls for i in c) == list(range(len(plan)))
    for c in calls:
        assert 1 <= len(c) <= 2 and len({plan[i][0] for i in c}) == 1
    with pytest.raises(ValueError):
        gen.bucket_of(33, t["buckets"])


def test_one_seed_gives_one_set_of_inputs():
    t = {"batch": 3, "utterances": 6, "buckets": [24],
         "lengths": {"dist": "uniform", "lo": 9, "hi": 24}}
    a, b, c = (gen.make_batches(gen.plan_batches(t, s), 5, 4, (3, 6), s,
                                "cpu") for s in (SEEDS[0], SEEDS[0],
                                                 SEEDS[1]))
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["feats"], c[0]["feats"])


def test_padding_is_zero_and_phone_runs_fit_three_states():
    t = {"batch": 16, "utterances": 30, "buckets": [64],
         "lengths": {"dist": "uniform", "lo": 30, "hi": 64}}
    for b in gen.make_batches(gen.plan_batches(t, 5), 4, 6, (3, 12), 5,
                              "cpu"):
        for f, lab, n in zip(b["feats"], b["labels"], b["lengths"]):
            n = int(n)
            assert not f[n:].any() and not lab[n:].any()
            if n == 0:                       # an empty row fills a batch
                continue
            cuts = np.flatnonzero(np.diff(lab[:n].numpy())) + 1
            runs = np.diff(np.concatenate([[0], cuts, [n]]))
            assert runs.min() >= 3


def test_weights_come_from_the_seed():
    shapes = {"b": (3,), "a": (2, 4)}
    x = gen.init_params(shapes, 0.5, 2**31 + 3, "cpu")
    y = gen.init_params(shapes, 0.5, 2**31 + 3, "cpu")
    assert all(torch.equal(x[k], y[k]) for k in shapes)
    assert x["a"].shape == (2, 4)
