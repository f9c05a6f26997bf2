"""The segmental CRF (config 4) through the port's ``Trainer``, on the CPU:
its steps (``train_step``, ``multi_step``) against the benchmark's float64
reference (``crfbench/reference/scrf_train.py``), its CV pass against
``scrf_frame_labels``, its weight files, the n-state model's eager steps;
the benchmark's ``scrf-train`` cell at a small size (its label draw, its
comparison with planted faults, its per-layer readers); and the spans and
counters the segmental path records.

Tolerances: the port computes in float32, the reference in float64.  A
loss of a T=32 lattice is a sum of ~32 log-sum-exps of float32 terms, each
~1e-7 relative, so losses agree to rtol 2e-6; gradients and their norm,
sums of posteriors over the lattice, to rtol 2e-5; parameters after two
SGD steps at lr 0.05 move by lr x gradient, atol 1e-6.

    python -m pytest tests/test_torch_trainer_segmental.py -q
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from asr_craft_tpu_torch.models import segmental as seg_mod
from asr_craft_tpu_torch.models import weights as weights_mod
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.models.segmental import SegCrfConfig
from asr_craft_tpu_torch.train import TrainConfig, Trainer, graphs
from asr_craft_tpu_torch.utils import diagnostics
from asr_craft_tpu_torch.utils.logging import MetricsLogger
from crfbench import faults, gen, harness, roofline_scrf
from crfbench.modes import scrf_train
from crfbench.reference import scrf_train as ref

ROOT = Path(__file__).resolve().parent.parent
L, D, DMAX, B, T, K = 6, 12, 4, 4, 32, 2
LR = 0.05
QUIET = MetricsLogger(quiet=True)


def _batch(seed, lengths=(32, 20, 9, 0)):
    """N(0, 1) frames (zero past each length) and labels in runs of 1 to
    DMAX frames, adjacent runs of distinct labels."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    feats = torch.randn(B, T, D, generator=g)
    feats *= (torch.arange(T)[None, :, None] < lengths[:, None, None])
    rng = np.random.default_rng(seed)
    labels = scrf_train.segment_labels(rng, lengths.numpy(), T, (1, DMAX),
                                       L, DMAX)
    return {"feats": feats, "labels": torch.from_numpy(labels),
            "lengths": lengths}


def _params(seed=0, cfg=None):
    cfg = cfg or SegCrfConfig(num_labels=L, feat_dim=D, max_dur=DMAX)
    return cfg.init_params(torch.Generator().manual_seed(seed), 0.3)


def _trainer(cfg=None, **tc):
    cfg = cfg or SegCrfConfig(num_labels=L, feat_dim=D, max_dur=DMAX)
    return Trainer(cfg, TrainConfig(lr=LR, prefetch=0, **tc),
                   params=_params(0, cfg), logger=QUIET, device="cpu")


def _check_against_reference(tr, losses, gnorms, batches):
    want = scrf_train.reference_train(_params(0), batches, LR, DMAX, "cpu")
    np.testing.assert_allclose(np.asarray(losses, np.float64),
                               want["losses"], rtol=2e-6)
    np.testing.assert_allclose(np.asarray(gnorms, np.float64),
                               want["grad_norms"], rtol=2e-5)
    for k, p in tr.params.items():
        np.testing.assert_allclose(p.detach().double().numpy(),
                                   want["params"][-1][k].numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=k)


def test_multi_step_matches_the_reference():
    tr = _trainer(steps_per_call=K)
    batches = [_batch(1), _batch(2)]
    m = tr.multi_step(batches, LR)
    assert m["loss"].shape == (K,)
    _check_against_reference(tr, m["loss"], m["grad_norm"], batches)
    assert torch.equal(m["frames"], torch.tensor([61, 61]))


def test_train_step_matches_the_reference():
    tr = _trainer()
    batches = [_batch(3), _batch(4, (32, 32, 31, 1))]
    ms = [tr.train_step(b, LR) for b in batches]
    _check_against_reference(tr, [m["loss"] for m in ms],
                             [m["grad_norm"] for m in ms], batches)


class _Loader:
    """The loader's interface the trainer reads: an epoch's batches."""

    def __init__(self, batches):
        self.batches = [{k: v.numpy() for k, v in b.items()}
                        for b in batches]

    def epoch_batches(self, epoch):
        return iter(self.batches)


def test_evaluate_scores_the_frames_of_scrf_frame_labels():
    tr = _trainer()
    batches = [_batch(5), _batch(6, (30, 29, 3, 2))]
    got = tr.evaluate(_Loader(batches))
    correct = valid = 0
    losses = []
    for b in batches:
        frames, _ = seg_mod.scrf_frame_labels(tr.cfg, tr.params, b["feats"],
                                              b["lengths"])
        live = torch.arange(T)[None, :] < b["lengths"][:, None]
        correct += int(((frames == b["labels"]) & live).sum())
        valid += int(live.sum())
        with torch.no_grad():
            losses.append(float(seg_mod.scrf_loss_fused(
                tr.cfg, tr.params, b["feats"], b["labels"],
                b["lengths"])[0]))
    assert got["frame_accuracy"] == correct / valid
    assert got["cv_loss"] == pytest.approx(np.mean(losses), rel=1e-6)


def test_an_epoch_groups_its_steps_and_writes_npz_weights(tmp_path):
    tr = _trainer(steps_per_call=K, out_dir=str(tmp_path))
    batches = [_batch(s) for s in (7, 8, 9)]
    out = tr.train_epoch(_Loader(batches))
    assert tr.step == 3 and out["frames"] == 3 * 61
    saved = weights_mod.load_npz(tmp_path / "weights.i0.npz")
    assert set(saved) == set(tr.params)
    for k, p in tr.params.items():
        assert torch.equal(saved[k], p.detach()), k
    ref_tr = _trainer()
    ms = [ref_tr.train_step(b, LR) for b in batches]
    np.testing.assert_allclose(out["mean_loss"],
                               np.mean([float(m["loss"]) for m in ms]),
                               rtol=1e-6)


def test_the_n_state_model_steps_eagerly():
    cfg = SegCrfConfig(num_labels=L, feat_dim=D, max_dur=DMAX, num_states=2)
    tr = _trainer(cfg)
    assert tr.model.eager
    with tr._eager():
        assert not graphs.enabled()
    b = _batch(10)
    want, _ = seg_mod.scrf_loss(cfg, tr.params, b["feats"], b["labels"],
                                b["lengths"])
    m = tr.train_step(b, LR)
    assert float(m["loss"]) == pytest.approx(float(want.detach()),
                                             rel=1e-5)


def test_the_linear_chain_model_keeps_its_criterion_and_files(tmp_path):
    cfg = CrfConfig(num_labels=3, feat_dim=4, num_states=1)
    tr = Trainer(cfg, TrainConfig(out_dir=str(tmp_path), prefetch=0),
                 logger=QUIET, device="cpu")
    assert not tr.model.eager
    with tr._eager():
        assert graphs.enabled()
    g = torch.Generator().manual_seed(0)
    batch = {"feats": torch.randn(2, 8, 4, generator=g),
             "labels": torch.randint(0, 3, (2, 8), generator=g,
                                     dtype=torch.int32),
             "lengths": torch.tensor([8, 5], dtype=torch.int32)}
    tr.train_epoch(_Loader([batch]))
    assert (tmp_path / "weights.i0.dat").is_file()
    assert not list(tmp_path.glob("*.npz"))


# ---------------------------------------------------------------------------
# the benchmark's cell: its labels, its comparison, its readers
# ---------------------------------------------------------------------------

TRAFFIC = json.loads((ROOT / "crfbench/traffic/timit-train-b128.json")
                     .read_text())


def _runs(row):
    """(label, length) of each maximal run of ``row``."""
    cut = np.flatnonzero(np.diff(row)) + 1
    return [(int(r[0]), len(r)) for r in np.split(row, cut)]


@pytest.mark.parametrize("seed", [2**31 + 21, 2**33 + 5])
def test_no_gold_run_of_the_pool_is_longer_than_a_segment(seed):
    """The cell's label draw over a seed's whole pool at config 4's widths:
    every run of 1 to 16 frames, adjacent runs of distinct phones (each run
    a gold segment), and the runs a refinement of ``gen.phone_labels``'
    (its run lengths, from the same stream)."""
    plan = gen.plan_batches(TRAFFIC, seed)
    run = TRAFFIC["phone_run"]
    labels = scrf_train.pool_labels(plan, 48, run, 16, seed)
    rng = np.random.default_rng(gen.stream_seed(seed, 0, 2))
    theirs = {}
    for T_ in sorted({t for t, _ in plan}):
        for i, (t, lens) in enumerate(plan):
            if t == T_:
                theirs[i] = gen.phone_labels(rng, lens, t, run, 48)
    n_runs = 0
    for i, ((t, lens), lab) in enumerate(zip(plan, labels)):
        assert lab.shape == (len(lens), t)
        for r, n in enumerate(lens):
            if not n:
                assert not lab[r].any()
                continue
            runs = _runs(lab[r, :n])
            assert all(1 <= m <= 16 for _, m in runs), runs
            assert sum(m for _, m in runs) == n
            assert all(3 <= m <= 12 for _, m in runs[:-1])
            mine = set(np.flatnonzero(np.diff(lab[r, :n])))
            assert set(np.flatnonzero(np.diff(theirs[i][r, :n]))) <= mine
            n_runs += len(runs)
    assert n_runs > 3696 * 30


SMALL = {"num_labels": 5, "feat_dim": 12, "max_dur": 4}


def _small_cell():
    cell = harness.load_cell("scrf-train", 2**31 + 4321, 0.3, False,
                             root=ROOT)
    cell.config = dict(cell.config, model=SMALL, init_std=0.3)
    cell.traffic = {"mode": "train", "batch": 4, "utterances": 35,
                    "buckets": [16, 24], "phone_run": [3, 6],
                    "steps_per_call": 8,
                    "lengths": {"dist": "uniform", "lo": 12, "hi": 24}}
    return cell


def _correct(cell):
    out = harness.module(cell).run(cell, "cpu")
    assert out["failed"] == 0 and out["attempted"] > 0
    return harness.check_line(out["numbers"], cell.limits)


def test_a_sound_small_run_is_correct_under_the_cells_limits():
    ok, line = _correct(_small_cell())
    assert ok, line


def test_a_half_batch_loss_breaks_the_limits(monkeypatch):
    """The loss of the first half of the batch's rows, its mean over their
    frames: half the batch left out of every step."""
    real = seg_mod.scrf_loss_fused

    def half(cfg, params, feats, labels, lengths):
        h = labels.shape[0] // 2
        return real(cfg, params, feats[:h], labels[:h], lengths[:h])
    monkeypatch.setattr(seg_mod, "scrf_loss_fused", half)
    ok, line = _correct(_small_cell())
    assert not ok, line
    assert line["loss_gap"]["value"] > line["loss_gap"]["limit"]


def test_the_benchmarks_half_batch_fault_reaches_the_segmental_loss():
    """``crfbench.faults``' half_batch patches ``models.crf.crf_loss``, the
    criterion of both families, which the segmental step reaches too."""
    undo = faults.plant("half_batch")
    try:
        ok, line = _correct(_small_cell())
    finally:
        undo()
    assert not ok, line
    assert line["loss_gap"]["value"] > line["loss_gap"]["limit"]


def test_a_frozen_optimizer_breaks_the_limits():
    undo = faults.plant("frozen")
    try:
        ok, line = _correct(_small_cell())
    finally:
        undo()
    assert not ok, line
    assert line["change_gap"]["value"] > line["change_gap"]["limit"]


def _ctx(device, span, calls, host=()):
    cell = harness.load_cell("scrf-train", 1, 10.0, True, root=ROOT)
    return {"cell": cell, "trace": {"device": device, "host": list(host),
                                    "span_s": span, "calls": calls}}


def _read(name, ctx):
    return harness.metric_reader(name)(ctx)


GROUP = ["seg_alpha_kernel<3, 1, false>", "seg_beta_kernel<3, 1, false>",
         "seg_message_kernel", "seg_xi16_kernel<4>",
         "fdtk::sum_partials_kernel", "fb_contract_kernel<true>",
         "sum_partials_kernel"]


def test_the_segmental_readers_on_a_synthetic_trace():
    """The group took 4 x its least time, split over its seven launches,
    and a cuBLAS product as long as the least time ran beside it; the
    stretch is 10 least times."""
    Bc, Tc, f = 128, 512, 42_000
    counts = ("segmental_forward", "segmental_backward",
              "segmental_grad_message", "segmental_grad",
              "segmental_grad_contract")
    least = sum(roofline_scrf.kernel_phase(c, B=Bc, T=Tc, L=48, Dmax=16,
                                           frames=f).sol_seconds("highest")
                for c in counts)
    each = 4 * least / len(GROUP)
    dev = [(f"void {n}(float const*)", i * each, (i + 1) * each)
           for i, n in enumerate(GROUP)]
    dev.append(("void cutlass::Kernel<sgemm>(int)", 4 * least, 5 * least))
    calls = [{"steps": [(Tc, f)]}]
    ctx = _ctx(dev, 10 * least, calls)
    assert _read("sol_pct.seg_train", ctx) == pytest.approx(25.0)
    ops = sum(p.op_seconds("highest") for p in roofline_scrf.train_phases(
        Bc, Tc, 48, 144, 16, f))
    assert _read("mfu_pct.seg_train", ctx) == pytest.approx(
        100 * ops / (10 * least))
    assert _read("idle_pct.seg_train", ctx) == pytest.approx(50.0)
    assert _read("glue_pct.seg_train", ctx) == pytest.approx(20.0)
    # nothing to read: no call, no kernel of the group, no device time
    assert _read("sol_pct.seg_train", _ctx(dev[-1:], 1.0, calls)) is None
    for name in ("sol_pct.seg_train", "mfu_pct.seg_train",
                 "idle_pct.seg_train", "glue_pct.seg_train"):
        assert _read(name, _ctx([], 1.0, [])) is None


def test_the_step_model_counts_what_a_step_needs():
    """Every count grows with the real frames; the frame scores' products
    held to the precision's rate, K9's operations to the fp32 rate."""
    few = roofline_scrf.train_phases(128, 512, 48, 144, 16, 10_000)
    many = roofline_scrf.train_phases(128, 512, 48, 144, 16, 20_000)
    for a, b in zip(few, many):
        assert b.flops + b.mma_flops >= a.flops + a.mma_flops, a.name
    by = {p.name: p for p in many}
    assert by["scrf_frame_scores"].mma_flops == 2.0 * 20_000 * 144 * 48
    assert by["segmental_forward"].flops == 20_000 * (2 * 48 * 48
                                                      + 6 * 16 * 48)
    assert by["segmental_forward"].mma_flops == 0.0


def test_capture_seconds_of_the_segmental_cell(monkeypatch):
    spans = {"graph.warm_up": {"count": 6, "total_s": 4.0, "self_s": 1.5},
             "graph.capture": {"count": 6, "total_s": 0.7, "self_s": 0.7},
             "kernels.load": {"count": 1, "total_s": 2.5, "self_s": 2.5}}
    monkeypatch.setattr(diagnostics, "summary",
                        lambda: {"spans": spans, "counters": {}})
    assert _read("capture_s.seg_train", _ctx([], 1.0, [])) == \
        pytest.approx(2.2)


def test_the_reference_log_partition_sums_every_segmentation():
    """At T=5, Dmax=3, two labels: logZ by enumerating every segmentation
    (durations and labels) against the recursion."""
    import itertools
    g = torch.Generator().manual_seed(11)
    p = {"w_frame": torch.randn(3, 2, generator=g, dtype=torch.float64),
         "b_trans": torch.randn(2, 2, generator=g, dtype=torch.float64),
         "b_dur": torch.randn(3, 2, generator=g, dtype=torch.float64),
         "b_seg": torch.randn(2, generator=g, dtype=torch.float64)}
    x = torch.randn(1, 5, 3, generator=g, dtype=torch.float64)
    fs = x[0] @ p["w_frame"]
    scores = []
    for n in range(1, 6):
        for durs in itertools.product((1, 2, 3), repeat=n):
            if sum(durs) != 5:
                continue
            for labs in itertools.product((0, 1), repeat=n):
                s, t = 0.0, 0
                for i, (d, l) in enumerate(zip(durs, labs)):
                    s += float(fs[t:t + d, l].mean() + p["b_dur"][d - 1, l]
                               + p["b_seg"][l])
                    if i:
                        s += float(p["b_trans"][labs[i - 1], l])
                    t += d
                scores.append(s)
    want = float(torch.logsumexp(torch.tensor(scores, dtype=torch.float64),
                                 0))
    got = ref.log_partition(p, x, torch.tensor([5]), 3)
    assert float(got[0]) == pytest.approx(want, rel=1e-12)
    # the gold score: runs [0, 2), [2, 5) of labels 1, 0
    labels = torch.tensor([[1, 1, 0, 0, 0]])
    gold = (fs[0:2, 1].mean() + p["b_dur"][1, 1] + p["b_seg"][1]
            + fs[2:5, 0].mean() + p["b_dur"][2, 0] + p["b_seg"][0]
            + p["b_trans"][1, 0])
    got = ref.gold_scores(p, x, labels, torch.tensor([5]), 3)
    assert float(got[0]) == pytest.approx(float(gold), rel=1e-12)


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

def test_a_profiled_step_records_the_segmental_spans():
    from torch.profiler import ProfilerActivity, profile
    tr = _trainer()
    diagnostics.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            tr.train_step(_batch(12), LR)
        spans = diagnostics.summary()["spans"]
    finally:
        diagnostics.reset()
    for name in ("scrf.loss", "scrf.frame_scores", "scrf.numerator",
                 "scrf.log_partition", "scrf.grad"):
        assert spans[name]["count"] == 1, name
    children = sum(spans[k]["total_s"] for k in (
        "scrf.frame_scores", "scrf.numerator", "scrf.log_partition"))
    assert children <= spans["scrf.loss"]["total_s"]
    # unprofiled, the per-call spans record nothing
    tr.train_step(_batch(13), LR)
    assert "scrf.loss" not in diagnostics.summary()["spans"]


class _FakeLib:
    def __init__(self, frame, xi16):
        self.frame, self.xi16 = frame, xi16

    def seg_frame(self, L_, Dmax):
        return self.frame

    def seg_grad_xi16(self, L_, Dmax):
        return self.xi16


@pytest.mark.parametrize("frame,xi16,path,xi", [
    (3, 1, "own", "16"), (10, 0, "own", "deep"),
    (0, 1, "three_barrier", "16"), (0, 0, "three_barrier", "deep")])
def test_the_counters_name_the_design_the_library_reports(
        monkeypatch, frame, xi16, path, xi):
    from asr_craft_tpu_torch.kernels import segmental as K
    monkeypatch.setattr(K, "_library", lambda: _FakeLib(frame, xi16))
    K.recursion_path.cache_clear()                 # each caches its answer
    K.xi_kernel.cache_clear()
    try:
        assert K.recursion_path(48, 16) == path
        assert K.xi_kernel(48, 16) == xi
    finally:
        K.recursion_path.cache_clear()
        K.xi_kernel.cache_clear()
