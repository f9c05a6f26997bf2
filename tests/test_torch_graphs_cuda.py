"""The compiled step and decodes on the card: each path's CUDA graph
against its eager code, bit for bit (the graph replays the same kernels on
the same inputs in the same order), the kernels' launch counters
(``kernels.*``, each design's name included) moved by every call through
the graph, the call that warms up and captures and each replay, exactly as
by one eager call, and a capture that fails.

Marked ``cuda``: CUDA graphs need the card, so these tests skip on a host
without an NVIDIA GPU.  On one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py -q

The paths are chip_smoke.py phase (s)'s, at smaller batches: the config-2
step alone and 8 steps in one call, the shared steps at configs 1, 3 and 5,
the config-4 (segmental) step with the recipe's Adam, ``decode()`` at
configs 2, 1, 3 and 5 and ``scrf_decode``; and a trainer's graphs freed
with it.  And the graph runner's spans and counters: captures, replays,
evictions and node counts, the spans of a replayed call in a profiler's
trace around the graph's kernels, and a kept graph's bits.
"""
import contextlib
import gc
import subprocess
import sys

import pytest
import torch

from asr_craft_tpu_torch import flagship
from asr_craft_tpu_torch.models.crf import decode
from asr_craft_tpu_torch.models.segmental import scrf_decode
from asr_craft_tpu_torch.train import (TrainConfig, Trainer, graphs,
                                       make_train_step)
from asr_craft_tpu_torch.train.trainer import scrf_loss_fn
from asr_craft_tpu_torch.utils import diagnostics
from asr_craft_tpu_torch.utils.logging import MetricsLogger
from launch_counts import moved

pytestmark = pytest.mark.cuda
B, T, STEPS = 16, 128, 8
CONFIGS = {"config2": flagship.flagship, "config1": flagship.timit_mono,
           "config3": flagship.wsj_crandem, "config5": flagship.swbd}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(call):
    """``call()``'s result and the launch counters it moved, by how much."""
    before = diagnostics.launches()
    return call(), moved(before)


def _same(got, want, what):
    assert torch.equal(got, want), (
        f"{what}: max abs diff {(got.double() - want.double()).abs().max()}"
        f" at {int((got != want).sum())} of {got.numel()} entries")


def _train(dev, cfg, spc, eager):
    """Eight steps on eight batches: one ``train_step`` each (spc 1; the
    first the graph's warm-up and capture, seven replays) or one
    ``multi_step`` after a first, warm-up call; the metrics, the parameters
    after them and the launch counters each call moved."""
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.01, dev)
    tr = Trainer(cfg, TrainConfig(lr=0.3, momentum=0.9), params=params,
                 logger=MetricsLogger(quiet=True))
    batches = [flagship.tiny_batch(cfg, B, T, s, dev) for s in range(STEPS)]
    with graphs.disabled() if eager else contextlib.nullcontext():
        if spc == 1:
            ms, ran = zip(*[_launched(lambda: tr.train_step(b, 0.3))
                            for b in batches])
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        else:
            ran = [_launched(lambda: tr.multi_step(batches, 0.3))[1]]
            m, last = _launched(lambda: tr.multi_step(batches, 0.3))
            ran.append(last)
    return m, tr.params, list(ran)


@pytest.mark.parametrize("spc", [1, STEPS])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_steps_graph_equals_eager(dev, name, spc):
    """And every call through the graphs moves the launch counters as its
    eager call does (the backward's kernels launch on autograd's device
    thread, inside the capture too)."""
    cfg = CONFIGS[name]()
    m_e, p_e, ran_e = _train(dev, cfg, spc, eager=True)
    m_g, p_g, ran_g = _train(dev, cfg, spc, eager=False)
    for k in ("loss", "grad_norm", "mean_logZ", "frames"):
        _same(m_g[k], m_e[k], k)
    for k in p_e:
        _same(p_g[k].detach(), p_e[k].detach(), k)
    assert ran_e[0] and ran_e == [ran_e[0]] * len(ran_e)
    assert ran_g == ran_e


def test_segmental_step_graph_equals_eager(dev):
    cfg = flagship.scrf()
    batch = flagship.scrf_batch(cfg, B, T, 0, dev)
    out, ran = [], []
    for eager in (True, False):
        params = {k: v.requires_grad_(True) for k, v in cfg.init_params(
            torch.Generator().manual_seed(0), 0.1, dev).items()}
        step, opt = make_train_step(cfg, TrainConfig(optimizer="adam"),
                                    loss_fn=scrf_loss_fn(cfg))
        state = opt.init(params)
        with graphs.disabled() if eager else contextlib.nullcontext():
            ms, counts = zip(*[_launched(
                lambda: step(params, state, {}, batch, 0.05)[3])
                for _ in range(STEPS)])
        out.append((torch.stack([m["loss"] for m in ms]),
                    torch.stack([m["grad_norm"] for m in ms]), params,
                    state["count"]))
        ran.append(list(counts))
    (le, ge, pe, ce), (lg, gg, pg, cg) = out
    assert torch.equal(lg, le) and torch.equal(gg, ge)
    # each call through the graph moves the counters as an eager call does
    assert ran[0][0] and ran[0] == [ran[0][0]] * STEPS == ran[1]
    assert float(cg) == float(ce) == STEPS
    for k in pe:
        assert torch.equal(pg[k], pe[k]), k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_graph_equals_eager_and_counts_launches(dev, name):
    cfg = CONFIGS[name]()
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.1, dev)
    batch = flagship.tiny_batch(cfg, B, T, 0, dev)
    inputs = {"feats": batch["feats"], "lengths": batch["lengths"]}
    dec = graphs.Graphed(
        lambda p, b: decode(cfg, p, b["feats"], b["lengths"]), name="decode")
    with graphs.disabled():
        want, eager_launches = _launched(lambda: dec(params, inputs))
    assert eager_launches and len(dec) == 0
    if name == "config2":               # K3: B = 16 utterances, exact
        assert set(eager_launches) >= {"kernels.fdt_viterbi_fwd[cluster]",
                                       "kernels.fdt_viterbi_traceback"}
        assert not any(k.endswith("[block]") for k in eager_launches)
    for i in range(3):                  # warm-up and capture, then replays
        got, counts = _launched(lambda: dec(params, inputs))
        assert counts == eager_launches, i
        for g, w in zip(got, want):
            assert torch.equal(g, w), i
    assert len(dec) == 1
    # a new batch of the same shape replays the same graph on its values
    other = flagship.tiny_batch(cfg, B, T, 1, dev)
    inputs2 = {"feats": other["feats"], "lengths": other["lengths"]}
    with graphs.disabled():
        want2 = dec(params, inputs2)
    for g, w in zip(dec(params, inputs2), want2):
        assert torch.equal(g, w)
    assert len(dec) == 1


def test_scrf_decode_graph_equals_eager(dev):
    cfg = flagship.scrf()
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.1, dev)
    batch = flagship.scrf_batch(cfg, B, T, 0, dev)
    inputs = {"feats": batch["feats"], "lengths": batch["lengths"]}
    dec = graphs.Graphed(
        lambda p, b: scrf_decode(cfg, p, b["feats"], b["lengths"]),
        name="scrf_decode")
    with graphs.disabled():
        want = dec(params, inputs)
    for _ in range(3):
        for g, w in zip(dec(params, inputs), want):
            assert torch.equal(g, w)


def test_graphs_are_freed_with_their_owner(dev):
    """A trainer's graphs, their buffers and their pool go with it: the
    device memory allocated returns to what it was before the trainer.
    (The first trainer's run leaves what a process keeps for good: the
    cuBLAS workspaces of the warm-up and capture streams.)"""
    cfg = flagship.timit_mono()
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.1, dev)
    batch = flagship.tiny_batch(cfg, B, T, 0, dev)
    allocated = []
    for _ in range(3):
        gc.collect()
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(dev))
        tr = Trainer(cfg, TrainConfig(lr=0.03), params=params,
                     logger=MetricsLogger(quiet=True))
        for _ in range(3):
            m = tr.train_step(batch, 0.03)
        assert len(tr.step_fn._step) == 1
        del tr, m
    gc.collect()
    torch.cuda.synchronize()
    assert allocated[1] == allocated[2] == torch.cuda.memory_allocated(dev)


def test_a_failed_capture_raises(dev):
    """A host read inside a captured function: the first call (the eager
    warm-up) runs, then the capture raises; nothing falls back.  In its own
    process, so the failed capture leaves no state to the other tests."""
    code = (
        "import torch\n"
        "from asr_craft_tpu_torch.train import graphs\n"
        "g = graphs.Graphed(lambda b, x: x['x'] * float(x['x'].sum()),"
        " name='host read')\n"
        "x = {'x': torch.ones(4, device='cuda')}\n"
        "try:\n"
        "    g({}, x)\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "RAISED CUDA graph capture of host read failed" in run.stdout


@pytest.mark.parametrize("spc", [1, 4])
def test_lbfgs_and_precision_steps_graph_equals_eager(dev, spc):
    """The config-2 step under lbfgs at bf16x3 through the graphs equals
    its eager code bit for bit (``multi_step`` of 4 too); then the same
    step object, its loss function swapped for the highest precision's,
    captures a new graph (the precision is a key) and again equals its
    eager code."""
    import dataclasses
    from asr_craft_tpu_torch.train.trainer import crf_loss_fn
    base = dataclasses.replace(flagship.flagship(), precision="bf16x3")
    batches = [flagship.tiny_batch(base, B, T, s, dev) for s in range(4)]

    def run(eager):
        step, opt = make_train_step(base, TrainConfig(optimizer="lbfgs"))
        params = {k: v.requires_grad_(True) for k, v in base.init_params(
            torch.Generator().manual_seed(0), 0.01, dev).items()}
        state = opt.init(params)
        avg = {k: v.detach().clone() for k, v in params.items()}
        out = []
        with graphs.disabled() if eager else contextlib.nullcontext():
            for cfg in (base, dataclasses.replace(base,
                                                  precision="highest")):
                step.loss_fn = crf_loss_fn(cfg)
                if spc == 1:
                    ms = [step(params, state, avg, b, 0.05)[3]
                          for b in batches]
                    out += [m["loss"] for m in ms]
                else:
                    out.append(step.multi_step(params, state, avg, batches,
                                               0.05)[3]["loss"])
        return out, params, len(step._step) + len(step._multi)

    (le, pe, ne), (lg, pg, ng) = run(True), run(False)
    assert ne == 0 and ng == 2          # one graph a precision
    for a, b in zip(lg, le):
        _same(a, b, "loss")
    for k in pe:
        _same(pg[k].detach(), pe[k].detach(), k)


def _decoder(dev):
    cfg = flagship.flagship()
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.1, dev)
    batch = flagship.tiny_batch(cfg, B, T, 0, dev)
    inputs = {"feats": batch["feats"], "lengths": batch["lengths"]}

    def fn(p, b):
        return decode(cfg, p, b["feats"], b["lengths"])
    return fn, params, inputs


def test_captures_replays_evictions_and_nodes_are_counted(dev):
    """One capture and n replays of a shape; a ninth shape drops the least
    recently used graph; each captured graph's node count is kept."""
    diagnostics.reset()
    g = graphs.Graphed(lambda b, x: (x["x"] * 2.0).sin(), name="twice")
    x = {"x": torch.ones(8, device=dev)}
    n = 5
    for _ in range(1 + n):
        assert torch.equal(g({}, x), torch.full((8,), 2.0, device=dev).sin())
    got = diagnostics.summary()["counters"]
    assert got["graph.captures[twice]"] == 1
    assert got["graph.replays[twice]"] == n
    assert got["graph.nodes[twice#0]"] >= 2          # a multiply, a sine
    for size in range(9, 9 + graphs.MAX_SHAPES):
        g({}, {"x": torch.ones(size, device=dev)})
    got = diagnostics.summary()["counters"]
    assert got["graph.captures[twice]"] == 1 + graphs.MAX_SHAPES
    assert got["graph.evictions[twice]"] == 1 and len(g) == graphs.MAX_SHAPES
    assert all(got[f"graph.nodes[twice#{i}]"] > 0
               for i in range(1 + graphs.MAX_SHAPES))
    assert "graph.eager_calls[twice]" not in got
    spans = diagnostics.summary()["spans"]
    assert spans["graph.warm_up"]["count"] == spans["graph.capture"][
        "count"] == 1 + graphs.MAX_SHAPES
    assert "graph.call" not in spans      # no profiler: no per-call span
    diagnostics.reset()


def test_a_replayed_call_is_spans_around_the_graphs_kernels(dev):
    """Under a profiler, each replayed ``decode()`` call is a ``graph.call``
    range holding ``graph.copy_in``, ``graph.replay`` and
    ``graph.copy_out`` in that order; the graph's kernels start after its
    ``graph.replay`` range starts; and no span has a twin interval on the
    device's timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn, params, inputs = _decoder(dev)
    dec = graphs.Graphed(fn, name="decode")
    dec(params, inputs)                   # warm-up and capture
    per_call = sum(_launched(lambda: dec(params, inputs))[1].values())
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            dec(params, inputs)
            torch.cuda.synchronize()
    evs = prof.events()
    assert not any(e.device_type == DeviceType.CUDA
                   and e.name.startswith("graph.") for e in evs)
    rng = {k: sorted((e.time_range.start, e.time_range.end) for e in evs
                     if e.name == k and e.device_type == DeviceType.CPU)
           for k in ("graph.call", "graph.copy_in", "graph.replay",
                     "graph.copy_out")}
    assert all(len(v) == n for v in rng.values()), rng
    kernels = sorted(e.time_range.start for e in evs
                     if e.device_type == DeviceType.CUDA
                     and "fdt_" in e.name)
    for i, (s, t) in enumerate(rng["graph.call"]):
        (a, b), (c, d), (f, h) = (rng[k][i] for k in (
            "graph.copy_in", "graph.replay", "graph.copy_out"))
        assert s <= a <= b <= c <= d <= f <= h <= t
        end = rng["graph.call"][i + 1][0] if i + 1 < n else float("inf")
        mine = [k for k in kernels if s <= k < end]
        assert len(mine) == per_call and mine[0] >= c, (i, mine, c)


def test_a_kept_graph_replays_the_same_bits(dev):
    """The runner keeps its graphs (``keep_graph=True``, instantiated at
    capture) to count their nodes; a replay gives the bits of the same
    function captured into a graph that is not kept."""
    fn, params, inputs = _decoder(dev)
    dec = graphs.Graphed(fn, name="decode")
    dec(params, inputs)
    got = dec(params, inputs)
    static = {k: v.clone() for k, v in inputs.items()}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(params, static)
    torch.cuda.current_stream(dev).wait_stream(side)
    plain = torch.cuda.CUDAGraph()
    with torch.cuda.graph(plain):
        out = fn(params, static)
    plain.replay()
    torch.cuda.synchronize()
    for g, w in zip(got, out):
        assert torch.equal(g, w)
