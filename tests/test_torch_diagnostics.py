"""The port's observability utilities
(``asr_craft_tpu_torch.utils.diagnostics``): the cases of
``tests/unit/test_diagnostics.py`` for the PyTorch twins, and ``--debug_nans``
through both packages' train CLIs on the same poisoned weight file: each
raises ``FloatingPointError``, and each runs to its end without the flag.
And the port's recorder of spans and counters: nesting and self time, the
per-call spans' gate, the set-up spans, the export beside the trace, the
counters, the kernels' launch counters (a wrapper's launch under its
design's name; the graph runner's hold and add), the spans of the kernels'
loader, of the epoch loop and of a graph's eager call.
"""
import contextlib
import json
import os
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from asr_craft_tpu.cli import train as jax_cli
from asr_craft_tpu.models import weights as jax_weights
from asr_craft_tpu.models.crf import CrfConfig as JaxCrfConfig
from asr_craft_tpu.utils import diagnostics as jax_diagnostics
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.cli import train as port_cli
from asr_craft_tpu_torch.kernels import _build, fdt_train
from asr_craft_tpu_torch.train import graphs
from asr_craft_tpu_torch.utils import diagnostics

P = 4
TRAIN = ["--synthetic_utts", "12", "--crf_label_size", str(P),
         "--crf_states", "3", "--window_extent", "1", "--crf_transftr_end",
         str(3 * P), "--bucket_sizes", "64,128", "--batch_size", "8",
         "--crf_lr", "0.5", "--crf_epochs", "1", "--log_every", "1000"]


@pytest.fixture(autouse=True)
def _debug_flags_off():
    diagnostics.reset()
    yield
    diagnostics.reset()
    diagnostics.enable_debug_nans(False)
    jax_diagnostics.enable_debug_nans(False)
    kernels.set_backend("auto")


def test_assert_replicated_passes_with_one_process():
    tree = {"w": torch.ones(4, 4)}
    diagnostics.assert_replicated(tree)                   # not initialised
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        diagnostics.assert_replicated(tree)               # a world of one
    finally:
        dist.destroy_process_group()


def test_assert_replicated_detects_divergence(monkeypatch):
    """Two ranks, stood in for by a gather that hands back one diverged
    copy (the multi-process run comes with the data-parallel slice)."""
    import torch.distributed as dist

    def gather(copies, mine):
        for rank, c in enumerate(copies):
            c.copy_(mine + (0.5 if rank == 1 else 0.0))

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "all_gather", gather)
    with pytest.raises(AssertionError, match=r"params\['w'\] diverges.*0.5"):
        diagnostics.assert_replicated({"w": torch.arange(8.0)})
    diagnostics.assert_replicated({"w": torch.arange(8.0)}, atol=0.6)


def test_grad_sync_hook_cadence(monkeypatch):
    calls = []
    monkeypatch.setattr(diagnostics, "assert_replicated",
                        lambda t, **k: calls.append(1))
    hook = diagnostics.grad_sync_check_hook(every=3)
    for step in range(1, 10):
        hook(step, {})
    assert len(calls) == 3  # steps 3, 6, 9


def test_profiler_session_writes_trace(tmp_path):
    """The session writes the trace and, beside it, ``spans.json``: the
    recorder's summary.  A span is a range of the trace, its attrs the
    range's args."""
    d = str(tmp_path / "trace")
    with diagnostics.profiler_session(d):
        with diagnostics.span("train.step", step=0):
            torch.ones(8, 8).sum().item()
    found = []
    for root, _, files in os.walk(d):
        found.extend(files)
    assert sorted(found) == ["spans.json", "trace.json"]
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    steps = [e for e in trace["traceEvents"] if e.get("name") == "train.step"]
    assert len(steps) == 1 and steps[0]["args"]["step"] == 0
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert spans == json.loads(json.dumps(diagnostics.summary()))
    assert spans["spans"]["train.step"]["count"] == 1


@pytest.fixture
def profiler():
    """A CPU profiler recording around the test's body."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def test_spans_nest_with_parents_and_self_time(profiler):
    """Two levels and a sibling: each span's parent is the span open around
    it, and a span's self time is its total less its children's totals."""
    with diagnostics.span("a.outer") as outer:
        assert outer.parent is None
        time.sleep(0.004)
        with diagnostics.span("a.inner", n=1) as inner:
            assert inner.parent is outer
            time.sleep(0.006)
            with diagnostics.span("a.leaf") as leaf:
                assert leaf.parent is inner
                time.sleep(0.002)
        with diagnostics.span("a.inner", n=2) as sibling:
            assert sibling.parent is outer
            time.sleep(0.003)
    got = diagnostics.summary()["spans"]
    assert {k: v["count"] for k, v in got.items()} == {
        "a.outer": 1, "a.inner": 2, "a.leaf": 1}
    o, i, f = got["a.outer"], got["a.inner"], got["a.leaf"]
    assert o["self_s"] == pytest.approx(o["total_s"] - i["total_s"],
                                        abs=1e-9)
    assert i["self_s"] == pytest.approx(i["total_s"] - f["total_s"],
                                        abs=1e-9)
    assert f["self_s"] == f["total_s"] >= 0.002
    assert i["total_s"] >= 0.011 and o["self_s"] >= 0.004
    assert o["total_s"] >= o["self_s"] + i["total_s"] - 1e-9


def _no_ranges(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("a profiler range was entered")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fail)
    monkeypatch.setattr(torch.profiler, "record_function", fail)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", fail)


def test_a_per_call_span_without_a_profiler_is_the_gate_alone(monkeypatch):
    """With no profiler recording, a per-call span records nothing, opens
    no profiler range and hands back one shared do-nothing context."""
    _no_ranges(monkeypatch)
    assert not diagnostics.recording()
    ctx = diagnostics.span("graph.call", graph="g", call=1)
    assert ctx is diagnostics.span("graph.replay")
    with ctx as got:
        assert got is None
    assert diagnostics.summary()["spans"] == {}


def test_setup_spans_record_without_a_profiler(monkeypatch):
    _no_ranges(monkeypatch)
    for name in sorted(diagnostics.SETUP_SPANS):
        with diagnostics.span(name, graph="g", shape=0):
            pass
    got = diagnostics.summary()["spans"]
    assert set(got) == diagnostics.SETUP_SPANS
    assert all(v["count"] == 1 for v in got.values())


def test_counters_add_and_reset():
    diagnostics.count("graph.replays[x]")
    diagnostics.count("graph.replays[x]", 4)
    diagnostics.count("graph.nodes[x#0]", 37)
    assert diagnostics.summary()["counters"] == {"graph.replays[x]": 5,
                                                 "graph.nodes[x#0]": 37}
    with diagnostics.span("graph.capture"):
        pass
    diagnostics.reset()
    got = diagnostics.summary()
    assert got["counters"] == {} and got["spans"] == {}


def test_the_summary_reads_the_kernels_launch_counts_in_place(monkeypatch):
    """A wrapper's launch is a counter of ``summary()``, named for the
    kernel and the design it took; the summary has no other launch record.
    The plane kernel's wrapper runs on CPU tensors here, its library a
    stand-in that succeeds."""
    class Lib:
        def fdt_train_plane(self, *args):
            return 0

    monkeypatch.setattr(fdt_train, "_library", Lib)
    monkeypatch.setattr(fdt_train, "_stream", lambda dev: 0)
    monkeypatch.setattr(_build, "check_tensor", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    feats = torch.zeros((2, 3, 144))
    assert fdt_train.plane_path(feats, u0=0, Du=144) == "wgmma"
    for key in ("kernels.fdt_train_plane", "kernels.fdt_viterbi_plane",
                "kernels.fdt_train_plane"):
        fdt_train.fdt_planes_cuda(torch.zeros((70, 145)), feats, u0=0,
                                  u1=144, key=key)
    got = diagnostics.summary()
    assert set(got) == {"spans", "counters"}
    assert got["counters"] == {"kernels.fdt_train_plane[wgmma]": 2,
                               "kernels.fdt_viterbi_plane[wgmma]": 1}
    assert diagnostics.launches() == got["counters"]


def test_held_launches_take_every_threads_launch_counts_until_added():
    """The graph runner's primitive: inside ``held_launches()`` the
    ``kernels.*`` counts of every thread are taken off the counters and
    given back as a dict; other counters count as ever; ``add`` puts the
    held counts back, under one lock."""
    diagnostics.count("kernels.fdt_train_fwd", 2)
    diagnostics.count("graph.replays[x]")
    with diagnostics.held_launches() as held:
        diagnostics.count("kernels.fdt_train_fwd")
        diagnostics.count("kernels.fdt_train_plane[wgmma]")
        diagnostics.count("graph.replays[x]")
        # autograd's device thread launches a backward during a capture
        other = threading.Thread(target=diagnostics.count,
                                 args=("kernels.fdt_train_bwd[ring8]", 3))
        other.start()
        other.join()
        assert held == {}                   # filled when the context ends
    assert held == {"kernels.fdt_train_fwd": 1,
                    "kernels.fdt_train_plane[wgmma]": 1,
                    "kernels.fdt_train_bwd[ring8]": 3}
    assert diagnostics.summary()["counters"] == {
        "kernels.fdt_train_fwd": 2, "graph.replays[x]": 2}
    for n in (1, 2):
        diagnostics.add(held)
        assert diagnostics.launches() == {
            "kernels.fdt_train_fwd": 2 + n,
            "kernels.fdt_train_plane[wgmma]": n,
            "kernels.fdt_train_bwd[ring8]": 3 * n}
    assert diagnostics.summary()["counters"]["graph.replays[x]"] == 2


def test_held_launches_restore_the_counters_when_the_body_raises():
    diagnostics.count("kernels.calibrate")
    with pytest.raises(RuntimeError, match="capture"):
        with diagnostics.held_launches() as held:
            diagnostics.count("kernels.calibrate", 5)
            raise RuntimeError("capture failed")
    assert held == {"kernels.calibrate": 5}
    assert diagnostics.launches() == {"kernels.calibrate": 1}


def test_the_kernels_library_load_and_build_are_setup_spans(monkeypatch,
                                                            tmp_path):
    """The first ``load_library()`` opens ``kernels.load``, with
    ``kernels.build`` inside it when the library has to be built; a second
    call opens nothing."""
    class Lib:
        class fdt_cuda_error_string:
            pass

    def build(path):
        time.sleep(0.003)
        path.write_bytes(b"")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(_build, "_build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    lib = _build.load_library()
    assert _build.load_library() is lib
    got = diagnostics.summary()["spans"]
    assert got["kernels.load"]["count"] == got["kernels.build"]["count"] == 1
    assert got["kernels.build"]["total_s"] >= 0.003
    assert got["kernels.load"]["self_s"] == pytest.approx(
        got["kernels.load"]["total_s"] - got["kernels.build"]["total_s"],
        abs=1e-9)


def test_a_graphed_call_on_cpu_tensors_counts_an_eager_call(profiler):
    """CPU tensors (and calls under ``graphs.disabled()``) run the eager
    code: a counter each, and no ``graph.call`` span, even while a profiler
    records."""
    g = graphs.Graphed(lambda b, x: x["x"] * 2, name="double")
    x = {"x": torch.ones(3)}
    assert torch.equal(g({}, x), torch.full((3,), 2.0))
    with graphs.disabled():
        g({}, x)
    got = diagnostics.summary()
    assert got["counters"] == {"graph.eager_calls[double]": 2}
    assert not any(k.startswith("graph.") for k in got["spans"])
    assert len(g) == 0


def test_the_epoch_loop_records_its_steps_and_loader_waits(tmp_path):
    """``--profile_dir``: a ``train.step`` span a trip of the epoch loop
    (each batch, and the trip that meets the epoch's end), each holding its
    wait on the prefetch queue, ``train.loader_wait``."""
    d = tmp_path / "prof"
    assert port_cli.main(TRAIN + ["--device", "cpu", "--out_dir",
                                  str(tmp_path / "out"), "--profile_dir",
                                  str(d)]) == 0
    spans = json.loads((d / "spans.json").read_text())["spans"]
    step, wait = spans["train.step"], spans["train.loader_wait"]
    assert step["count"] == wait["count"] >= 2
    assert step["self_s"] == pytest.approx(
        step["total_s"] - wait["total_s"], abs=1e-6)
    names = {e.get("name") for e in json.loads(
        (d / "trace.json").read_text())["traceEvents"]}
    assert {"train.step", "train.loader_wait"} <= names


def test_profiler_session_noop():
    with diagnostics.profiler_session(None):
        pass


def test_debug_nans_toggle():
    diagnostics.enable_debug_nans(True)
    assert diagnostics.debug_nans_enabled()
    assert torch.is_anomaly_enabled()
    bad = torch.log(torch.zeros(())) / torch.zeros(())
    with pytest.raises(FloatingPointError, match="step 7"):
        diagnostics.check_finite("toggle", 7, loss=bad)
    with pytest.raises(FloatingPointError, match="grad_norm"):
        diagnostics.check_finite("toggle", 0, loss=torch.ones(()),
                                 grad_norm=torch.tensor(float("inf")))
    diagnostics.check_finite("toggle", 0, loss=torch.ones(3))
    diagnostics.enable_debug_nans(False)
    assert not diagnostics.debug_nans_enabled()
    assert not torch.is_anomaly_enabled()


def test_deterministic_key():
    k1 = diagnostics.deterministic(7)
    k2 = diagnostics.deterministic(7)
    np.testing.assert_array_equal(torch.randn(5, generator=k1).numpy(),
                                  torch.randn(5, generator=k2).numpy())
    assert not torch.are_deterministic_algorithms_enabled()


def _poisoned(tmp_path):
    cfg = JaxCrfConfig(num_labels=P, feat_dim=3 * P, num_states=3,
                       trans_range=(0, 3 * P))
    params = {k: np.array(v) for k, v in cfg.init_params().items()}
    params["w_state"][0, 0] = np.nan
    path = tmp_path / "poisoned.dat"
    jax_weights.save_raw(str(path), cfg.fmap, params)
    return str(path)


@pytest.mark.parametrize("who", ["port", "jax"])
def test_debug_nans_through_the_train_cli(tmp_path, who, capsys):
    weights = _poisoned(tmp_path)
    main, dev = ((port_cli.main, ["--device", "cpu"]) if who == "port"
                 else (jax_cli.main, ["--platform", "cpu"]))
    argv = TRAIN + dev + ["--init_weight_file", weights]
    with pytest.raises(FloatingPointError):
        main(argv + ["--out_dir", str(tmp_path / "flag"), "--debug_nans"])
    diagnostics.enable_debug_nans(False)
    jax_diagnostics.enable_debug_nans(False)
    assert main(argv + ["--out_dir", str(tmp_path / "plain")]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert recs[-1]["kind"] == "done"
    assert (tmp_path / "plain" / "weights.final.dat").exists()
    assert jax.config.jax_debug_nans is False


def test_debug_nans_names_the_step_and_leaves_a_clean_run_alone(tmp_path,
                                                               capsys):
    """The port's error names the step; on finite weights the flag changes
    no number."""
    with pytest.raises(FloatingPointError, match="step 0"):
        port_cli.main(TRAIN + ["--device", "cpu", "--init_weight_file",
                               _poisoned(tmp_path), "--debug_nans",
                               "--out_dir", str(tmp_path / "bad")])
    capsys.readouterr()
    losses = []
    for tag, flag in (("on", ["--debug_nans"]), ("off", [])):
        assert port_cli.main(TRAIN + ["--device", "cpu", "--out_dir",
                                      str(tmp_path / tag)] + flag) == 0
        recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")]
        losses.append([r["mean_loss"] for r in recs
                       if r["kind"] == "train_epoch"])
    assert losses[0] == losses[1] and np.isfinite(losses[0]).all()
