"""The readers of the program's spans on synthetic traces: the port's host
turn a call and the graph's launch from ``graph.call`` / ``graph.replay``
ranges, the share of the device's idle time inside the port's spans, and
the set-up seconds of the warm-ups and captures from the program's
recorder.  Each gives nothing where the program has no such span.

    python -m pytest crfbench/tests -q
"""
import pytest

from crfbench import harness

DEC = "void fdtk::fdt_vit_fwd_kernel(float const*, int)"


def _ctx(device, host, span=10.0):
    return {"cell": None, "trace": {"device": device, "host": list(host),
                                    "span_s": span, "calls": []}}


def _read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_host_turn_and_launch_from_the_call_and_replay_ranges():
    host = [
        # a replayed call: 100 us long, its launch 30 us of it
        ("graph.call", 1.0, 1.0001), ("graph.copy_in", 1.00001, 1.00002),
        ("graph.replay", 1.00002, 1.00005), ("cudaGraphLaunch", 1.00002,
                                             1.00005),
        ("graph.copy_out", 1.00006, 1.00009),
        # another: 60 us, its launch 50 us
        ("graph.call", 2.0, 2.00006), ("graph.replay", 2.000005, 2.000055),
        # a call that captured (no replay inside): not a replayed call
        ("graph.call", 3.0, 3.5), ("graph.warm_up", 3.0, 3.2),
        ("graph.capture", 3.2, 3.5),
        ("aten::copy_", 4.0, 4.1),
    ]
    ctx = _ctx([(DEC, 1.0, 1.5)], host)
    assert _read("host_us.decode", ctx) == pytest.approx((70 + 10) / 2)
    assert _read("launch_us.decode", ctx) == pytest.approx((30 + 50) / 2)


def test_half_the_idle_inside_the_ports_spans():
    # busy [0, 2], [4, 6], [8, 10]: gaps [2, 4] and [6, 8], 4 s idle;
    # the port's spans cover [3, 4] (a call) and [6, 7] (a copy out inside
    # a call), the caller's copy to the host [7, 8]
    dev = [(DEC, 0.0, 2.0), (DEC, 4.0, 6.0), (DEC, 8.0, 10.0)]
    host = [("graph.call", 3.0, 4.5), ("graph.replay", 3.5, 4.5),
            ("graph.call", 5.5, 7.0), ("graph.copy_out", 6.0, 7.0),
            ("aten::_to_copy", 7.0, 8.0)]
    assert _read("idle_port_pct.decode", _ctx(dev, host)) == \
        pytest.approx(50.0)


@pytest.mark.parametrize("name", ["host_us.decode", "launch_us.decode",
                                  "idle_port_pct.decode"])
def test_a_trace_without_the_programs_spans_gives_nothing(name):
    """The parent of the spans' program: its trace holds only the
    runtime's and PyTorch's ranges."""
    dev = [(DEC, 0.0, 2.0), (DEC, 4.0, 6.0)]
    host = [("cudaGraphLaunch", 2.5, 2.6), ("aten::copy_", 3.0, 3.5)]
    assert _read(name, _ctx(dev, host)) is None
    assert _read(name, _ctx([], [])) is None


@pytest.mark.parametrize("name", ["capture_s.train", "capture_s.decode"])
def test_capture_seconds_are_the_setup_spans_self_seconds(name, monkeypatch):
    from asr_craft_tpu_torch.utils import diagnostics
    spans = {"graph.warm_up": {"count": 4, "total_s": 3.0, "self_s": 1.25},
             "graph.capture": {"count": 4, "total_s": 0.5, "self_s": 0.5},
             "kernels.load": {"count": 1, "total_s": 1.75, "self_s": 1.75},
             "graph.call": {"count": 9, "total_s": 0.1, "self_s": 0.01}}
    monkeypatch.setattr(diagnostics, "summary",
                        lambda: {"spans": spans, "counters": {}})
    assert _read(name, _ctx([], [])) == pytest.approx(1.75)
    monkeypatch.setattr(diagnostics, "summary",
                        lambda: {"spans": {}, "counters": {}})
    assert _read(name, _ctx([], [])) is None
    # a program whose recorder has no summary
    monkeypatch.delattr(diagnostics, "summary")
    assert _read(name, _ctx([], [])) is None


def test_capture_seconds_from_the_recorder_itself():
    """Through the program's own recorder: two set-up spans, the first
    with the library's load inside it."""
    import time

    from asr_craft_tpu_torch.utils import diagnostics
    diagnostics.reset()
    try:
        with diagnostics.span("graph.warm_up", graph="g", shape=0):
            with diagnostics.span("kernels.load"):
                time.sleep(0.02)
        with diagnostics.span("graph.capture", graph="g", shape=0):
            pass
        got = diagnostics.summary()["spans"]
        want = got["graph.warm_up"]["self_s"] + got["graph.capture"]["self_s"]
        assert _read("capture_s.train", _ctx([], [])) == pytest.approx(want)
        assert want < 0.02 <= got["kernels.load"]["total_s"]
    finally:
        diagnostics.reset()
