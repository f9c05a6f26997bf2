"""What every cell shares: the cell's files found by name, the measured
window, the profiler's trace and its reduction, the device record, the
module check and the result line.

Nothing here knows a cell.  A cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json``, the limits of its comparison
``limits/<workload>.json``, the code that drives it
``modes/<family>_<mode>.py`` (the configuration's ``family``, the
traffic's ``mode``) and each per-layer metric ``metrics/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FRAME_S = 0.01                      # 10 ms frames
FORBIDDEN = ("jax", "jaxlib", "flax", "asr_craft_tpu")
# the precision a cell's control runs at: the next one below the stated
CONTROL_PRECISION = {"highest": "default", "bf16x3": "default"}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    control: bool = False
    per_layer: tuple = ()           # the BENCHMARK.json entries it reports

    @property
    def module(self) -> str:
        return f"{self.config['family']}_{self.traffic['mode']}"

    def precision(self, kind: str) -> str:
        """The configuration's precision for ``kind`` (train, decode); the
        control's one below it."""
        p = self.config["precision"][kind]
        return CONTROL_PRECISION[p] if self.control else p


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, seed: int, seconds: float, trace: bool,
              control: bool = False, root: Path = Path(".")) -> Cell:
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    per_layer = tuple(m for m in spec["per_layer"]
                      if workload in m.get("workloads", [workload]))
    return Cell(workload, _json(HERE / "configs" / f"{w['config']}.json"),
                _json(HERE / "traffic" / f"{w['traffic']}.json"),
                _json(HERE / "limits" / f"{workload}.json"), int(w["chips"]),
                int(seed), float(seconds), bool(trace), control, per_layer)


def module(cell: Cell):
    return importlib.import_module(f"crfbench.modes.{cell.module}")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py`` (names hold dots, so the file
    is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "crfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

class Window:
    """The measured window on the host's clock, and the traced stretch in
    it.  With ``trace`` the profiler starts before the window (its start
    takes seconds), a lead of ``LEAD_S`` passes, and the stretch runs from
    mark a to mark b (each a synchronise inside a named host range), at
    most ``STRETCH_S`` long, after which the profiler stops; the calls
    issued between the marks are the traced calls."""

    LEAD_S = 0.5
    STRETCH_S = 1.2

    def __init__(self, seconds: float, trace: bool, sync):
        self.seconds, self.trace, self.sync = seconds, trace, sync
        self.prof = None
        self.state = "off"          # off, or lead -> on -> done
        self.traced_calls = []      # what the caller noted of each call
        self.t0 = self.t1 = None
        self.stretch = None

    def start(self) -> None:
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.state = "lead"
        self.sync()
        self.t0 = time.perf_counter()
        self.t0_epoch = time.time()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def before_call(self) -> None:
        """Start and stop the traced stretch at their times."""
        if self.state in ("off", "done"):
            return
        e = self.elapsed()
        if self.state == "lead" and e >= self.LEAD_S:
            self._mark()
            self._a = self.elapsed()
            self.state = "on"
        elif self.state == "on" and (
                e >= self._a + min(self.STRETCH_S, 0.3 * self.seconds)):
            self._mark()
            self.stretch = self.elapsed() - self._a
            self.prof.stop()
            self.state = "done"

    def note(self, item) -> None:
        """Record a call issued inside the stretch."""
        if self.state == "on":
            self.traced_calls.append(item)

    def _mark(self) -> None:
        from torch.profiler import record_function
        with record_function("crfbench.mark"):
            self.sync()

    def close(self) -> float:
        self.sync()
        self.t1 = time.perf_counter()
        if self.state in ("lead", "on"):     # a window too short to finish
            if self.state == "on":
                self._mark()
                self.stretch = self.elapsed() - self._a
            self.prof.stop()
            self.state = "done"
        return self.t1 - self.t0


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()


def base_name(name: str) -> str:
    """A kernel's name without its namespaces and template arguments."""
    return short_name(name).split("<")[0].split("::")[-1].strip()


def reduce_trace(window: Window) -> dict | None:
    """The traced stretch as plain data: device intervals (name, start,
    end; seconds from mark a, clipped to the stretch), the host's ranges
    in it, the stretch's length, and the calls noted in it.  None where
    nothing was traced."""
    if window.prof is None or window.stretch is None:
        return None
    from torch.autograd import DeviceType
    evs = window.prof.events()
    marks = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.name == "crfbench.mark")
    if len(marks) < 2:
        return None
    a, b = marks[0][1], marks[-1][0]             # microseconds
    dev, host = [], []
    for e in evs:
        s, t = e.time_range.start, e.time_range.end
        if t <= a or s >= b:
            continue
        item = (e.name, (max(s, a) - a) * 1e-6, (min(t, b) - a) * 1e-6)
        if e.device_type == DeviceType.CUDA:
            dev.append(item)
        elif e.name != "crfbench.mark":
            host.append(item)
    return {"device": dev, "host": host, "span_s": (b - a) * 1e-6,
            "calls": list(window.traced_calls)}


def union_seconds(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for s, t in sorted(intervals):
        if t <= end:
            continue
        total += t - max(s, end)
        end = t
    return total


def idle_gaps(intervals, span: float) -> list:
    """The stretches of ``[0, span]`` that no interval covers."""
    gaps, end = [], 0.0
    for s, t in sorted(intervals):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if end < span:
        gaps.append((end, span))
    return gaps


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time, and the idle time by
    what the host was doing (the innermost host range at each gap's
    middle; ``python`` where none)."""
    by_op = {}
    for name, s, t in trace["device"]:
        k = short_name(name)[:96]
        by_op[k] = by_op.get(k, 0.0) + (t - s)
    host = sorted(trace["host"], key=lambda h: h[1])
    by_host = {}
    for s, t in idle_gaps([(s, t) for _, s, t in trace["device"]],
                          trace["span_s"]):
        mid = 0.5 * (s + t)
        inner = [h for h in host if h[1] <= mid <= h[2]]
        k = (min(inner, key=lambda h: h[2] - h[1])[0][:96] if inner
             else "python")
        by_host[k] = by_host.get(k, 0.0) + (t - s)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def busy_seconds(trace: dict) -> float:
    return union_seconds((s, t) for _, s, t in trace["device"])


# ---------------------------------------------------------------------------
# the run's record
# ---------------------------------------------------------------------------

def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is,
    whole, one of ``FORBIDDEN``."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def device_record(count: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def percentile(values, q: float) -> float:
    """The ``q``-quantile by the nearest rank: the smallest value with at
    least ``q`` of the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def check_line(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: each number the cell's
    limits name compared against its limit (a number above its limit, or
    not finite, fails)."""
    out, ok = {}, True
    for k, lim in limits.items():
        v = numbers[k]
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        out[k] = {"value": v, "limit": lim}
    return ok, out


def emit(result: dict, check: dict) -> None:
    """The check's numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output,
    the check last in it."""
    for k, v in check.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    result = dict(result, check=check)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
