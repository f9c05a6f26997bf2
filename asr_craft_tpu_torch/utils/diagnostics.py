"""Observability and correctness-paranoia utilities.

Counterpart of :mod:`asr_craft_tpu.utils.diagnostics`, with PyTorch's tools:

- ``span`` / ``count`` / ``summary`` / ``reset``: the port's one recorder of
  spans and counters, the kernels' launch counts among them (below).
- ``profiler_session``: a ``torch.profiler`` trace (CPU and CUDA
  activities) around training, written as a Chrome trace (open it in
  Perfetto or ``chrome://tracing``) into ``--profile_dir``, with
  ``spans.json`` (:func:`summary`) beside it; the spans appear in the trace
  as named ranges, their attrs as the ranges' args.
- ``enable_debug_nans``: JAX raises ``FloatingPointError`` at the first NaN
  or inf any operation produces.  Here: autograd's anomaly detection (it
  checks what every backward produces, the custom ``autograd.Function``s'
  too) plus :func:`check_finite` on the loss, the gradient norm and the
  parameters of every step in ``Trainer.train_step``.  The parameters are in
  it because a kernel's guards can swallow a NaN (``fmaxf`` drops a NaN
  operand, so a poisoned weight comes out of K1 on the card as a huge finite
  loss).  It costs a host-device synchronisation a step; that is what the
  flag buys.
- ``deterministic``: a seeded ``torch.Generator``, the port's explicit
  generator idiom.  ``torch.use_deterministic_algorithms`` is left off: on a
  CUDA device the main path's ``cumsum`` (``kernels.segmental.frame_grad``,
  ``_pack_segment_markers``) refuses it, and the port's own kernels are
  deterministic by construction (no atomics; partials summed in a fixed
  order).  What is left to pin down is the seed, and presentation order
  derives from (seed, epoch) in ``data.loader``.
- ``assert_replicated``: the cross-rank sync assertion.  With one process
  it returns without comparing, as the JAX function does with one device;
  under an initialised ``torch.distributed`` world of several ranks it
  gathers every rank's copy and compares.

Spans and counters.  ``with span(name, **attrs):`` times a stretch of host
code with ``time.perf_counter_ns``; a per-thread stack gives each span its
parent, and the recorder keeps, per name, the count, the total seconds and
the self seconds (the total less what its child spans cover).  Two kinds:

- set-up spans (:data:`SETUP_SPANS`: a graph's warm-up and capture, the
  kernels' library loaded or built) happen once a shape or a process and
  always record;
- every other span is a per-call span: it records only while a
  ``torch.profiler`` is recording.  Its gate is one
  ``torch.autograd._profiler_enabled()`` check; when that is false nothing
  else runs, so a span on a hot path costs the check.

While a profiler records, a span of either kind also opens a profiler range
of its name, with its attrs as the range's args (exported where the
profiler records shapes), so the span lies in the same trace as the
device's kernels, on their clock.  The range is an operator-scoped one
(``_RecordFunctionFast``), not ``record_function``'s user annotation: a
user annotation gets a twin interval on the device's timeline, over the
kernels it launched, which a reader of device time would count as work.

``count(name, n)`` adds to a counter (always on: an integer add under a
lock).  ``summary()`` returns the spans' aggregates and the counters.

The kernel wrappers count each launch that reaches the device in the
counter ``kernels.<kernel>`` or ``kernels.<kernel>[<design>]``.  The graph
runner captures inside :func:`held_launches` and hands what it held to
:func:`add` at each replay: an eager call or a warm-up counts as it
launches, a capture nothing, a replay what its capture launched.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, Optional

import torch

SETUP_SPANS = frozenset({"graph.warm_up", "graph.capture", "kernels.load",
                         "kernels.build"})

_lock = threading.Lock()
_spans: dict = {}          # name -> [count, total ns, self ns]
_counters: dict = {}       # name -> int
_local = threading.local()
_OFF = contextlib.nullcontext()
LAUNCHES = "kernels."      # the prefix of the kernels' launch counters


def recording() -> bool:
    """Whether a ``torch.profiler`` is recording: the per-call spans'
    gate."""
    return torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "attrs", "range", "parent", "start", "children")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.range = name, attrs, None

    def __enter__(self):
        if recording():
            self.range = torch._C._profiler._RecordFunctionFast(
                self.name, (), self.attrs)
            self.range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.children = 0
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter_ns() - self.start
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].children += total
        with _lock:
            agg = _spans.get(self.name)
            if agg is None:
                agg = _spans[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += total
            agg[2] += total - self.children
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context that times its body as the span ``name`` and gives the
    span (its ``parent``: the innermost span open on this thread when it
    began), or None where a per-call span does not record; ``attrs`` (ints
    and strings) go to the profiler range's args."""
    if name in SETUP_SPANS or recording():
        return _Span(name, attrs)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def add(counts: dict) -> None:
    """Add each ``counts[name]`` to the counter ``name``, under one lock
    acquire (a graph's replay: what its capture held back)."""
    with _lock:
        for name, n in counts.items():
            _counters[name] = _counters.get(name, 0) + n


def launches() -> dict:
    """The kernels' launch counters, ``{"kernels.<...>": n}`` (a copy)."""
    with _lock:
        return {k: n for k, n in _counters.items() if k.startswith(LAUNCHES)}


@contextlib.contextmanager
def held_launches() -> Iterator[dict]:
    """Hold back the launch counts made inside the context, on every thread
    (autograd's device thread launches a capture's backward): on exit the
    launch counters are as they were at entry, and the dict the context
    gives holds what was counted inside it, ``{name: n}``, for :func:`add`.
    Other counters are left alone."""
    before, held = launches(), {}
    try:
        yield held
    finally:
        with _lock:
            now = {k: _counters.pop(k) for k in list(_counters)
                   if k.startswith(LAUNCHES)}
            _counters.update(before)
        held.update((k, n - before.get(k, 0)) for k, n in now.items()
                    if n != before.get(k, 0))


def summary() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: n}}`` (plain data, a copy; the launch counts are counters)."""
    with _lock:
        spans = {k: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
                 for k, (c, t, s) in _spans.items()}
        return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    """Forget every span's aggregate and every counter, the launch counts
    included."""
    with _lock:
        _spans.clear()
        _counters.clear()


@contextlib.contextmanager
def profiler_session(profile_dir: Optional[str]) -> Iterator[None]:
    """Trace everything inside the context into ``profile_dir/trace.json``
    and write :func:`summary` to ``profile_dir/spans.json`` (no-op when
    None)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    with open(os.path.join(profile_dir, "spans.json"), "w") as f:
        json.dump(summary(), f, indent=1)


def enable_debug_nans(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(bool(on), check_nan=bool(on))


def debug_nans_enabled() -> bool:
    """Whether the trainer checks every step (the anomaly mode is the
    flag)."""
    return torch.is_anomaly_enabled()


def check_finite(what: str, step: int, **values) -> None:
    """Raise ``FloatingPointError`` naming ``step`` if any of ``values``
    (tensors) holds a NaN or an inf.  One host fetch."""
    bad = [k for k, v in values.items()
           if not bool(torch.isfinite(v).all())]
    if bad:
        raise FloatingPointError(
            f"{what}: non-finite {', '.join(bad)} at step {step} "
            "(--debug_nans)")


def deterministic(seed: int = 0) -> torch.Generator:
    """A generator seeded with ``seed``: the root of a reproducible run
    (``init_params`` and the tests take it explicitly)."""
    return torch.Generator().manual_seed(seed)


def assert_replicated(tree: dict, atol: float = 0.0,
                      what: str = "params") -> None:
    """Assert that every rank holds the same values of each tensor of
    ``tree``.

    Run every N steps under data parallelism to catch replica divergence.
    Returns at once when ``torch.distributed`` is not initialised or the
    world has one rank.
    """
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return
    for key, leaf in tree.items():
        mine = leaf.detach().contiguous()
        copies = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(copies, mine)
        for rank, got in enumerate(copies[1:], start=1):
            if not torch.allclose(copies[0], got, atol=atol, rtol=0):
                diff = float((copies[0] - got).abs().max())
                raise AssertionError(
                    f"{what}[{key!r}] diverges across ranks 0 vs {rank}: "
                    f"max abs diff {diff}")


def grad_sync_check_hook(every: int = 100):
    """Returns ``hook(step, params)`` to call from the training loop."""
    def hook(step: int, params) -> None:
        if every and step % every == 0:
            assert_replicated(params)
    return hook
