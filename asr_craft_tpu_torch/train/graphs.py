"""CUDA graphs of the port's steps: the counterpart of ``jax.jit``.

JAX compiles a step once per input shape and runs it as one program.  Here
a :class:`Graphed` function is captured into a ``torch.cuda.CUDAGraph`` once
per shape and replayed, so a train step, a K-step call or a decode goes out
as one launch instead of one launch per kernel.  The capture records the
same Python code that runs eagerly, so the two give the same bits.

- ``Graphed(fn)(bound, inputs)`` calls ``fn(bound, inputs)``.  ``bound``
  holds the tensors the graph reads and writes where they lie (parameters,
  optimizer state, a learning-rate tensor); ``inputs`` the tensors that
  change from call to call (a batch), copied on the device into the graph's
  own buffers before each replay.  Both are trees of dicts, lists and
  tuples; a leaf that is not a tensor is a static argument.
- The cache is keyed by the inputs' shapes and dtypes, the static leaves'
  values, the bound tensors' addresses (so a graph only ever runs on the
  tensors it was captured with) and the settings that choose what the
  code launches: the kernel backend, grad mode, TF32.  It keeps
  ``MAX_SHAPES`` graphs a function and drops the least recently used.
- The first call of a key is the warm-up PyTorch's capture recipe asks for:
  it runs eagerly on a side stream and returns its result.  That builds and
  loads the kernels' library, launches every kernel of the path once (so the
  module that the library's own CUDA runtime loads lazily is loaded outside
  capture), fills the ``lru_cache``s and creates the optimizer's state.
  Then the graph is captured, and later calls replay it.
- One memory pool per owner (:class:`Pool`), shared by the owner's graphs:
  they replay one at a time on one stream, so they may share what each
  frees inside its own run.
- The kernels' launch counters (``kernels.*``) count what reached the
  device: the capture runs inside ``diagnostics.held_launches()``, and
  each replay adds what it held, so every call of a key moves them as one
  eager call does.
- :func:`disabled`, the counterpart of ``jax.disable_jit()``: inside it
  every Graphed function runs its eager code.  Calls on CPU tensors are
  eager too.  Nothing else is: a capture or a replay that fails on a CUDA
  tensor raises.
- Spans and counters (``utils.diagnostics``): a call on the card is the
  span ``graph.call`` (its self time: the cache key and lookup, the
  counters' add), with the children ``graph.copy_in``, ``graph.replay`` (the
  graph's launch) and ``graph.copy_out``; these record while a profiler
  does.  A first call of a key is the set-up spans ``graph.warm_up`` and
  ``graph.capture`` (the capture and the graph's instantiation).  Counters,
  per graph name ``<name>``: ``graph.replays[<name>]``,
  ``graph.captures[<name>]``, ``graph.evictions[<name>]`` (least recently
  used graphs dropped past ``MAX_SHAPES``), ``graph.eager_calls[<name>]``;
  and ``graph.nodes[<name>#<i>]``, the node count of the ``i``-th graph
  captured, which sets what one launch costs the host.

Capture runs in the ``thread_local`` error mode: a trainer's prefetch thread
pins host memory and copies batches to the card while the main thread
captures, and the ``global`` mode would count that against the capture.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
from collections import OrderedDict
from typing import Callable, Iterator, Optional

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.utils import diagnostics

MAX_SHAPES = 8               # the train CLI's five default buckets fit

_disabled = 0


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Run every :class:`Graphed` function eagerly inside the context (the
    counterpart of ``jax.disable_jit()``); the contexts nest."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def enabled() -> bool:
    """Whether Graphed functions capture and replay (outside
    :func:`disabled`)."""
    return _disabled == 0


def leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``tree`` with every leaf ``x`` replaced by ``fn(x)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _structure(tree):
    """The tree's keys and nesting, without its leaves."""
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_structure(v) for v in tree)
    return None


def _key(bound, inputs) -> tuple:
    def leaf(x, by_address):
        if not isinstance(x, torch.Tensor):
            return x
        where = (x.data_ptr(),) if by_address else ()
        return where + (tuple(x.shape), x.dtype, x.device)
    # and the process-wide settings that choose what the code launches
    return (kernels.backend(), torch.is_grad_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            _structure(bound), _structure(inputs),
            tuple(leaf(x, True) for x in leaves(bound)),
            tuple(leaf(x, False) for x in leaves(inputs)))


def on_cuda(*trees) -> bool:
    """Whether any tensor leaf of ``trees`` lies on a CUDA device."""
    return any(isinstance(x, torch.Tensor) and x.is_cuda
               for t in trees for x in leaves(t))


class Pool:
    """The memory pool one owner's graphs share, made at first use."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class _Entry:
    # counts: what a replay adds to the counters
    __slots__ = ("graph", "inputs", "outputs", "counts", "index")

    def __init__(self, graph, inputs, outputs, counts, index):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.counts = outputs, counts
        self.index = index


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device):
    """The warm-ups' stream on ``device``: one for every graph, since each
    stream a cuBLAS call meets keeps a workspace of its own."""
    return torch.cuda.Stream(device)


class Graphed:
    """``fn(bound, inputs)`` captured once per key and replayed (see the
    module's docstring).  The result is the caller's own: tensors copied
    out of the graph's outputs, which the next replay overwrites."""

    def __init__(self, fn: Callable, pool: Optional[Pool] = None,
                 name: Optional[str] = None):
        self.fn = fn
        self.pool = pool if pool is not None else Pool()
        self.name = name or getattr(fn, "__name__", "graph")
        self._cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._calls = self._captured = 0
        self._counter = {k: f"graph.{k}[{self.name}]" for k in (
            "replays", "captures", "evictions", "eager_calls")}

    def __len__(self) -> int:
        return len(self._cache)

    def __call__(self, bound, inputs):
        if not enabled() or not on_cuda(bound, inputs):
            diagnostics.count(self._counter["eager_calls"])
            return self.fn(bound, inputs)
        self._calls += 1
        with diagnostics.span("graph.call", graph=self.name,
                              call=self._calls):
            key = _key(bound, inputs)
            entry = self._cache.get(key)
            if entry is None:
                return self._warm_up_and_capture(key, bound, inputs)
            self._cache.move_to_end(key)
            with diagnostics.span("graph.copy_in"):
                src = [x for x in leaves(inputs)
                       if isinstance(x, torch.Tensor)]
                for dst, x in zip(entry.inputs, src):
                    dst.copy_(x)
            with diagnostics.span("graph.replay", shape=entry.index):
                entry.graph.replay()
            diagnostics.add(entry.counts)
            with diagnostics.span("graph.copy_out"):
                return tree_map(_clone, entry.outputs)

    def _warm_up_and_capture(self, key, bound, inputs):
        index = self._captured
        attrs = {"graph": self.name, "shape": index}
        device = next(x.device for x in leaves((bound, inputs))
                      if isinstance(x, torch.Tensor) and x.is_cuda)
        here = torch.cuda.current_stream(device)
        side = _side_stream(device)
        with diagnostics.span("graph.warm_up", **attrs):
            side.wait_stream(here)
            with torch.cuda.stream(side):
                result = self.fn(bound, inputs)
            here.wait_stream(side)
        with diagnostics.span("graph.capture", **attrs):
            entry = self._capture(bound, inputs, index)
            nodes = _node_count(entry.graph)
        self._captured += 1
        diagnostics.count(self._counter["captures"])
        diagnostics.count(f"graph.nodes[{self.name}#{index}]", nodes)
        self._cache[key] = entry
        while len(self._cache) > MAX_SHAPES:
            self._cache.popitem(last=False)
            diagnostics.count(self._counter["evictions"])
        return result

    def _capture(self, bound, inputs, index) -> _Entry:
        static = tree_map(_clone, inputs)
        # kept, so that its nodes can be counted once it is instantiated
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # Dead graphs (a step and its graphs form a reference cycle) are
        # destroyed now and not by a collection inside the capture, where
        # destroying a graph invalidates the capture.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # torch.cuda.graph synchronises the device before it captures,
            # so the warm-up's tensors are no longer in use on ``side``
            with diagnostics.held_launches() as launches, \
                    torch.cuda.graph(graph, pool=self.pool.handle(),
                                     capture_error_mode="thread_local"):
                outputs = self.fn(bound, static)
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture of {self.name} failed (no eager "
                "fallback: run it inside graphs.disabled() to take the "
                f"eager path): {exc}") from exc
        finally:
            if collecting:
                gc.enable()
        graph.instantiate()
        return _Entry(
            graph, [x for x in leaves(static) if isinstance(x, torch.Tensor)],
            outputs, {**launches, self._counter["replays"]: 1}, index)


@functools.lru_cache(maxsize=None)
def _graph_get_nodes():
    """``cudaGraphGetNodes`` of the CUDA runtime PyTorch loaded."""
    major = torch.version.cuda.split(".")[0]
    fn = ctypes.CDLL(f"libcudart.so.{major}").cudaGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    return fn


def _node_count(graph) -> int:
    """The node count of a captured graph (kept, instantiated)."""
    n = ctypes.c_size_t(0)
    code = _graph_get_nodes()(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                              ctypes.byref(n))
    if code != 0:
        raise RuntimeError(f"cudaGraphGetNodes failed: CUDA error {code}")
    return n.value
