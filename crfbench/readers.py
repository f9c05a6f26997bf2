"""The arithmetic the per-layer metrics share (``metrics/<name>.py`` each
hold their own kernel-name lists and call these).

``ctx["trace"]`` is the traced stretch (``harness.reduce_trace``): device
intervals ``(name, start, end)`` in seconds, the stretch's length
``span_s``, and a note of each call issued in it, all of which ran inside
the stretch (it begins and ends in a synchronise).  ``ctx["cell"]`` is the
cell.  A reader returns None where it finds nothing to read.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path

from crfbench import harness, roofline

NCCL_PREFIX = "nccl"
CSRC = harness.HERE.parent / "asr_craft_tpu_torch" / "csrc"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


@functools.lru_cache(maxsize=None)
def port_kernels(csrc=CSRC) -> frozenset:
    """The port's own kernels: the name of every ``__global__`` function in
    its CUDA sources (``asr_craft_tpu_torch/csrc/*.cu``, ``*.cuh``), read
    where the run is, so that a kernel the program adds or renames counts
    as its own."""
    return frozenset(m.group(1) for path in sorted(Path(csrc).glob("*.cu*"))
                     for m in _GLOBAL.finditer(path.read_text()))


def _device(trace):
    return [(harness.base_name(n), s, t) for n, s, t in trace["device"]]


def idle_pct(ctx) -> float | None:
    """100 x (1 - the union of the device's intervals over the stretch)."""
    tr = ctx["trace"]
    if tr["span_s"] <= 0 or not tr["device"]:
        return None
    return 100.0 * (1.0 - harness.busy_seconds(tr) / tr["span_s"])


def _model(cell):
    m = cell.config["model"]
    L = m["num_labels"] * m.get("num_states", 1)
    return m, L


def steps(cell, call: dict):
    """``(B, T, frames, segments)`` of each step of a noted call."""
    B = int(cell.traffic["batch"])
    if "steps" in call:
        return [(B, T, f, None) for T, f in call["steps"]]
    return [(call["B"], call["T"], call["frames"], call.get("segments"))]


def step_phases(cell, B, T, frames, segments):
    """The frozen step model of the cell's path at one step's shape."""
    m, L = _model(cell)
    D = m["feat_dim"]
    if cell.config["family"] == "scrf":
        return roofline.scrf_decode_phases(B, T, m["num_labels"], D,
                                           m["max_dur"], frames, segments)
    ns = m.get("num_states", 1)
    if tuple(m.get("trans_range", (0, 0)))[1] == 0:
        return None                     # no frozen model of the shared path
    if cell.traffic["mode"] == "train":
        return roofline.fdt_train_phases(B, T, L, D, ns, frames)
    return roofline.fdt_decode_phases(B, T, L, D, ns, frames)


def mfu_pct(ctx, kind: str) -> float | None:
    """100 x the least time the traced steps' counted operations take at
    the published peaks (products at the precision's rate, the rest at
    fp32's) over the stretch."""
    cell, tr = ctx["cell"], ctx["trace"]
    prec = cell.precision(kind)
    if not tr["calls"] or tr["span_s"] <= 0:
        return None
    least = 0.0
    for call in tr["calls"]:
        for shape in steps(cell, call):
            phases = step_phases(cell, *shape)
            if phases is None:
                return None
            least += sum(p.op_seconds(prec) for p in phases)
    return 100.0 * least / tr["span_s"]


def sol_pct(ctx, kind: str, groups: dict) -> float | None:
    """100 x the group's least time (each kernel's larger of bytes over the
    memory rate and operations over their peaks) for the traced steps over
    the group's traced device time; ``groups`` maps kernel names to the
    frozen count that stands for them (several names to one count: the
    count is taken once)."""
    cell, tr = ctx["cell"], ctx["trace"]
    prec = cell.precision(kind)
    m, L = _model(cell)
    counts = sorted(set(groups.values()))
    dev = sum(t - s for n, s, t in _device(tr) if n in groups)
    if not tr["calls"] or dev <= 0:
        return None
    least = 0.0
    for call in tr["calls"]:
        for B, T, frames, segments in steps(cell, call):
            shape = dict(B=B, T=T, L=L, D=m["feat_dim"],
                         ns=m.get("num_states", 1), Dmax=m.get("max_dur"),
                         frames=frames, segments=segments)
            if cell.config["family"] == "scrf":
                shape["L"] = m["num_labels"]
            least += sum(roofline.kernel_phase(c, **shape).sol_seconds(prec)
                         for c in counts)
    return 100.0 * least / dev


def glue_pct(ctx) -> float | None:
    """100 x the device time of what is neither the port's kernels nor
    NCCL's over the busy time."""
    port = port_kernels()
    return share_pct(ctx, lambda n: n not in port
                     and not n.startswith(NCCL_PREFIX))


def share_pct(ctx, pick) -> float | None:
    """100 x the device time of the intervals whose kernel base name
    ``pick(name)`` accepts over the busy time (the union)."""
    tr = ctx["trace"]
    busy = harness.busy_seconds(tr)
    if busy <= 0:
        return None
    return 100.0 * sum(t - s for n, s, t in _device(tr) if pick(n)) / busy
