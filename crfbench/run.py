"""Run one cell of the benchmark and print its result line.

    python -m crfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from a profiler trace of
a stretch of the window.  ``--control 1`` runs the cell at the precision
below its configuration's, the control whose comparison has to fail, and
``--fault <name>`` plants one of ``crfbench/faults.py``'s faults; the
benchmark's own runs pass neither.

Exits 2, printing no result, without as many CUDA devices as the cell
asks for; exits 3 where a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()                  # the process's start, near enough

import argparse                        # noqa: E402
import json                            # noqa: E402
import sys                             # noqa: E402
from pathlib import Path               # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    return p.parse_args(argv)


def metrics_of(cell, out: dict, spec: dict) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer ones
    (``--trace 1``), each ``{"value", "unit"}``; a per-layer reader that
    finds nothing leaves its metric out."""
    from crfbench import harness
    if cell.trace:
        ctx = {"cell": cell, "trace": out["trace"]}
        got = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(ctx)
            if v is not None:
                got[m["name"]] = {"value": v, "unit": m["unit"]}
        return got
    values = dict(out["e2e"], setup_s=out["t0_epoch"] - T_START)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec["end_to_end"]
            if cell.name in m.get("workloads", [cell.name])}


def main(argv=None) -> int:
    args = parse(argv)
    root = Path(".")
    from crfbench import harness
    cell = harness.load_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), bool(args.control), root)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)           # one process, few threads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.fault:
        from crfbench import faults
        faults.plant(args.fault)
    out = harness.module(cell).run(cell, "cuda")
    if cell.trace and out["trace"] is None:
        print("no traced stretch: the window is too short", file=sys.stderr)
        return 4
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    with open(root / "BENCHMARK.json") as f:
        spec = json.load(f)
    correct, check = harness.check_line(out["numbers"], cell.limits)
    device = harness.device_record(cell.chips, out["peak"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": metrics_of(cell, out, spec), "device": device}
    if cell.trace:
        device["busy_s"] = harness.busy_seconds(out["trace"])
        device["window_s"] = out["trace"]["span_s"]
        result["breakdown"] = harness.breakdown(out["trace"])
    harness.emit(result, check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
