"""Read the comparison's numbers of one cell on many seeds in one process:
the sound program's, the control's (``--control 1``) or a planted fault's
(``--fault <name>``), from which ``limits/<workload>.json`` is set.  Each
seed runs the cell's own set-up, checked call, window and comparison
(``modes/<family>_<mode>.py``'s ``run``), with a short window; one JSON
line a seed.  The benchmark's own runs never call this.

    python -m crfbench.readings --workload <name> --seeds <n>,<n>,... \
        [--control 1] [--fault <name>] [--seconds 0.5]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=0.5)
    args = p.parse_args(argv)

    import torch
    from crfbench import harness
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.fault:
        from crfbench import faults
        faults.plant(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(args.workload, seed, args.seconds, False,
                                 bool(args.control), Path("."))
        t = time.perf_counter()
        out = harness.module(cell).run(cell, "cuda")
        correct, _ = harness.check_line(out["numbers"], cell.limits)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": bool(args.control),
                          "fault": args.fault, "correct": correct,
                          "numbers": out["numbers"],
                          "seconds": time.perf_counter() - t}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
