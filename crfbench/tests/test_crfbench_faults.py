"""The comparison that decides ``correct``, shown to fail.  On the CPU each
cell's mode runs at a small size (the look for a card skipped, the
port's plain versions underneath, every product in fp32) under the cell's
own limits: a sound run comes out correct, and a run with each fault the
cell can have (``crfbench/faults.py``) planted underneath the timed path
not.  Marked ``cuda``: every cell at its own size on the card, as the
benchmark runs it, correct, and its control (the precision below the
configuration's: the CPU twins of the lower precisions compute in fp32, as
the JAX package's CPU path does, so only the card shows it) not.

    python -m pytest crfbench/tests -q
    python -m pytest crfbench/tests -q -m cuda      # on the card
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from crfbench import faults, harness

ROOT = Path(__file__).resolve().parent.parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 4321

# small stand-ins of each configuration and traffic: the same family, mode
# and precisions, widths a CPU test can hold
SMALL_MODEL = {
    "timit-triphone-fdt": {"num_labels": 4, "feat_dim": 12, "num_states": 3,
                           "trans_range": [0, 12]},
    "scrf-timit": {"num_labels": 5, "feat_dim": 12, "max_dur": 4},
}
SMALL_TRAFFIC = {"batch": 4, "utterances": 15, "buckets": [16, 24],
                 "lengths": {"dist": "uniform", "lo": 12, "hi": 24},
                 "phone_run": [3, 6]}
FAULTS = {"train": ["frozen", "half_batch"], "decode": ["token"]}


def _small(name):
    w = next(w for w in SPEC["workloads"] if w["name"] == name)
    cell = harness.load_cell(name, SEED, 0.5, False, root=ROOT)
    cell.config = dict(cell.config, model=SMALL_MODEL[w["config"]],
                       init_std=0.3,
                       precision={"train": "highest", "decode": "highest"})
    t = dict(SMALL_TRAFFIC, mode=cell.traffic["mode"])
    if cell.traffic["mode"] == "train":
        t["steps_per_call"] = cell.traffic["steps_per_call"]
        t["utterances"] = 9 * t["batch"] - 1    # a shorter group, empty rows
    cell.traffic = t
    return cell


def _correct(cell):
    out = harness.module(cell).run(cell, "cpu")
    return harness.check_line(out["numbers"], cell.limits)


CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    ok, line = _correct(_small(name))
    assert ok, line


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in CELLS for f in FAULTS[_small(n).traffic["mode"]]])
def test_a_planted_fault_is_not_correct(name, fault):
    undo = faults.plant(fault)
    try:
        ok, line = _correct(_small(name))
    finally:
        undo()
    assert not ok, line


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")


def _on_card(name, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "crfbench.run", "--workload", name, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0", *extra], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct_on_the_card(card, name):
    assert _on_card(name)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(card, name):
    assert not _on_card(name, "--control", "1")["correct"]
