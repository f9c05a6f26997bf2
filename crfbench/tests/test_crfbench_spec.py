"""BENCHMARK.json against the benchmark's contract: names, units and
lines; every entry's keys; each cell's files found by name; the module
check; and the run's exit without a card.

    python -m pytest crfbench/tests -q
"""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from crfbench import harness

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = ROOT / "crfbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_the_top_level_keys_and_the_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["crfbench"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_the_full_check_fits_its_time_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and \
            _line(c["why"])
        assert c["file"].startswith("crfbench/") and \
            (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
    all_names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in SPEC[k]]
    assert len(all_names) == len(set(all_names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in SPEC["workloads"]:
        mine = [m for m in SPEC["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        layers = [m for m in SPEC["per_layer"] if w["name"] in m["workloads"]]
        assert layers
        for m in layers:
            assert m["moves"] in [x["name"] for x in mine]


def test_every_cell_finds_its_files_by_name():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"], 1, 10.0, False, root=ROOT)
        assert (BENCH / "modes" / f"{cell.module}.py").is_file()
        assert set(cell.limits) >= {"path_gap"} or \
            set(cell.limits) >= {"loss_gap", "change_gap"}
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("names,bad", [
    (["jax", "jax.numpy", "numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax.linen", "jaxlib.xla_client"]),
    (["asr_craft_tpu", "asr_craft_tpu.models.crf"],
     ["asr_craft_tpu", "asr_craft_tpu.models.crf"]),
    (["asr_craft_tpu_torch", "asr_craft_tpu_torch.models.crf", "jaxtyping",
      "crfbench.run"], []),
])
def test_the_module_check_compares_whole_top_level_names(names, bad):
    assert harness.forbidden_modules(names) == bad


def test_the_references_import_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ("torch", "__future__"), \
                    f"{path.name} imports {m}"


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    code = ("import sys, crfbench.run, crfbench.check, crfbench.faults\n"
            "from crfbench import harness\n"
            "from crfbench.modes import crf_train, crf_decode, "
            "scrf_decode\n"
            "import asr_craft_tpu_torch.train, "
            "asr_craft_tpu_torch.models.segmental, "
            "asr_craft_tpu_torch.parallel.mesh\n"
            "print(harness.forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "crfbench.run", "--workload",
         SPEC["workloads"][0]["name"], "--seed", "2147483999", "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=timeout)


def test_without_a_card_the_run_exits_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_with_only_its_own_files_the_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "crfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
