"""The port's bench (``asr_craft_tpu_torch.bench``, the twin of the root
``bench.py``) on the CPU at small shapes (B=4, T=32): every function runs,
the records carry the keys of the dict literals in the root script (with
``fma_ms`` where the tile floor had its matrix-unit passes; the train run at
``bf16x3`` and its ``highest`` twin, as there), the floors are positive,
and what waits for another slice raises.
"""
import ast
import json
from pathlib import Path

import pytest
import torch

from asr_craft_tpu_torch import bench

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(
    train=dict(calls=1, spc=2, B=4, T=32),
    loader=dict(n_utts=8, B=4, min_len=20, max_len=32),
    dec=dict(steps=2, warmup=1, B=4, T=32),
    floor=dict(Ts=(8, 16, 32), steps=2, B=4),
    calib=dict(n_mb=2, iters=2, Dmax=4, Ls=6, Bk=4),
    scrf=dict(steps=1, Bs=4, Ts=32, L=6, D=8, Dmax=4, sweep=(8, 16, 32)))


def _literal_keys(func: str):
    """The key tuples of every dict literal with constant string keys in
    function ``func`` of the root bench.py, in source order."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) and isinstance(k.value, str)
                for k in node.keys):
            out.append((node.lineno, node.col_offset,
                        tuple(k.value for k in node.keys)))
    return [keys for _, _, keys in sorted(out)]


@pytest.fixture(scope="module")
def records():
    recs = {}
    for rec in bench.bench_records("cpu", **SMALL):
        json.dumps(rec)                       # every record prints
        recs.update(rec if "metric" not in rec else {"_metric": rec})
    return recs


def test_record_order_is_the_root_scripts(records):
    printed = [k[0] for k in _literal_keys("main") if len(k) == 1]
    assert printed == ["scaling", "decode_floor", "roofline_train",
                       "roofline_decode", "scrf", "aux"]
    ours = [k for k in records if k != "_metric"]
    assert ours == ["calibration", "device_busy"] + printed[1:]


def test_decode_floor_keys_and_fit(records):
    want = max(_literal_keys("bench_decode_floor"), key=len)
    assert tuple(records["decode_floor"]) == want
    assert set(records["decode_floor"]["measured_ms"]) == {8, 16, 32}
    assert all(v > 0 for v in records["decode_floor"]["measured_ms"].values())


def test_scrf_record_keys(records):
    outer, *inner = sorted(_literal_keys("bench_scrf"), key=len,
                           reverse=True)
    scrf = records["scrf"]
    assert tuple(scrf) == outer
    assert tuple(scrf["decode_floor"]) in inner
    tile = scrf["tile_floor"]
    for key in ("train_floor_ms", "decode_floor_ms", "train_floor_total_ms",
                "decode_floor_total_ms"):
        assert tile[key] > 0, key
    assert tile["train_floor_total_ms"] >= tile["train_floor_ms"]
    assert set(tile["kernels_ms"]) == {"fwd", "bwd", "grad", "vit", "tb"}
    assert scrf["train_ms"] > 0 and scrf["decode_ms"] > 0
    assert set(scrf["roofline_train"]["phases"]) == {
        "scrf_prep", "scrf_forward", "scrf_backward", "scrf_grad",
        "scrf_numerator", "scrf_grad_finish"}


def test_aux_and_metric_keys(records):
    lits = _literal_keys("main")
    aux = next(k for k in lits if "decode_B" in k)
    metric = next(k for k in lits if "vs_baseline" in k)
    assert tuple(records["aux"]) == tuple(aux)
    assert tuple(records["_metric"]) == metric
    assert records["_metric"]["vs_baseline"] is None
    assert records["_metric"]["value"] > 0
    assert records["aux"]["train_precision"] == "bf16x3"
    assert 0.0 <= records["aux"]["train_loss_delta_vs_fp32"] < 1e-3
    assert records["aux"]["train_fp32_audio_s_per_s"] > 0
    assert (records["aux"]["B"], records["aux"]["T"],
            records["aux"]["decode_B"]) == (4, 32, 4)


def test_roofline_records(records):
    train, dec = records["roofline_train"], records["roofline_decode"]
    assert list(train["phases"]) == ["fdt_prep", "fdt_forward",
                                     "fdt_backward_grad", "optimizer"]
    assert list(dec["phases"]) == ["fdt_prep", "fdt_viterbi_forward",
                                   "fdt_traceback"]
    assert set(train["tile_floor"]) == {"fma_ms", "vpu_ms", "floor_ms"}
    assert train["tile_floor"]["floor_ms"] > 0
    assert train["pct_of_tile_floor"] > 0 and train["sol_ms"] > 0
    assert "vpu_geps_measured" in train and "vpu_geps_measured" not in dec


def test_cpu_run_is_never_called_a_device_measurement(records):
    cal = records["calibration"]
    assert cal["elementwise"]["calibration"] == "plain"
    assert cal["elementwise"]["device"] == "cpu" and cal["stream_gbps"] > 0
    assert records["device_busy"] == {"train_step": None, "decode": None,
                                      "scrf_train": None,
                                      "scrf_decode": None}


def test_train_step_and_loader_functions():
    tput, dt, loss = bench.bench_train_step(calls=1, spc=2, B=4, T=32,
                                            device="cpu")
    assert tput == pytest.approx(4 * 32 * 0.01 / dt) and dt > 0
    assert 0.0 < loss < 10.0
    assert bench.bench_train_epoch_loader(n_utts=8, B=4, min_len=20,
                                          max_len=32, device="cpu") > 0
    tput, dt = bench.bench_decode(steps=2, warmup=1, B=4, T=32,
                                  device="cpu")
    assert tput == pytest.approx(4 * 32 * 0.01 / dt)


def test_what_waits_for_another_slice_raises():
    """``--scaling`` on the CPU needs its number of gloo ranks stated, and on
    the card a card (no CPU fallback)."""
    with pytest.raises(ValueError, match="gloo ranks"):
        bench.main(["--device", "cpu", "--scaling"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.bench_scaling(check=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main([])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.bench_decode(steps=1, B=2, T=8)
    assert bench.TRAIN_PRECISION == "bf16x3"        # the root script's
    assert not hasattr(bench, "BASELINE_AUDIO_S_PER_S")
