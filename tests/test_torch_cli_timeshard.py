"""The CLIs over several ranks and chunks, mirroring
tests/e2e/test_cli_timeshard.py: ``cli.decode --time_shard 8`` writes the
unsharded decode's MLF byte for byte, with ``--shard_beam_labels 4`` it
scores PER < 0.25 on separable data; ``cli.train`` under ``python -m
torch.distributed.run`` on 2 gloo ranks trains data-parallel with
``--check_sync_every 1``, rank 0 alone writing.  The weights come from the
port's own train CLI (24 synthetic utterances, 6 labels, one state, shared
transitions), as the JAX test trains its own.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from asr_craft_tpu_torch.cli import decode as decode_cli
from asr_craft_tpu_torch.cli import train as train_cli

REPO = Path(__file__).resolve().parent.parent
TRAIN = ["--synthetic_utts", "24", "--synthetic_noise", "0.3",
         "--crf_label_size", "6", "--crf_lr", "1.0", "--batch_size", "8",
         "--bucket_sizes", "256", "--device", "cpu"]
DECODE = ["--synthetic_utts", "10", "--synthetic_noise", "0.3",
          "--crf_label_size", "6", "--batch_size", "8", "--bucket_sizes",
          "256", "--device", "cpu"]


def _records(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


@pytest.fixture(scope="module")
def weight_file(tmp_path_factory):
    out = tmp_path_factory.mktemp("ts_train")
    _records(train_cli.main, TRAIN + ["--crf_epochs", "2", "--out_dir",
                                      str(out)])
    return str(out / "weights.final.dat")


def _decode(weight_file, tmp_path, name, extra):
    mlf = tmp_path / f"{name}.mlf"
    recs = _records(decode_cli.main, DECODE + [
        "--weight_file", weight_file, "--out_mlf", str(mlf)] + extra)
    return [r for r in recs if r["kind"] == "decode_done"][-1], mlf


def test_cli_time_shard_matches_unsharded(weight_file, tmp_path):
    ref, ref_mlf = _decode(weight_file, tmp_path, "ref", [])
    sh, sh_mlf = _decode(weight_file, tmp_path, "sh", ["--time_shard", "8"])
    assert sh_mlf.read_bytes() == ref_mlf.read_bytes()
    assert sh["per"] == ref["per"] and ref["tokens"] > 0


def test_cli_time_shard_pruned(weight_file, tmp_path):
    done, _ = _decode(weight_file, tmp_path, "pruned",
                      ["--time_shard", "8", "--shard_beam_labels", "4"])
    assert done["per"] < 0.25, done
    with pytest.raises(SystemExit, match="shard_beam_labels"):
        decode_cli.main(DECODE + ["--weight_file", weight_file,
                                  "--time_shard", "8", "--beam_width", "3"])


def test_cli_train_two_ranks(tmp_path):
    """torchrun's 2 ranks: one JSON stream (rank 0's), one metrics file
    with each epoch once, the weight files and the checkpoint; the
    replicas checked after every step."""
    out = tmp_path / "dp"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "asr_craft_tpu_torch.cli.train",
         *TRAIN, "--crf_epochs", "2", "--check_sync_every", "1",
         "--out_dir", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    printed = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
    logged = [json.loads(ln) for ln in
              (out / "metrics.jsonl").read_text().splitlines()]
    for recs in (printed, logged):
        epochs = [r for r in recs if r["kind"] == "train_epoch"]
        assert [r["epoch"] for r in epochs] == [0, 1], recs
        assert [r["kind"] for r in recs].count("done") == 1
        assert epochs[1]["mean_loss"] < epochs[0]["mean_loss"]
    assert sorted(p.name for p in out.iterdir()) == [
        "ckpt", "metrics.jsonl", "weights.final.dat", "weights.i0.dat",
        "weights.i1.dat"]
    evals = [r for r in printed if r["kind"] == "eval"]
    assert evals and evals[-1]["per"] < 0.25
