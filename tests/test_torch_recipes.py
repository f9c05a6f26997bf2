"""The recipe twins 1, 2, 3 and 5 (``asr_craft_tpu_torch.recipes``) against
the JAX package's recipes (``recipes/*.py``, loaded by path): the same
``TRAIN_ARGS`` / ``DECODE_ARGS`` flag lists, and one tiny run each (two
epochs on 16 synthetic utterances, through each recipe's own ``main``) that
lands on the JAX run's per-epoch losses (rtol 1e-4), CV PER and decode
counts.
"""
import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from asr_craft_tpu_torch import kernels

REPO = Path(__file__).resolve().parent.parent
NAMES = ["timit_mono", "timit_triphone", "wsj_crandem", "swbd_multihost"]


def _jax_recipe(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_recipe_{name}", REPO / "recipes" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_recipe(name):
    return importlib.import_module(f"asr_craft_tpu_torch.recipes.{name}")


@pytest.mark.parametrize("name", NAMES)
def test_argument_lists_are_the_jax_recipes(name):
    ref, got = _jax_recipe(name), _port_recipe(name)
    assert got.TRAIN_ARGS == ref.TRAIN_ARGS
    assert getattr(got, "DECODE_ARGS", None) == \
        getattr(ref, "DECODE_ARGS", None)
    assert (name == "swbd_multihost") == (not hasattr(ref, "DECODE_ARGS"))


def _run(mod, extra, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(mod, "TRAIN_ARGS",
                        mod.TRAIN_ARGS + ["--crf_epochs", "2"])
    try:
        mod.main(["--synthetic_utts", "16", "--batch_size", "8"] + extra)
    finally:
        kernels.set_backend("auto")
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    return ([r["mean_loss"] for r in recs if r["kind"] == "train_epoch"],
            [r["per"] for r in recs if r["kind"] == "eval"],
            [(r["errors"], r["tokens"]) for r in recs
             if r["kind"] == "decode_done"])


@pytest.mark.parametrize("name", NAMES)
def test_tiny_run_lands_on_the_jax_run(name, tmp_path, monkeypatch, capsys):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _run(_port_recipe(name), ["--device", "cpu"], tmp_path / "port",
               monkeypatch, capsys)
    want = _run(_jax_recipe(name), ["--platform", "cpu"], tmp_path / "jax",
                monkeypatch, capsys)
    assert len(got[0]) == 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert got[1] == want[1] and got[2] == want[2]
    assert len(got[2]) == (0 if name == "swbd_multihost" else 1)
    run_dir = next((tmp_path / "port" / "runs").iterdir())
    assert (run_dir / "weights.final.dat").exists()


def test_timit_mono_drops_the_synthetic_corpus_for_a_pfile(monkeypatch):
    """``--ftr1_file`` takes the place of ``--synthetic_utts`` in recipe 1's
    train flags, as in the JAX recipe."""
    mod = _port_recipe("timit_mono")
    seen = []
    from asr_craft_tpu_torch.cli import decode as cli_decode
    from asr_craft_tpu_torch.cli import train as cli_train
    monkeypatch.setattr(cli_train, "main", lambda argv: seen.append(argv))
    monkeypatch.setattr(cli_decode, "main", lambda argv: seen.append(argv))
    mod.main(["--ftr1_file", "x.pfile"])
    assert "--synthetic_utts" not in seen[0] and "400" not in seen[0]
    assert seen[0][-2:] == ["--ftr1_file", "x.pfile"]
    assert seen[1] == mod.DECODE_ARGS + ["--ftr1_file", "x.pfile"]
