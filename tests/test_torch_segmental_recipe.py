"""The segmental path as a whole: the port's recipe twin
(``asr_craft_tpu_torch.recipes.scrf``, ``--device cpu``: the plain versions
of K9-K13) against the JAX package's ``recipes/scrf.py --platform cpu`` with
the same flags, on the same seeded corpus.

Tolerances: every logged loss within rtol 1e-4 (30 full-batch Adam steps in
fp32 from a zero start; the two packages sum in other orders); the eval's
``errors`` and ``tokens`` equal."""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import segmental as K
from asr_craft_tpu_torch.recipes import scrf as port_recipe

REPO = Path(__file__).resolve().parent.parent
FLAGS = ["--utts", "40", "--eval_utts", "60", "--epochs", "30"]


def _jax_recipe():
    spec = importlib.util.spec_from_file_location(
        "jax_recipe_scrf", REPO / "recipes" / "scrf.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]
    losses = {r["epoch"]: r["loss"] for r in recs
              if r["kind"] == "train_epoch"}
    evals = [r for r in recs if r["kind"] == "eval"]
    assert len(evals) == 1
    return losses, evals[0]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_scrf")
    losses, ev = _run(_jax_recipe().main,
                      FLAGS + ["--platform", "cpu", "--out_dir", str(out)])
    return losses, ev, out / "scrf_weights.npz"


def _same_counts(ev, jev):
    for key in ("errors", "tokens", "sub", "ins", "del", "eval_utts"):
        assert ev[key] == jev[key], (key, ev, jev)
    assert ev["per"] == jev["per"]


def test_recipe_matches_jax_recipe(jax_run, tmp_path):
    jlosses, jev, _ = jax_run
    before = dict(K.launches)
    losses, ev = _run(port_recipe.main,
                      FLAGS + ["--device", "cpu", "--out_dir", str(tmp_path)])
    assert sorted(losses) == sorted(jlosses) == [0, 25, 29]
    for epoch, want in jlosses.items():
        np.testing.assert_allclose(losses[epoch], want, rtol=1e-4)
    assert losses[29] < losses[0]
    _same_counts(ev, jev)
    assert K.launches == before                  # CPU tensors: plain versions
    lines = [json.loads(ln) for ln in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in lines] == ["train_epoch"] * 3 + ["eval"]
    with np.load(tmp_path / "scrf_weights.npz") as z:
        assert sorted(z.files) == ["b_dur", "b_seg", "b_trans", "w_frame"]
        assert z["w_frame"].shape == (12, 12) and z["b_dur"].shape == (16, 12)


def test_decode_only_takes_either_packages_weights(jax_run, tmp_path):
    """--decode_only on the JAX run's scrf_weights.npz gives the JAX counts;
    the JAX recipe decodes the port's weights to the port's counts."""
    _, jev, jweights = jax_run
    _, ev = _run(port_recipe.main,
                 FLAGS + ["--device", "cpu", "--decode_only", str(jweights),
                          "--out_dir", str(tmp_path / "dec")])
    _same_counts(ev, jev)
    _, pev = _run(port_recipe.main,
                  FLAGS + ["--device", "cpu", "--out_dir",
                           str(tmp_path / "train")])
    _, jdec = _run(_jax_recipe().main,
                   FLAGS + ["--platform", "cpu", "--decode_only",
                            str(tmp_path / "train" / "scrf_weights.npz"),
                            "--out_dir", str(tmp_path / "jdec")])
    _same_counts(pev, jdec)


@pytest.mark.parametrize("extra", [["--seg_states", "2"], ["--dense_loss"],
                                   ["--seg_states", "2", "--dense_loss"],
                                   ["--max_dur", "12", "--labels", "6"]])
def test_recipe_options_match_jax_recipe(extra, tmp_path):
    flags = ["--utts", "12", "--eval_utts", "20", "--epochs", "6"] + extra
    jlosses, jev = _run(_jax_recipe().main,
                        flags + ["--platform", "cpu", "--out_dir",
                                 str(tmp_path / "j")])
    losses, ev = _run(port_recipe.main,
                      flags + ["--device", "cpu", "--out_dir",
                               str(tmp_path / "t")])
    assert sorted(losses) == sorted(jlosses) == [0, 5]
    for epoch, want in jlosses.items():
        np.testing.assert_allclose(losses[epoch], want, rtol=1e-4)
    _same_counts(ev, jev)


def test_recipe_eval_on_training_corpus_and_backend_flag(tmp_path):
    """--eval_utts 0 scores the training corpus; --kernel_backend torch is
    the plain version on any device; the backend is a process setting the
    recipe leaves as it was asked."""
    flags = ["--utts", "10", "--epochs", "3", "--device", "cpu"]
    try:
        _, ev = _run(port_recipe.main,
                     flags + ["--kernel_backend", "torch", "--out_dir",
                              str(tmp_path / "a")])
        assert kernels.use_kernel(torch.zeros(1)) is False
    finally:
        kernels.set_backend("auto")
    _, ev2 = _run(port_recipe.main, flags + ["--out_dir", str(tmp_path / "b")])
    assert ev["eval_utts"] == 10 and ev["errors"] == ev2["errors"]


def test_device_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the guard is for hosts "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_recipe.main(["--utts", "2", "--epochs", "1", "--out_dir",
                          str(tmp_path)])
