"""The port's train CLI (``--device cpu``) on the shared-transition recipes
(BASELINE configs 1, 3 and 5: ``recipes/timit_mono.py``,
``recipes/wsj_crandem.py``, ``recipes/swbd_multihost.py``) against the JAX
package's CLI (``--platform cpu``), in process, with each recipe's own
train flags on a tiny synthetic corpus: the same per-epoch mean loss
(rtol=1e-3; the two differ only in the order of fp32 sums), the same CV
PER, and final weights that both decode CLIs read to the same error
counts.
"""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from asr_craft_tpu.cli import decode as jax_decode
from asr_craft_tpu.cli import train as jax_cli
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.cli import decode as port_decode
from asr_craft_tpu_torch.cli import train as port_cli
from asr_craft_tpu_torch.utils import diagnostics

RECIPES = Path(__file__).resolve().parent.parent / "recipes"
# the recipe's corpus and schedule cut to a test's size; its model,
# feature, optimizer and batching flags stay
TINY = ["--synthetic_utts", "16", "--crf_epochs", "2", "--log_every", "1000"]


def _recipe(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  RECIPES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
    finally:
        kernels.set_backend("auto")
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def _kind(recs, kind):
    return [r for r in recs if r["kind"] == kind]


def _flag(args, name):
    return args[args.index(name) + 1]


@pytest.mark.parametrize("recipe", ["timit_mono", "wsj_crandem",
                                    "swbd_multihost"])
def test_shared_recipe_trains_as_the_jax_cli(recipe, tmp_path):
    flags = list(_recipe(recipe).TRAIN_ARGS) + TINY
    assert "--crf_transftr_end" not in flags          # shared transitions
    before = diagnostics.launches()
    port = _run(port_cli.main, flags + ["--device", "cpu", "--out_dir",
                                        str(tmp_path / "port")])
    ref = _run(jax_cli.main, flags + ["--platform", "cpu", "--out_dir",
                                      str(tmp_path / "jax")])
    assert diagnostics.launches() == before           # CPU: plain only
    pe, je = _kind(port, "train_epoch"), _kind(ref, "train_epoch")
    assert len(pe) == len(je) == 2
    for a, b in zip(pe, je):
        np.testing.assert_allclose(a["mean_loss"], b["mean_loss"],
                                   rtol=1e-3)
        assert a["frames"] == b["frames"]
    assert pe[1]["mean_loss"] < pe[0]["mean_loss"]
    pv, jv = _kind(port, "eval"), _kind(ref, "eval")
    assert [r["per"] for r in pv] == [r["per"] for r in jv]
    np.testing.assert_allclose([r["cv_loss"] for r in pv],
                               [r["cv_loss"] for r in jv], rtol=1e-3)

    # the port's final weights: both decode CLIs read them and count alike
    model = ["--crf_label_size", _flag(flags, "--crf_label_size"),
             "--crf_states", _flag(flags, "--crf_states"),
             "--window_extent", _flag(flags, "--window_extent"),
             "--synthetic_utts", "6",
             "--weight_file", str(tmp_path / "port" / "weights.final.dat")]
    if "--normalize" in flags:
        model += ["--normalize", _flag(flags, "--normalize")]
    pd = _kind(_run(port_decode.main, model + ["--device", "cpu"]),
               "decode_done")[0]
    jd = _kind(_run(jax_decode.main, model + ["--platform", "cpu"]),
               "decode_done")[0]
    assert (pd["errors"], pd["tokens"]) == (jd["errors"], jd["tokens"])
    assert pd["tokens"] > 0
