"""The port's train CLI (``--device cpu``) against the JAX package's
(``--platform cpu``), in process, on one small synthetic corpus with the
flagship's topology and features (3 states, a +/-1 window, frame-dependent
transitions over all dims): the same per-epoch mean loss (rtol=1e-4), the
same CV PER, and weight files that load in both packages.  Also: --resume
continues a run exactly, the diagnostics flags and ``--optimizer lbfgs``
run.
"""
import contextlib
import io
import json

import numpy as np
import pytest

from asr_craft_tpu.cli import decode as jax_decode
from asr_craft_tpu.cli import train as jax_cli
from asr_craft_tpu.models import weights as jax_weights
from asr_craft_tpu.models.crf import CrfConfig as JaxCrfConfig
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.cli import decode as port_decode
from asr_craft_tpu_torch.cli import train as port_cli
from asr_craft_tpu_torch.models import weights as port_weights
from asr_craft_tpu_torch.models.crf import CrfConfig

P = 4
CORPUS = ["--synthetic_utts", "20", "--crf_label_size", str(P),
          "--crf_states", "3", "--window_extent", "1",
          "--crf_transftr_end", str(3 * P), "--bucket_sizes", "64,128"]
TRAIN = CORPUS + ["--batch_size", "8", "--crf_lr", "0.5", "--log_every",
                  "1000"]


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


def test_cli_matches_jax_cli(tmp_path):
    argv = TRAIN + ["--crf_epochs", "2"]
    port = _run(port_cli.main, argv + ["--device", "cpu",
                                       "--out_dir", str(tmp_path / "port")])
    ref = _run(jax_cli.main, argv + ["--platform", "cpu",
                                     "--out_dir", str(tmp_path / "jax")])
    pe, je = _kind(port, "train_epoch"), _kind(ref, "train_epoch")
    assert len(pe) == len(je) == 2
    for a, b in zip(pe, je):
        np.testing.assert_allclose(a["mean_loss"], b["mean_loss"],
                                   rtol=1e-4)
        assert a["frames"] == b["frames"]
    pv, jv = _kind(port, "eval"), _kind(ref, "eval")
    assert [r["per"] for r in pv] == [r["per"] for r in jv]
    assert 0.0 <= pv[-1]["per"] < 1.0
    on_disk = [json.loads(ln) for ln in
               (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in on_disk] == [r["kind"] for r in port]
    for i in range(2):
        assert (tmp_path / "port" / f"weights.i{i}.dat").exists()
    assert (tmp_path / "port" / "ckpt" / "meta.json").exists()

    # each package's final weights load in the other and decode the same
    cfg = JaxCrfConfig(num_labels=P, feat_dim=3 * P, num_states=3,
                       trans_range=(0, 3 * P))
    for who in ("port", "jax"):
        w = tmp_path / who / "weights.final.dat"
        jp = jax_weights.load_raw(str(w), cfg.fmap)
        tp = port_weights.load_raw(str(w), CrfConfig(
            num_labels=P, feat_dim=3 * P, num_states=3,
            trans_range=(0, 3 * P)).fmap)
        for k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        dec = CORPUS + ["--weight_file", str(w), "--batch_size", "8"]
        a = _run(port_decode.main, dec + ["--device", "cpu"])
        b = _run(jax_decode.main, dec + ["--platform", "cpu"])
        assert _kind(a, "decode_done")[0]["per"] == \
            _kind(b, "decode_done")[0]["per"]
    np.testing.assert_allclose(
        np.fromfile(tmp_path / "port" / "weights.final.dat"),
        np.fromfile(tmp_path / "jax" / "weights.final.dat"),
        rtol=1e-4, atol=1e-5)


def test_cli_resume_continues_exactly(tmp_path):
    whole = _run(port_cli.main, TRAIN + [
        "--crf_epochs", "2", "--device", "cpu",
        "--out_dir", str(tmp_path / "whole")])
    _run(port_cli.main, TRAIN + ["--crf_epochs", "1", "--device", "cpu",
                                 "--out_dir", str(tmp_path / "cut")])
    resumed = _run(port_cli.main, TRAIN + [
        "--crf_epochs", "2", "--device", "cpu", "--resume",
        "--out_dir", str(tmp_path / "cut")])
    assert _kind(resumed, "resume")[0]["epoch"] == 1
    assert (_kind(resumed, "train_epoch")[0]["mean_loss"]
            == _kind(whole, "train_epoch")[1]["mean_loss"])
    assert ((tmp_path / "cut" / "weights.final.dat").read_bytes()
            == (tmp_path / "whole" / "weights.final.dat").read_bytes())


@pytest.mark.parametrize("flag", [["--profile_dir", "prof"],
                                  ["--debug_nans"],
                                  ["--check_sync_every", "2"],
                                  ["--optimizer", "lbfgs"]])
def test_cli_unported_flags_raise(tmp_path, flag):
    """Flags that raised until their module was ported now run.
    ``--optimizer lbfgs`` gives the JAX CLI's per-epoch losses (rtol 1e-4)
    over two epochs; the diagnostics flags give the same epoch loss as a run
    without them, and ``--profile_dir`` leaves a trace."""
    argv = TRAIN + ["--device", "cpu", "--crf_epochs", "1"]
    if flag[0] == "--optimizer":
        argv = TRAIN + ["--crf_epochs", "2"] + flag
        port = _run(port_cli.main, argv + ["--device", "cpu", "--out_dir",
                                           str(tmp_path / "port")])
        ref = _run(jax_cli.main, argv + ["--platform", "cpu", "--out_dir",
                                         str(tmp_path / "jax")])
        pe, je = _kind(port, "train_epoch"), _kind(ref, "train_epoch")
        assert len(pe) == len(je) == 2
        np.testing.assert_allclose([r["mean_loss"] for r in pe],
                                   [r["mean_loss"] for r in je], rtol=1e-4)
        assert (_kind(port, "eval")[-1]["per"]
                == _kind(ref, "eval")[-1]["per"])
        return
    flag = [str(tmp_path / a) if a == "prof" else a for a in flag]
    try:
        got = _run(port_cli.main, argv + ["--out_dir", str(tmp_path / "a")]
                   + flag)
    finally:
        port_cli.diagnostics.enable_debug_nans(False)
    want = _run(port_cli.main, argv + ["--out_dir", str(tmp_path / "b")])
    assert _kind(got, "train_epoch")[0]["mean_loss"] == \
        _kind(want, "train_epoch")[0]["mean_loss"]
    if flag[0] == "--profile_dir":
        assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_cli_more_than_one_device_raises(tmp_path, monkeypatch):
    """A world of 4 ranks with no rendezvous address raises: the CLI never
    trains alone where torchrun's environment asks for a group."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        port_cli.main(TRAIN + ["--device", "cpu", "--out_dir",
                               str(tmp_path)])
