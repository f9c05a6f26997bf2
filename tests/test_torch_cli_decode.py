"""The port's decode CLI against the JAX package's, in process on the CPU,
on the same 8-utterance synthetic corpus and weight file: the same PER and
byte-identical MLFs."""
import contextlib
import io
import json

import pytest

from asr_craft_tpu.cli import decode as jax_cli
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.cli import decode as port_cli
from asr_craft_tpu_torch.flagship import posterior_model
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.models.weights import params_from_numpy, save_raw

P, NS, W = 6, 3, 1
D = P * (2 * W + 1)
CORPUS = ["--synthetic_utts", "8", "--crf_label_size", str(P),
          "--crf_states", str(NS), "--window_extent", str(W),
          "--crf_transftr_end", str(D), "--batch_size", "4",
          "--bucket_sizes", "64,128,256"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    done = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if '"decode_done"' in ln]
    assert len(done) == 1
    return done[0]


@pytest.fixture
def weight_file(tmp_path):
    cfg = CrfConfig(num_labels=P, feat_dim=D, num_states=NS,
                    trans_range=(0, D))
    params = posterior_model(cfg, window_extent=W, seed=0, trans_scale=0.3)
    path = tmp_path / "w.dat"
    save_raw(path, cfg.fmap, params_from_numpy(params))
    return path


@pytest.mark.parametrize("beam", [[], ["--beam_width", "5"],
                                  ["--beam_threshold", "4.0"]],
                         ids=["exact", "topk", "threshold"])
def test_cli_matches_jax_cli(tmp_path, weight_file, beam):
    common = CORPUS + ["--weight_file", str(weight_file)] + beam
    try:
        port = _run(port_cli.main, common + [
            "--device", "cpu", "--out_mlf", str(tmp_path / "port.mlf")])
    finally:
        kernels.set_backend("auto")
    ref = _run(jax_cli.main, common + [
        "--platform", "cpu", "--out_mlf", str(tmp_path / "jax.mlf")])
    assert port["per"] == ref["per"]
    assert port["tokens"] == ref["tokens"] > 0
    assert 0.0 < port["per"] < 1.0
    assert ((tmp_path / "port.mlf").read_bytes()
            == (tmp_path / "jax.mlf").read_bytes())


@pytest.mark.parametrize("topk", ["0", "5"], ids=["exact", "top5"])
def test_sparse_cli_matches_jax_cli(tmp_path, weight_file, topk):
    """--crf_featuremap sparse: frames sparsified by the shared loader,
    densified exactly on the fdt path; same PER and MLF as JAX's."""
    common = CORPUS + ["--weight_file", str(weight_file),
                       "--crf_featuremap", "sparse", "--sparse_topk", topk]
    try:
        port = _run(port_cli.main, common + [
            "--device", "cpu", "--out_mlf", str(tmp_path / "port.mlf")])
    finally:
        kernels.set_backend("auto")
    ref = _run(jax_cli.main, common + [
        "--platform", "cpu", "--out_mlf", str(tmp_path / "jax.mlf")])
    assert port["per"] == ref["per"]
    assert ((tmp_path / "port.mlf").read_bytes()
            == (tmp_path / "jax.mlf").read_bytes())


def test_cli_backends_agree_on_cpu(tmp_path, weight_file):
    common = CORPUS + ["--weight_file", str(weight_file), "--device", "cpu"]
    recs = {}
    try:
        for b in ("auto", "torch"):
            recs[b] = _run(port_cli.main, common + [
                "--kernel_backend", b,
                "--out_mlf", str(tmp_path / f"{b}.mlf")])
    finally:
        kernels.set_backend("auto")
    assert recs["auto"]["per"] == recs["torch"]["per"]
    assert ((tmp_path / "auto.mlf").read_bytes()
            == (tmp_path / "torch.mlf").read_bytes())


@pytest.mark.parametrize("flag", [["--lexicon", "lex.txt"],
                                  ["--time_shard", "2"]])
def test_cli_unported_flags_raise(weight_file, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_cli.main(CORPUS + ["--weight_file", str(weight_file),
                                "--device", "cpu"] + flag)


def test_cli_precision_on_kernel_path_raises(weight_file):
    """A non-highest precision is refused where the kernel would run (here
    the 'cuda' backend, checked before the kernel sees the CPU tensor)."""
    try:
        with pytest.raises(NotImplementedError, match="precision"):
            port_cli.main(CORPUS + ["--weight_file", str(weight_file),
                                    "--device", "cpu", "--kernel_backend",
                                    "cuda", "--precision", "bf16x3"])
    finally:
        kernels.set_backend("auto")
