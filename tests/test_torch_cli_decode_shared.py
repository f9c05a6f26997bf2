"""The port's decode CLI on shared-transition models (configs 1, 3 and 5 at
small widths) against the JAX package's, in process on the CPU, on the same
synthetic corpus and weight file (the hand-set posterior model): the same
errors/tokens and byte-identical MLFs."""
import pytest

from asr_craft_tpu.cli import decode as jax_cli
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.cli import decode as port_cli
from asr_craft_tpu_torch.flagship import posterior_model
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.models.weights import params_from_numpy, save_raw
from tests.test_torch_cli_decode import _run

# (P, ns, window, recipe flags): configs 1, 3 and 5 cut to small widths
CONFIGS = {
    "config1": (6, 1, 1, []),
    "config3": (5, 1, 2, ["--normalize", "utt", "--beam_threshold", "8"]),
    "config5": (4, 3, 2, ["--normalize", "global"]),
}


def _corpus(tmp_path, name, trans_scale=0.3):
    P, ns, W, flags = CONFIGS[name]
    cfg = CrfConfig(num_labels=P, feat_dim=P * (2 * W + 1), num_states=ns)
    path = tmp_path / "w.dat"
    save_raw(path, cfg.fmap, params_from_numpy(
        posterior_model(cfg, window_extent=W, seed=1,
                        trans_scale=trans_scale)))
    return ["--synthetic_utts", "8", "--crf_label_size", str(P),
            "--crf_states", str(ns), "--window_extent", str(W),
            "--batch_size", "4", "--bucket_sizes", "64,128,256",
            "--weight_file", str(path)] + flags


@pytest.mark.parametrize("beam", [[], ["--beam_width", "3"]],
                         ids=["recipe", "topk"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_matches_jax_cli(tmp_path, name, beam):
    common = _corpus(tmp_path, name) + beam
    try:
        port = _run(port_cli.main, common + [
            "--device", "cpu", "--out_mlf", str(tmp_path / "port.mlf")])
    finally:
        kernels.set_backend("auto")
    ref = _run(jax_cli.main, common + [
        "--platform", "cpu", "--out_mlf", str(tmp_path / "jax.mlf")])
    assert (port["errors"], port["tokens"]) == (ref["errors"], ref["tokens"])
    assert port["per"] == ref["per"] and port["tokens"] > 0
    assert ((tmp_path / "port.mlf").read_bytes()
            == (tmp_path / "jax.mlf").read_bytes())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_backends_agree_on_cpu(tmp_path, name):
    common = _corpus(tmp_path, name) + ["--device", "cpu"]
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
