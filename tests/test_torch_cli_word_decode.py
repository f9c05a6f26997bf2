"""The port's ``--lexicon`` word decode against the JAX CLI's, in process on
the CPU, on the word fixture of tests/e2e/test_word_decode.py
(``flagship.word_corpus``) and one weight file: the hand-set posterior
model at window 0.  Both CLIs run the same host decoders on the same
potentials (the port's from PyTorch), so the words and the WER must be
equal: offline lattice, with and without an LM, n-best, ``--otf`` and
``--otf_dynamic``, for monophone, n-state and frame-dependent-transition
models."""
import contextlib
import io
import json

import numpy as np
import pytest

from asr_craft_tpu.cli import decode as jax_cli
from asr_craft_tpu.decode import fst as F
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.cli import decode as port_cli
from asr_craft_tpu_torch.flagship import posterior_model, word_corpus
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.models.weights import params_from_numpy, save_raw

NUM_WORDS = 6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("words")
    P = word_corpus(d)
    W = NUM_WORDS
    lm = F.bigram_lm_fst(W, np.log(np.full((W, W), 1.0 / W)),
                         np.log(np.full(W, 1.0 / W)),
                         np.log(np.full(W, 0.5)))
    F.write_fst_text(lm, d / "lm.fst.txt")
    for name, kw in (("mono", {}), ("nstate", {"num_states": 2}),
                     ("fdt", {"trans_range": (0, P)})):
        cfg = CrfConfig(num_labels=P, feat_dim=P, **kw)
        save_raw(d / f"{name}.dat", cfg.fmap, params_from_numpy(
            posterior_model(cfg, window_extent=0, seed=2, trans_scale=0.1)))
    return d, P


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    lines = buf.getvalue().splitlines()
    done = [json.loads(ln) for ln in lines if '"decode_done"' in ln]
    fails = [ln for ln in lines if '"decode_fail"' in ln]
    assert len(done) == 1
    done[0].pop("t")                                  # the logger's clock
    return done[0], len(fails)


def _both(tmp_path, corpus, model, extra):
    d, P = corpus
    common = ["--ftr1_file", str(d / "test.pf"), "--crf_label_size", str(P),
              "--weight_file", str(d / f"{model}.dat"), "--batch_size", "8",
              "--bucket_sizes", "256", "--lexicon", str(d / "lex.txt"),
              "--ref_words", str(d / "refs.txt")] + extra
    if model == "nstate":
        common += ["--crf_states", "2"]
    if model == "fdt":
        common += ["--crf_transftr_end", str(P)]
    try:
        port = _run(port_cli.main, common + [
            "--device", "cpu", "--out_words", str(tmp_path / "port.txt")])
    finally:
        kernels.set_backend("auto")
    ref = _run(jax_cli.main, common + [
        "--platform", "cpu", "--out_words", str(tmp_path / "jax.txt")])
    return port, ref


MODES = {
    "offline": [],
    "offline-lm": ["--lm", "{d}/lm.fst.txt", "--lm_weight", "0.5"],
    "otf": ["--otf", "--beam_threshold", "30", "--max_active", "64"],
    "otf-lm": ["--otf", "--lm", "{d}/lm.fst.txt"],
    "otf_dynamic": ["--otf_dynamic", "--fst_backend", "py"],
    "otf_dynamic-lm": ["--otf_dynamic", "--fst_backend", "py",
                       "--lm", "{d}/lm.fst.txt", "--beam_threshold", "12",
                       "--max_active", "64"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_word_decode_matches_jax_cli(tmp_path, corpus, mode):
    extra = [a.format(d=corpus[0]) for a in MODES[mode]]
    (port, pf), (ref, rf) = _both(tmp_path, corpus, "mono", extra)
    assert port == ref and pf == rf
    assert port["tokens"] > 0 and port["wer"] < 0.1
    assert ((tmp_path / "port.txt").read_bytes()
            == (tmp_path / "jax.txt").read_bytes())


@pytest.mark.parametrize("model", ["nstate", "fdt"])
def test_word_decode_other_models_match_jax_cli(tmp_path, corpus, model):
    """n-state shared transitions, and a frame-dependent-transition model
    (its potentials are the (B, T, L', L') tensor)."""
    (port, pf), (ref, rf) = _both(tmp_path, corpus, model, [])
    assert port == ref and pf == rf
    assert ((tmp_path / "port.txt").read_bytes()
            == (tmp_path / "jax.txt").read_bytes())


def test_word_decode_nbest_and_lattices_match_jax_cli(tmp_path, corpus):
    d = corpus[0]
    outs = {}
    for who, main, flag in (("port", port_cli.main, ["--device", "cpu"]),
                            ("jax", jax_cli.main, ["--platform", "cpu"])):
        argv = ["--ftr1_file", str(d / "test.pf"), "--crf_label_size",
                str(corpus[1]), "--weight_file", str(d / "mono.dat"),
                "--bucket_sizes", "256", "--lexicon", str(d / "lex.txt"),
                "--ref_words", str(d / "refs.txt"), "--nbest", "3",
                "--prune_margin", "15",
                "--out_nbest", str(tmp_path / f"{who}.nbest"),
                "--out_lattice_dir", str(tmp_path / f"{who}_lat")] + flag
        try:
            outs[who] = _run(main, argv)
        finally:
            kernels.set_backend("auto")
    assert outs["port"] == outs["jax"]
    port_nb = (tmp_path / "port.nbest").read_text().split("\n")
    jax_nb = (tmp_path / "jax.nbest").read_text().split("\n")
    assert [ln.split()[:1] + ln.split()[2:] for ln in port_nb] == \
        [ln.split()[:1] + ln.split()[2:] for ln in jax_nb]
    np.testing.assert_allclose(
        [float(ln.split()[1]) for ln in port_nb if ln],
        [float(ln.split()[1]) for ln in jax_nb if ln], rtol=1e-5, atol=1e-3)
    lats = sorted(p.name for p in (tmp_path / "port_lat").iterdir())
    assert lats == sorted(p.name for p in (tmp_path / "jax_lat").iterdir())
    assert len(lats) == 10


def test_time_shard_still_raises(tmp_path, corpus):
    """The two command lines the port refused until it followed the JAX
    CLI: ``--lexicon`` with ``--time_shard 2`` runs the word decode (which
    does not shard: the JAX CLI returns to it before the time shard is
    read), and ``--shard_beam_labels`` without ``--time_shard`` is ignored
    by the phone decode.  Each gives the JAX CLI's result: the same
    decode_done record and byte-identical words and MLF files."""
    d, P = corpus
    argv = ["--ftr1_file", str(d / "test.pf"), "--crf_label_size", str(P),
            "--weight_file", str(d / "mono.dat"), "--bucket_sizes", "256"]
    for tag, extra in (
            ("words", ["--lexicon", str(d / "lex.txt"), "--ref_words",
                       str(d / "refs.txt"), "--time_shard", "2"]),
            ("phones", ["--shard_beam_labels", "4"])):
        out = {}
        for who, main, flag in (("port", port_cli.main, ["--device", "cpu"]),
                                ("jax", jax_cli.main,
                                 ["--platform", "cpu"])):
            path = tmp_path / f"{who}_{tag}"
            dest = (["--out_words", str(path)] if tag == "words"
                    else ["--out_mlf", str(path)])
            try:
                out[who] = _run(main, argv + extra + flag + dest)
            finally:
                kernels.set_backend("auto")
        assert out["port"] == out["jax"], tag
        assert ((tmp_path / f"port_{tag}").read_bytes()
                == (tmp_path / f"jax_{tag}").read_bytes()), tag
