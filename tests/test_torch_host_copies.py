"""The port's own copies of the host modules (``data``, ``decode``,
``cli.common``, ``utils.logging``) against the originals in the JAX package
they were copied from, so that the copies cannot drift unseen: the same
code once the package name is put back (docstrings and comments aside),
and, for a seeded synthetic corpus, loader batches, scorer counts, word
decodes and written files that are equal byte for byte.
"""
import argparse
import ast
import importlib
import json
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
COPIES = ["data/__init__", "data/htk", "data/loader", "data/mlf",
          "data/pfile", "data/pfile_native", "data/sparse", "data/synthetic",
          "data/window", "decode/__init__", "decode/scorer", "decode/fst",
          "decode/fst_native", "decode/otf", "cli/common", "utils/logging"]


def _both(module):
    """(the original, the port's copy) of one host module."""
    return (importlib.import_module(f"asr_craft_tpu.{module}"),
            importlib.import_module(f"asr_craft_tpu_torch.{module}"))


def _code(path, rename):
    """The module's syntax tree without docstrings, as text."""
    src = path.read_text()
    if rename:
        src = src.replace("asr_craft_tpu_torch", "asr_craft_tpu")
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], "value", None), ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", COPIES)
def test_copy_is_the_original_code(name):
    assert _code(REPO / "asr_craft_tpu_torch" / f"{name}.py", True) == \
        _code(REPO / "asr_craft_tpu" / f"{name}.py", False)


def _same_arrays(a, b):
    assert type(a) is type(b)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_arrays(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_arrays(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def _word_corpora(n=12):
    out = []
    for mod in _both("data.synthetic"):
        cfg = mod.WordCorpusConfig(num_words=5, noise=0.2, seed=3)
        out.append(mod.generate_word_corpus(cfg, n))
    return out


def test_synthetic_corpora_are_equal():
    for mod_j, mod_t in [_both("data.synthetic")]:
        cfg_j = mod_j.SyntheticConfig(num_labels=6, feat_dim=6, seed=2)
        cfg_t = mod_t.SyntheticConfig(num_labels=6, feat_dim=6, seed=2)
        _same_arrays(mod_j.generate_corpus(cfg_j, 9),
                     mod_t.generate_corpus(cfg_t, 9))
    ref, got = _word_corpora()
    _same_arrays(ref, got)


@pytest.mark.parametrize("normalize", ["none", "utt", "global"])
@pytest.mark.parametrize("sparse_k", [None, 4])
def test_loader_batches_are_equal(normalize, sparse_k):
    """cli.common's transform pipeline and the loader's shuffled, bucketed,
    padded batches over two epochs."""
    args = argparse.Namespace(deltas_order=1, window_extent=1,
                              normalize=normalize)
    batches = []
    for data, common in zip(_both("data"), _both("cli.common")):
        feats, labels, _ = data.generate_corpus(
            data.SyntheticConfig(num_labels=5, feat_dim=5, seed=4), 14)
        transform, dim = common.make_transform(args, feats)
        loader = data.UtteranceLoader(
            feats, labels, data.LoaderConfig(batch_size=4, buckets=(32, 64,
                                                                    256),
                                             seed=1, sparse_k=sparse_k),
            transform=transform, feat_dim=dim)
        batches.append((dim, len(loader),
                        [list(loader.epoch_batches(e)) for e in (0, 1)],
                        data.train_cv_split(14, 0.2, 5)))
    assert batches[0][0] == 5 * 2 * 3
    _same_arrays(batches[0], batches[1])


def test_build_corpus_and_files_are_equal(tmp_path):
    """cli.common.build_corpus on the synthetic flags and on a pfile; the
    pfile and MLF writers give identical files."""
    outs = []
    for who, (data, common) in enumerate(zip(_both("data"),
                                             _both("cli.common"))):
        ns = argparse.Namespace(
            ftr1_file=None, ftr2_file=None, ftr3_file=None,
            hardtarget_file=None, htk_scp=None, label_mlf=None,
            phone_names=None, synthetic_utts=7, synthetic_noise=0.4,
            crf_label_size=5, seed=3)
        feats, labels, names = common.build_corpus(ns)
        pf = tmp_path / f"c{who}.pf"
        data.write_pfile(pf, data.PFile(feats, labels))
        ns.ftr1_file, ns.synthetic_utts = str(pf), 0
        again = common.build_corpus(ns)
        segs = {f"utt{i}": [(0, 3, "a"), (3, 3 + i, "b")] for i in range(3)}
        data.write_mlf(tmp_path / f"c{who}.mlf", segs)
        outs.append(((feats, labels, names), again[:2], pf.read_bytes(),
                     (tmp_path / f"c{who}.mlf").read_bytes(),
                     data.read_mlf(tmp_path / f"c{who}.mlf")))
    _same_arrays(outs[0][0], outs[1][0])
    _same_arrays(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2] and outs[0][3] == outs[1][3]
    assert outs[0][4] == outs[1][4]


def test_scorer_counts_are_equal():
    rng = np.random.default_rng(6)
    refs = [list(rng.integers(0, 48, size=rng.integers(3, 9)))
            for _ in range(10)]
    frames = rng.integers(0, 48, size=(10, 40)).astype(np.int32)
    frames[:, ::2] = frames[:, 1::2]                 # some repeated frames
    lengths = rng.integers(5, 41, size=10)
    summaries = []
    for mod in _both("decode.scorer"):
        for fold in (None, mod.timit_fold_indices()):
            scorer = mod.ErrorRateScorer()
            mod.score_batch(scorer, refs, frames, lengths, fold=fold)
            summaries.append((scorer.summary(), scorer.error_rate,
                              mod.collapse_frames(frames[0], lengths[0]),
                              mod.edit_distance(refs[0], refs[1])))
    assert summaries[:2] == summaries[2:]
    assert summaries[0][0]["tokens"] > 0 and summaries[0][0]["errors"] > 0


@pytest.mark.parametrize("mode", ["offline", "otf", "otf_dynamic_lm"])
def test_word_decodes_are_equal(mode):
    """The FST word decoders (python backend) on noisy posteriors of the
    word corpus: the same words, state paths and weights."""
    results = []
    for corpus, F, otf in zip(_word_corpora(), _both("decode.fst"),
                              _both("decode.otf")):
        feats, labels, word_seqs, lexicon, words = corpus
        P = feats[0].shape[1]
        trans = (0.1 * np.random.default_rng(7).normal(size=(P, P))
                 ).astype(np.float32)
        lm = F.estimate_backoff_bigram(word_seqs, words)
        if mode == "otf":
            graph = otf.build_search_graph(lexicon, words, backend="py")
        elif mode == "otf_dynamic_lm":
            lex = F.lexicon_fst(lexicon, words)
        out = []
        for x in feats[:5]:
            state = np.log(np.maximum(x, 1e-3)).astype(np.float32)
            n = len(state)
            if mode == "offline":
                r = F.decode_words(state, trans, n, lexicon, words,
                                   prune_margin=20.0, backend="py")
            elif mode == "otf":
                r = otf.otf_decode_words(state, trans, n, graph, words,
                                         beam_threshold=30.0, backend="py")
            else:
                r = otf.otf_decode_words_dynamic(
                    state, trans, n, lex, words, lm=lm, beam_threshold=30.0,
                    max_active=200, backend="py")
            out.append((list(r[0]), [int(s) for s in r[1]], float(r[2])))
        results.append(out)
    assert results[0] == results[1]
    assert any(words for words, _, _ in results[0])


def test_native_bridges_point_at_the_same_sources():
    """Both ctypes bridges of the port build and load the C++ sources of
    ``native/``, as the originals do."""
    for name in ("decode.fst_native", "data.pfile_native"):
        ref, got = _both(name)
        assert Path(got._NATIVE_DIR) == Path(ref._NATIVE_DIR) == \
            REPO / "native"


def test_metrics_logger_lines_are_equal(tmp_path, capsys):
    lines = []
    for who, mod in enumerate(_both("utils.logging")):
        path = tmp_path / f"m{who}.jsonl"
        logger = mod.MetricsLogger(str(path))
        logger.log("train_epoch", epoch=0, mean_loss=1.5)
        logger.log("done", step=3)
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
        for r in recs:
            assert r.pop("t") >= 0
        lines.append(recs)
    assert lines[0] == lines[1] and len(lines[0]) == 2
    capsys.readouterr()
