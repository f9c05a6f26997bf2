"""``crf-decode`` twin: phone and word decode of a trained CRF on a GPU (or
the CPU).

Counterpart of :mod:`asr_craft_tpu.cli.decode`: flags -> corpus -> model
(weight file) -> batched Viterbi (exact / beam) -> MLF -> PER, or with
``--lexicon`` the FST word decode: potentials on the device, then lattice
o collapser o lexicon [o LM] on the host -> words -> WER.  Corpus assembly,
the loader, MLF writing, scoring, logging and the FST / on-the-fly word
decoders are the port's host modules (``data``, ``decode``, ``cli.common``,
``utils.logging``: numpy, no torch).

    python -m asr_craft_tpu_torch.cli.decode --synthetic_utts 8 \\
        --crf_label_size 4 --crf_states 3 --window_extent 1 \\
        --crf_transftr_end 12 --weight_file w.dat --device cpu

``--device`` defaults to ``cuda`` and raises if no GPU is present;
``--kernel_backend`` picks the CUDA kernels or the plain PyTorch version
(``auto``: kernels for CUDA tensors).  ``--time_shard N
[--shard_beam_labels K]`` decodes shared-transition models through
:func:`asr_craft_tpu_torch.parallel.timeshard.sharded_decode`: the time
axis in N chunks on the one device (layout (i)).  As in the JAX CLI, the
word decode (``--lexicon``) does not shard and ignores ``--time_shard``,
and ``--shard_beam_labels`` without ``--time_shard`` is ignored.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.cli.common import build_corpus, make_transform
from asr_craft_tpu_torch.data import LoaderConfig, UtteranceLoader, write_mlf
from asr_craft_tpu_torch.decode.scorer import (ErrorRateScorer,
                                               collapse_frames, score_batch,
                                               timit_fold_indices)
from asr_craft_tpu_torch.models import weights as weights_mod
from asr_craft_tpu_torch.models.crf import (CrfConfig, apply_boundaries,
                                            decode, potentials)
from asr_craft_tpu_torch.parallel.timeshard import sharded_decode
from asr_craft_tpu_torch.train.trainer import to_device
from asr_craft_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Decode with a trained CRF "
                                "(PyTorch / CUDA)")
    p.add_argument("--ftr1_file")
    p.add_argument("--ftr2_file")
    p.add_argument("--ftr3_file")
    p.add_argument("--hardtarget_file")
    p.add_argument("--htk_scp", help="list of HTK feature files "
                   "(one per line, optionally key=path)")
    p.add_argument("--label_mlf", help="MLF with frame-time labels "
                   "for --htk_scp utterances")
    p.add_argument("--window_extent", type=int, default=0)
    p.add_argument("--deltas_order", type=int, default=0)
    p.add_argument("--normalize", choices=["none", "global", "utt"],
                   default="none")
    p.add_argument("--synthetic_utts", type=int, default=0)
    p.add_argument("--synthetic_noise", type=float, default=0.4)
    p.add_argument("--crf_label_size", type=int, required=True)
    p.add_argument("--crf_states", type=int, default=1)
    p.add_argument("--crf_featuremap", choices=["dense", "sparse"],
                   default="dense")
    p.add_argument("--sparse_topk", type=int, default=0,
                   help="with --crf_featuremap sparse on a dense source: "
                        "keep the K largest-magnitude dims per frame "
                        "(0 = all dims, i.e. exact)")
    p.add_argument("--crf_stateftr_start", type=int, default=None)
    p.add_argument("--crf_stateftr_end", type=int, default=None)
    p.add_argument("--crf_transftr_start", type=int, default=0)
    p.add_argument("--crf_transftr_end", type=int, default=0)
    p.add_argument("--weight_file", required=True)
    p.add_argument("--beam_width", type=int, default=None,
                   help="top-k pruning (None = exact)")
    p.add_argument("--beam_threshold", type=float, default=None,
                   help="score-margin pruning")
    p.add_argument("--time_shard", type=int, default=0,
                   help="cut the time axis of the Viterbi lattice into N "
                        "chunks (associative max-plus products, boundary "
                        "state exchanged between chunks); 0/1 = off")
    p.add_argument("--shard_beam_labels", type=int, default=None,
                   help="with --time_shard: per-chunk top-K label "
                        "survivor pruning (None = exact)")
    # --- FST word decode (the reference CRFFstDecode mode) ---
    p.add_argument("--lexicon", help="pronunciation lexicon: one "
                   "'word ph1 ph2 ...' per line (phone names resolved via "
                   "--phone_names, else integer ids); enables word decode")
    p.add_argument("--lm", help="word LM as an FST text file "
                   "(1-based word ids in lexicon order)")
    p.add_argument("--lm_weight", type=float, default=1.0)
    p.add_argument("--prune_margin", type=float, default=None,
                   help="lattice beam: drop arcs more than this margin "
                   "below the frame-best path score")
    p.add_argument("--nbest", type=int, default=1,
                   help="emit the n best word sequences (--out_nbest)")
    p.add_argument("--out_words", help="write 'key w1 w2 ...' hypotheses")
    p.add_argument("--out_nbest", help="write 'key score w1 w2 ...' n-best")
    p.add_argument("--ref_words", help="reference transcripts "
                   "('key w1 w2 ...' lines) for WER scoring")
    p.add_argument("--out_lattice_dir",
                   help="write per-utterance lattices as FST text files")
    p.add_argument("--otf", action="store_true",
                   help="on-the-fly FST-composed beam Viterbi (no lattice); "
                   "prune with --beam_threshold / --max_active")
    p.add_argument("--otf_dynamic", action="store_true",
                   help="fully dynamic lexicon/LM composition (no search "
                   "graph built)")
    p.add_argument("--no_lm_lookahead", action="store_true",
                   help="disable the LM lookahead pruning potentials in "
                   "--otf_dynamic")
    p.add_argument("--max_active", type=int, default=None,
                   help="max live (label, grammar-state) tokens per frame "
                   "in --otf decoding")
    p.add_argument("--fst_backend", choices=["auto", "py", "native"],
                   default="auto")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--bucket_sizes", default="128,256,512,1024,2048")
    p.add_argument("--timit_fold", action="store_true",
                   help="score with the 48->39 TIMIT folding")
    p.add_argument("--phone_names", help="file with one phone name per line")
    p.add_argument("--out_mlf", help="write hypotheses as an MLF")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", choices=["highest", "bf16x3", "default"],
                   default="highest")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--kernel_backend", choices=list(kernels.BACKENDS),
                   default="auto",
                   help="DP implementation: the CUDA kernels or the plain "
                        "PyTorch version (auto: kernels on CUDA tensors)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # as the JAX CLI: the word decode (--lexicon) returns before the time
    # shard is read, and --shard_beam_labels is read only when sharded
    sharded = bool(args.time_shard and args.time_shard > 1)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu to decode on CPU)")
    kernels.set_backend(args.kernel_backend)
    logger = MetricsLogger()

    feats, labels, phone_seqs = build_corpus(args)
    transform, feat_dim = make_transform(args, feats)
    sparse_input = feats and isinstance(feats[0], tuple)
    if sparse_input and args.crf_featuremap != "sparse":
        raise SystemExit("sparse feature input requires "
                         "--crf_featuremap sparse")
    sparse_k = None
    if args.crf_featuremap == "sparse" and not sparse_input:
        sparse_k = args.sparse_topk or feat_dim
    buckets = tuple(int(x) for x in args.bucket_sizes.split(","))
    loader = UtteranceLoader(
        feats, labels,
        LoaderConfig(batch_size=args.batch_size, buckets=buckets,
                     shuffle=False, sparse_k=sparse_k),
        transform=transform, feat_dim=feat_dim)

    state_rng = ((args.crf_stateftr_start, args.crf_stateftr_end)
                 if args.crf_stateftr_start is not None else None)
    cfg = CrfConfig(
        num_labels=args.crf_label_size, feat_dim=feat_dim,
        num_states=args.crf_states, featuremap=args.crf_featuremap,
        state_range=state_rng,
        trans_range=(args.crf_transftr_start, args.crf_transftr_end),
        precision=args.precision)
    params = weights_mod.load_raw(args.weight_file, cfg.fmap, device)

    names = None
    if args.phone_names:
        with open(args.phone_names) as f:
            names = [ln.strip() for ln in f if ln.strip()]

    if args.lexicon:
        return _word_decode(args, cfg, params, loader, names, logger, device)

    if sharded and (args.beam_width or args.beam_threshold):
        raise SystemExit("--time_shard prunes via --shard_beam_labels; "
                         "--beam_width/--beam_threshold do not apply")

    fold = timit_fold_indices() if args.timit_fold else None
    scorer = ErrorRateScorer()
    hyp_mlf = {}
    have_refs = labels is not None or phone_seqs is not None
    for batch in loader.epoch_batches(0):
        tb = to_device(batch, device)
        sparse = (None if "sparse_idx" not in tb else
                  (tb["sparse_idx"], tb["sparse_val"]))
        if sharded:
            phones, _, _ = sharded_decode(
                cfg, params, tb.get("feats"), tb["lengths"], args.time_shard,
                beam_labels=args.shard_beam_labels, sparse=sparse,
                device=device)
        else:
            phones, _, _ = decode(
                cfg, params, tb.get("feats"), tb["lengths"], sparse=sparse,
                beam_width=args.beam_width,
                beam_threshold=args.beam_threshold)
        phones = phones.cpu().numpy()
        if have_refs:
            refs = []
            for uid in batch["uids"]:
                if uid < 0:
                    refs.append(None)
                elif phone_seqs is not None:
                    refs.append(phone_seqs[int(uid)])
                else:
                    refs.append(collapse_frames(
                        labels[int(uid)], len(labels[int(uid)])))
            score_batch(scorer, refs, phones, batch["lengths"], fold=fold)
        for r, uid in enumerate(batch["uids"]):
            if uid < 0:
                continue
            hyp_mlf[f"utt{int(uid):06d}"] = _segments(
                phones[r], int(batch["lengths"][r]), names)

    if args.out_mlf:
        os.makedirs(os.path.dirname(args.out_mlf) or ".", exist_ok=True)
        write_mlf(args.out_mlf, hyp_mlf)
    if have_refs:
        logger.log("decode_done", per=scorer.error_rate, **scorer.summary())
    else:
        logger.log("decode_done", utts=len(hyp_mlf))
    return 0


def _word_decode(args, cfg, params, loader, names, logger, device) -> int:
    """FST word decode: potentials and boundaries on the device, copied to
    numpy, then the host decoders (:mod:`asr_craft_tpu_torch.decode.fst`,
    :mod:`asr_craft_tpu_torch.decode.otf`) as the JAX CLI calls its own.
    Serves shared-transition models ((L', L') trans) and fdt models ((B, T,
    L', L') trans) alike."""
    from asr_craft_tpu_torch.decode import fst as F
    from asr_craft_tpu_torch.decode import otf

    # the host decoders assume it (decode/otf.py expand_arcs)
    assert cfg.topology.num_expanded % cfg.num_states == 0
    phone_index = {n: i for i, n in enumerate(names)} if names else None
    lexicon, words = F.read_lexicon(args.lexicon, phone_index)
    lm = F.read_fst_text(args.lm) if args.lm else None

    otf_graph = lex_fst = None
    if (args.otf or args.otf_dynamic) and args.nbest > 1:
        raise SystemExit("--otf does not support --nbest; use the offline "
                         "lattice path for n-best")
    if args.otf_dynamic:
        lex_fst = F.lexicon_fst(lexicon, words)
    lookahead_arg = not args.no_lm_lookahead
    if (args.otf_dynamic and lm is not None and lookahead_arg
            and args.fst_backend == "py"):
        # python backend: one lookahead object for the whole corpus, so
        # per-history tables are paid once, not once per utterance
        lookahead_arg = otf.make_exact_lookahead(lex_fst, lm, args.lm_weight)
    elif args.otf:
        otf_graph = otf.build_search_graph(lexicon, words, lm=lm,
                                           lm_weight=args.lm_weight,
                                           backend=args.fst_backend)

    refs = None
    if args.ref_words:
        refs = {}
        with open(args.ref_words) as f:
            for line in f:
                parts = line.split()
                if parts:
                    refs[parts[0]] = parts[1:]

    scorer = ErrorRateScorer()
    hyps, nbest_out = {}, {}
    for batch in loader.epoch_batches(0):
        tb = to_device(batch, device)
        sparse = (None if "sparse_idx" not in tb else
                  (tb["sparse_idx"], tb["sparse_val"]))
        with torch.no_grad():
            state, trans = potentials(cfg, params, tb.get("feats"), sparse)
            state = apply_boundaries(cfg, state, tb["lengths"])
        state, trans = state.cpu().numpy(), trans.cpu().numpy()
        for r, uid in enumerate(batch["uids"]):
            if uid < 0:
                continue
            n = int(batch["lengths"][r])
            tr = trans if trans.ndim == 2 else trans[r, :n]
            key = f"utt{int(uid):06d}"
            if args.out_lattice_dir:
                os.makedirs(args.out_lattice_dir, exist_ok=True)
                lat = F.lattice_fst(state[r], tr, n, args.prune_margin,
                                    num_states=cfg.num_states)
                F.write_fst_text(
                    lat, os.path.join(args.out_lattice_dir, f"{key}.fst.txt"))
            try:
                if lex_fst is not None:
                    wseq, _, _ = otf.otf_decode_words_dynamic(
                        state[r], tr, n, lex_fst, words, lm=lm,
                        lm_weight=args.lm_weight, num_states=cfg.num_states,
                        beam_threshold=args.beam_threshold,
                        max_active=args.max_active, backend=args.fst_backend,
                        lookahead=lookahead_arg)
                elif otf_graph is not None:
                    wseq, _, _ = otf.otf_decode_words(
                        state[r], tr, n, otf_graph, words,
                        num_states=cfg.num_states,
                        beam_threshold=args.beam_threshold,
                        max_active=args.max_active, backend=args.fst_backend)
                else:
                    kw = dict(lm=lm, lm_weight=args.lm_weight,
                              prune_margin=args.prune_margin,
                              num_states=cfg.num_states,
                              backend=args.fst_backend)
                    if args.nbest > 1:
                        nb = F.decode_words_nbest(state[r], tr, n, lexicon,
                                                  words, args.nbest, **kw)
                        nbest_out[key] = [(w, wseq) for wseq, _, w in nb]
                        wseq = nb[0][0] if nb else []
                    else:
                        wseq, _, _ = F.decode_words(state[r], tr, n, lexicon,
                                                    words, **kw)
            except ValueError:
                # no accepting path (over-pruned lattice, or the lexicon
                # cannot cover the utterance): an empty hypothesis, as in
                # the reference
                logger.log("decode_fail", utt=key)
                wseq = []
            hyps[key] = wseq
            if refs is not None and key in refs:
                scorer.add(refs[key], wseq)

    if args.out_words:
        os.makedirs(os.path.dirname(args.out_words) or ".", exist_ok=True)
        with open(args.out_words, "w") as f:
            for key in sorted(hyps):
                f.write(f"{key} {' '.join(hyps[key])}\n")
    if args.out_nbest:
        os.makedirs(os.path.dirname(args.out_nbest) or ".", exist_ok=True)
        with open(args.out_nbest, "w") as f:
            for key in sorted(nbest_out):
                for w, wseq in nbest_out[key]:
                    f.write(f"{key} {w:.4f} {' '.join(wseq)}\n")
    if refs is not None:
        logger.log("decode_done", wer=scorer.error_rate, **scorer.summary())
    else:
        logger.log("decode_done", utts=len(hyps))
    return 0


def _segments(phones: np.ndarray, n: int, names):
    """Per-frame phones -> [(start, end, label)] runs with frame times."""
    segs, t0 = [], 0
    for t in range(1, n + 1):
        if t == n or phones[t] != phones[t0]:
            lab = int(phones[t0])
            segs.append((t0, t, names[lab] if names else str(lab)))
            t0 = t
    return segs


if __name__ == "__main__":
    raise SystemExit(main())
