"""``crf-decode`` twin: phone decode of a trained CRF on a GPU (or the CPU).

Counterpart of :mod:`asr_craft_tpu.cli.decode` for the phone-decode path:
flags -> corpus -> model (weight file) -> batched Viterbi (exact / beam) ->
MLF -> PER.  Corpus assembly, the loader, MLF writing, scoring and logging
are the JAX package's framework-neutral host modules, used as they are.

    python -m asr_craft_tpu_torch.cli.decode --synthetic_utts 8 \\
        --crf_label_size 4 --crf_states 3 --window_extent 1 \\
        --crf_transftr_end 12 --weight_file w.dat --device cpu

``--device`` defaults to ``cuda`` and raises if no GPU is present;
``--kernel_backend`` picks the CUDA kernels or the plain PyTorch version
(``auto``: kernels for CUDA tensors).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from asr_craft_tpu.cli.common import build_corpus, make_transform
from asr_craft_tpu.data import LoaderConfig, UtteranceLoader, write_mlf
from asr_craft_tpu.decode.scorer import (ErrorRateScorer, collapse_frames,
                                         score_batch, timit_fold_indices)
from asr_craft_tpu.utils.logging import MetricsLogger
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.models import weights as weights_mod
from asr_craft_tpu_torch.models.crf import CrfConfig, decode
from asr_craft_tpu_torch.train.trainer import to_device


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
                   help="time-sharded decode (not ported yet)")
    p.add_argument("--lexicon", help="word decode (not ported yet)")
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


def _check_supported(args) -> None:
    if args.lexicon:
        raise NotImplementedError("--lexicon word decode is not ported yet "
                                  "(ROADMAP.md Queue 1, slice 3)")
    if args.time_shard and args.time_shard > 1:
        raise NotImplementedError("--time_shard is not ported yet "
                                  "(ROADMAP.md Queue 1, slice 5)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _check_supported(args)
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

    fold = timit_fold_indices() if args.timit_fold else None
    scorer = ErrorRateScorer()
    hyp_mlf = {}
    have_refs = labels is not None or phone_seqs is not None
    for batch in loader.epoch_batches(0):
        tb = to_device(batch, device)
        sparse = (None if "sparse_idx" not in tb else
                  (tb["sparse_idx"], tb["sparse_val"]))
        phones, _, _ = decode(
            cfg, params, tb.get("feats"), tb["lengths"], sparse=sparse,
            beam_width=args.beam_width, beam_threshold=args.beam_threshold)
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
