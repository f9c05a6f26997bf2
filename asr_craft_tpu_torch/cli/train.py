"""``crf-train`` twin: train a CRF (frame-dependent or shared transitions) on
a GPU (or the CPU).

Counterpart of :mod:`asr_craft_tpu.cli.train`:
flags -> corpus + transforms -> loaders -> model init (zeros, or a weight
file) -> SGD epochs with per-epoch weight files ``weights.i*.dat``, CV
evaluation (frame accuracy and PER), ``metrics.jsonl``, a full-state
checkpoint ``ckpt/`` after every epoch (``--resume`` continues from it),
and ``weights.final.dat``.  Corpus assembly, the loader and logging are the
port's host modules (``cli.common``, ``data``, ``utils.logging``).

    python -m asr_craft_tpu_torch.cli.train --synthetic_utts 24 \\
        --crf_label_size 4 --crf_states 3 --window_extent 1 \\
        --crf_transftr_end 12 --crf_epochs 3 --out_dir run --device cpu

``--device`` defaults to ``cuda`` and raises if no GPU is present;
``--kernel_backend`` picks the CUDA kernels or the plain PyTorch version
(``auto``: kernels for CUDA tensors).  ``--profile_dir DIR`` writes
``DIR/trace.json``, a ``torch.profiler`` trace of the epochs, and
``DIR/spans.json``, the spans' and counters' summary (the JAX CLI
hands the flag to ``TrainConfig`` but opens its profiler only in
``Trainer.fit``, which the CLI does not call; here the CLI opens the session
around its own epoch loop, as the flag's help says); ``--debug_nans`` and
``--check_sync_every`` are :mod:`asr_craft_tpu_torch.utils.diagnostics`.

On the card the steps and the CV pass are CUDA graphs, one a batch shape
(``train.make_train_step``, ``train.make_eval_step``); ``--debug_nans`` and
``--check_sync_every`` run them eagerly, as does a caller inside
``train.graphs.disabled()``.

Data parallel under torchrun, one process a GPU (NCCL), or with
``--device cpu`` gloo ranks on the CPU:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m asr_craft_tpu_torch.cli.train ... --device cpu

Each rank loads its shard of the train and CV sets
(``parallel.data_shard_info``) and runs the data-parallel step
(``train.trainer``); only rank 0 writes weights, checkpoints and
``metrics.jsonl``; ``--check_sync_every N`` asserts the ranks' parameters
identical every N steps.
"""
from __future__ import annotations

import argparse
import os

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.cli.common import build_corpus, make_transform
from asr_craft_tpu_torch.data import (LoaderConfig, UtteranceLoader,
                                      train_cv_split)
from asr_craft_tpu_torch.decode.scorer import collapse_frames
from asr_craft_tpu_torch.models import weights as weights_mod
from asr_craft_tpu_torch.models.crf import CrfConfig
from asr_craft_tpu_torch.parallel import (data_shard_info,
                                          initialize_distributed, make_mesh)
from asr_craft_tpu_torch.train import (TrainConfig, Trainer, load_checkpoint,
                                       save_checkpoint)
from asr_craft_tpu_torch.utils import diagnostics
from asr_craft_tpu_torch.utils.logging import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a (linear-chain) CRF acoustic model "
                    "(PyTorch / CUDA)")
    # data (QuickNet-style flags)
    p.add_argument("--ftr1_file", help="pfile with features (+labels)")
    p.add_argument("--ftr2_file", help="2nd feature pfile to concatenate")
    p.add_argument("--ftr3_file", help="3rd feature pfile to concatenate")
    p.add_argument("--hardtarget_file", help="label pfile (else ftr1 labels)")
    p.add_argument("--htk_scp", help="list of HTK feature files "
                   "(one per line, optionally key=path)")
    p.add_argument("--label_mlf", help="MLF with frame-time labels "
                   "for --htk_scp utterances")
    p.add_argument("--phone_names", help="one phone name per line "
                   "(maps MLF labels to indices)")
    p.add_argument("--window_extent", type=int, default=0,
                   help="+/- context frames")
    p.add_argument("--deltas_order", type=int, default=0)
    p.add_argument("--normalize", choices=["none", "global", "utt"],
                   default="none")
    p.add_argument("--synthetic_utts", type=int, default=0,
                   help="use a synthetic corpus of N utterances")
    p.add_argument("--synthetic_noise", type=float, default=0.4)
    p.add_argument("--cv_fraction", type=float, default=0.1)
    # model
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
    p.add_argument("--crf_use_state_bias", type=int, default=1)
    p.add_argument("--crf_use_trans_bias", type=int, default=1)
    p.add_argument("--precision", choices=["highest", "bf16x3", "default"],
                   default="highest",
                   help="the products' precision: highest (fp32 "
                        "accuracy, 3xTF32 on the card), bf16x3 (three bf16 "
                        "products of a hi/lo split), default (one TF32 "
                        "pass); the recursions stay fp32")
    p.add_argument("--label_kind", choices=["phone", "state"],
                   default="phone")
    p.add_argument("--init_weight_file", help="warm-start flat weight file")
    # training
    p.add_argument("--crf_lr", type=float, default=0.05)
    p.add_argument("--crf_lr_decay", type=float, default=1.0)
    p.add_argument("--crf_epochs", type=int, default=5)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "adam", "adagrad", "lbfgs"])
    p.add_argument("--l2", type=float, default=0.0)
    p.add_argument("--weight_avg", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation micro-batches per update")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="optimizer steps per call (one CUDA graph replay "
                        "on the card)")
    p.add_argument("--bucket_sizes", default="128,256,512,1024,2048")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", default="./crf_out")
    p.add_argument("--resume", action="store_true",
                   help="resume from out_dir/ckpt")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--kernel_backend", choices=list(kernels.BACKENDS),
                   default="auto",
                   help="DP implementation: the CUDA kernels or the plain "
                        "PyTorch version (auto: kernels on CUDA tensors)")
    # observability / sanitizers
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of training "
                        "(trace.json, Chrome trace format) and the spans' "
                        "and counters' summary (spans.json) here")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first step whose "
                        "loss, gradient or parameters are not finite "
                        "(autograd anomaly detection; a sync a step)")
    p.add_argument("--check_sync_every", type=int, default=0,
                   help="assert the data-parallel ranks' parameters "
                        "identical every N steps (compares nothing on one "
                        "process)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu to train on CPU)")
    kernels.set_backend(args.kernel_backend)
    # always set, so that one process can run with the flag and then without
    diagnostics.enable_debug_nans(args.debug_nans)
    ranked = initialize_distributed(device=device.type)
    try:
        return _train(args, ranked or device, ranked is not None)
    finally:
        if ranked is not None:
            torch.distributed.destroy_process_group()


def _train(args, device, distributed: bool) -> int:
    shard = data_shard_info()
    chief = shard["shard_id"] == 0

    feats, labels, _ = build_corpus(args)
    transform, feat_dim = make_transform(args, feats)
    sparse_input = feats and isinstance(feats[0], tuple)
    if sparse_input and args.crf_featuremap != "sparse":
        raise SystemExit("sparse feature input requires "
                         "--crf_featuremap sparse")
    sparse_k = None
    if args.crf_featuremap == "sparse" and not sparse_input:
        sparse_k = args.sparse_topk or feat_dim
    tr_idx, cv_idx = train_cv_split(len(feats), args.cv_fraction, args.seed)
    buckets = tuple(int(x) for x in args.bucket_sizes.split(","))
    train_loader = UtteranceLoader(
        [feats[i] for i in tr_idx], [labels[i] for i in tr_idx],
        LoaderConfig(batch_size=args.batch_size, buckets=buckets,
                     seed=args.seed, sparse_k=sparse_k, **shard),
        transform=transform, feat_dim=feat_dim)
    cv_loader = UtteranceLoader(
        [feats[i] for i in cv_idx], [labels[i] for i in cv_idx],
        LoaderConfig(batch_size=args.batch_size, buckets=buckets,
                     shuffle=False, sparse_k=sparse_k, **shard),
        transform=transform, feat_dim=feat_dim)

    state_rng = ((args.crf_stateftr_start, args.crf_stateftr_end)
                 if args.crf_stateftr_start is not None else None)
    cfg = CrfConfig(
        num_labels=args.crf_label_size, feat_dim=feat_dim,
        num_states=args.crf_states, featuremap=args.crf_featuremap,
        state_range=state_rng,
        trans_range=(args.crf_transftr_start, args.crf_transftr_end),
        use_state_bias=bool(args.crf_use_state_bias),
        use_trans_bias=bool(args.crf_use_trans_bias),
        precision=args.precision)
    params = None
    if args.init_weight_file:
        params = weights_mod.load_raw(args.init_weight_file, cfg.fmap,
                                      device)

    tc = TrainConfig(
        lr=args.crf_lr, lr_decay=args.crf_lr_decay, epochs=args.crf_epochs,
        momentum=args.momentum, optimizer=args.optimizer, l2=args.l2,
        weight_avg=bool(args.weight_avg), log_every=args.log_every,
        accum_steps=args.accum_steps, steps_per_call=args.steps_per_call,
        out_dir=args.out_dir, profile_dir=args.profile_dir,
        check_sync_every=args.check_sync_every)
    logger = (MetricsLogger(os.path.join(args.out_dir, "metrics.jsonl"))
              if chief else MetricsLogger(quiet=True))
    trainer = Trainer(cfg, tc, params=params, label_kind=args.label_kind,
                      logger=logger, device=device,
                      mesh=make_mesh() if distributed else None)

    ckpt_dir = os.path.join(args.out_dir, "ckpt")
    if args.resume and os.path.exists(os.path.join(ckpt_dir, "meta.json")):
        lstate = load_checkpoint(ckpt_dir, trainer)
        train_loader.restore(lstate)
        logger.log("resume", step=trainer.step, epoch=trainer.epoch)

    # reference phone sequences for CV PER (collapsed frame labels)
    cv_refs = None
    if args.label_kind == "phone":
        cv_refs = {i: collapse_frames(labels[cv_idx[i]],
                                      len(labels[cv_idx[i]]))
                   for i in range(len(cv_idx))}

    with diagnostics.profiler_session(args.profile_dir if chief else None):
        for _ in range(trainer.epoch, tc.epochs):
            trainer.train_epoch(train_loader)
            if len(cv_idx):
                trainer.evaluate(cv_loader, ref_phone_seqs=cv_refs)
            if chief:
                save_checkpoint(ckpt_dir, trainer, train_loader.state())

    if chief:
        weights_mod.save_raw(os.path.join(args.out_dir, "weights.final.dat"),
                             cfg.fmap, trainer.inference_params)
    logger.log("done", step=trainer.step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
