"""Recipe 4 (BASELINE config 4): segmental CRF (SCRF).

Twin of ``recipes/scrf.py``: variable-duration segment lattice scoring
(pooled frame features, duration and label biases, segment-level
transitions), trained full-batch with Adam on the segmental log-likelihood
with the gold segmentation as numerator, decoded with the segmental
Viterbi.  The same seeded synthetic corpus, flags, ``metrics.jsonl`` lines
and ``scrf_weights.npz`` as the JAX recipe, so the two runs compare line by
line and each decodes the other's weights (``--decode_only``).

Run:  python -m asr_craft_tpu_torch.recipes.scrf [--utts 100] [--epochs 30]
          [--device cpu]

``--device`` defaults to ``cuda`` and raises if no GPU is present;
``--kernel_backend`` picks the CUDA kernels or the plain PyTorch version
(``auto``: kernels for CUDA tensors).
"""
import argparse
import os
import sys

import numpy as np
import torch

from asr_craft_tpu_torch import data, kernels
from asr_craft_tpu_torch.decode.scorer import ErrorRateScorer, score_batch
from asr_craft_tpu_torch.models import weights as weights_mod
from asr_craft_tpu_torch.models.segmental import (SegCrfConfig,
                                                  scrf_frame_labels,
                                                  scrf_loss, scrf_loss_fused)
from asr_craft_tpu_torch.utils.logging import MetricsLogger


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--utts", type=int, default=100)
    p.add_argument("--eval_utts", type=int, default=0,
                   help="held-out utterances for PER (decode_only and the "
                        "final eval); 0 = score the training corpus")
    p.add_argument("--labels", type=int, default=12)
    p.add_argument("--max_dur", type=int, default=16)
    p.add_argument("--seg_states", type=int, default=1,
                   help="sub-states per segment (n-state segmental)")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--noise", type=float, default=0.3)
    p.add_argument("--out_dir", default="./runs/scrf")
    p.add_argument("--dense_loss", action="store_true",
                   help="train with the materialized (B,T,Dmax,L) oracle "
                        "loss instead of the streaming fused loss")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--decode_only", default=None,
                   help="skip training: load this scrf_weights.npz (of "
                        "either package), decode the (seeded, "
                        "deterministic) corpus, report PER")
    p.add_argument("--kernel_backend", choices=list(kernels.BACKENDS),
                   default="auto")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu to run on CPU)")
    kernels.set_backend(args.kernel_backend)

    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out_dir, "metrics.jsonl"))

    L = args.labels
    scfg = data.SyntheticConfig(num_labels=L, feat_dim=L, noise=args.noise,
                                min_len=20, max_len=64, mean_dur=4.0,
                                min_dur=2, seed=0)
    n_total = args.utts + args.eval_utts
    feats_l, labels_l, phones = data.generate_corpus(scfg, n_total)
    T = 64
    B = len(feats_l)
    feats = np.zeros((B, T, L), np.float32)
    labels = np.zeros((B, T), np.int32)
    lengths = np.zeros((B,), np.int32)
    for i, (f, l) in enumerate(zip(feats_l, labels_l)):
        n = min(len(f), T)
        feats[i, :n], labels[i, :n], lengths[i] = f[:n], l[:n], n

    cfg = SegCrfConfig(num_labels=L, feat_dim=L, max_dur=args.max_dur,
                       num_states=args.seg_states)
    params = cfg.init_params(device=device)
    feats, labels, lengths = (torch.from_numpy(a).to(device)
                              for a in (feats, labels, lengths))
    # held-out eval slice (the same seeded corpus on every invocation, so
    # same-weights decodes under two backends or packages see one set)
    if args.eval_utts:
        ev = slice(args.utts, n_total)
    else:
        ev = slice(0, args.utts)
    feats_ev, labels_ev, lengths_ev = feats[ev], labels[ev], lengths[ev]
    phones_ev = phones[ev]
    feats, labels, lengths = (feats[:args.utts], labels[:args.utts],
                              lengths[:args.utts])

    def evaluate(params):
        frames, _ = scrf_frame_labels(cfg, params, feats_ev, lengths_ev)
        scorer = ErrorRateScorer()
        score_batch(scorer, phones_ev, frames.cpu().numpy(),
                    lengths_ev.cpu().numpy())
        logger.log("eval", per=scorer.error_rate,
                   eval_utts=int(lengths_ev.shape[0]), **scorer.summary())

    if args.decode_only:
        evaluate(weights_mod.load_npz(args.decode_only, device))
        return 0

    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the root
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(params.values(), lr=args.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    loss_fn = scrf_loss if args.dense_loss else scrf_loss_fused

    for epoch in range(args.epochs):
        opt.zero_grad(set_to_none=True)
        loss, _ = loss_fn(cfg, params, feats, labels, lengths)
        loss.backward()
        opt.step()
        if epoch % 25 == 0 or epoch == args.epochs - 1:
            logger.log("train_epoch", epoch=epoch, loss=loss.item())

    params = {k: v.detach() for k, v in params.items()}
    evaluate(params)
    weights_mod.save_npz(os.path.join(args.out_dir, "scrf_weights.npz"),
                         params)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
