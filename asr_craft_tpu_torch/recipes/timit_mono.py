"""Recipe 1 (BASELINE config 1): TIMIT monophone linear-chain CRF.

48 labels, MLP phone-posterior features, bias-only transitions, exact
Viterbi decode scored with the standard 48->39 folding (K4, K5 in training;
K7 and the traceback kernel in decode).

Twin of ``recipes/timit_mono.py``: the same ``TRAIN_ARGS`` and
``DECODE_ARGS``, handed to the port's CLIs.  Extra flags are appended to
both lists, so ``--device cpu`` runs the plain PyTorch versions on the CPU;
the default is the GPU and its CUDA kernels.  Without ``--ftr1_file`` the
built-in synthetic posterior corpus stands in for TIMIT.

Run:  python -m asr_craft_tpu_torch.recipes.timit_mono [--ftr1_file
          posteriors.pfile] [extra flags]
"""
import sys

TRAIN_ARGS = [
    "--crf_label_size", "48",
    "--crf_states", "1",
    "--window_extent", "1",
    "--crf_lr", "0.5", "--crf_lr_decay", "0.9",
    "--crf_epochs", "20",
    "--batch_size", "32",
    "--out_dir", "./runs/timit_mono",
    # synthetic stand-in corpus (drop when --ftr1_file is given)
    "--synthetic_utts", "400",
]

DECODE_ARGS = [
    "--crf_label_size", "48",
    "--weight_file", "./runs/timit_mono/weights.final.dat",
    "--window_extent", "1",
    "--timit_fold",
    "--synthetic_utts", "50",
]


def main(extra=()):
    from asr_craft_tpu_torch.cli.decode import main as decode_main
    from asr_craft_tpu_torch.cli.train import main as train_main
    extra = list(extra)
    args = [a for a in TRAIN_ARGS]
    if any(x.startswith("--ftr1_file") for x in extra):
        args = [a for i, a in enumerate(args)
                if a != "--synthetic_utts" and (i == 0 or args[i - 1] != "--synthetic_utts")]
    train_main(args + extra)
    decode_main(DECODE_ARGS + extra)


if __name__ == "__main__":
    main(sys.argv[1:])
