"""Recipe 3 (BASELINE config 3): WSJ Crandem-style CRF.

42 phones, one state, a +/-2 window with per-utterance normalization,
bias-only transitions, beam-pruned Viterbi decode (K4, K5 in training; K7
with ``beam_threshold`` in decode).

Twin of ``recipes/wsj_crandem.py``: the same ``TRAIN_ARGS`` and
``DECODE_ARGS``, handed to the port's CLIs.  Extra flags are appended to
both lists, so ``--device cpu`` runs the plain PyTorch versions on the CPU;
the default is the GPU and its CUDA kernels.

Run:  python -m asr_craft_tpu_torch.recipes.wsj_crandem [--ftr1_file ...]
          [extra flags]
"""
import sys

TRAIN_ARGS = [
    "--crf_label_size", "42",          # WSJ phone set size (CMUdict-style)
    "--crf_states", "1",
    "--window_extent", "2",
    "--normalize", "utt",
    "--crf_lr", "0.05", "--crf_lr_decay", "0.85",
    "--crf_epochs", "15",
    "--batch_size", "48",
    "--out_dir", "./runs/wsj_crandem",
    "--synthetic_utts", "300",
]

DECODE_ARGS = [
    "--crf_label_size", "42",
    "--window_extent", "2",
    "--normalize", "utt",
    "--weight_file", "./runs/wsj_crandem/weights.final.dat",
    "--beam_threshold", "8.0",         # beam-pruned Viterbi
    "--synthetic_utts", "50",
]


def main(extra=()):
    from asr_craft_tpu_torch.cli.decode import main as decode_main
    from asr_craft_tpu_torch.cli.train import main as train_main
    train_main(TRAIN_ARGS + list(extra))
    decode_main(DECODE_ARGS + list(extra))


if __name__ == "__main__":
    main(sys.argv[1:])
