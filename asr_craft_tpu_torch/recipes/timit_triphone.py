"""Recipe 2 (BASELINE config 2): TIMIT triphone-state CRF.

3 states per phone (entry/mid/exit left-to-right topology), posterior
features windowed +/-1 frame, frame-dependent transition features over all
windowed dims: the flagship (K1, K2 in training; K3 in decode).

Twin of ``recipes/timit_triphone.py``: the same ``TRAIN_ARGS`` and
``DECODE_ARGS``, handed to the port's CLIs.  Extra flags are appended to
both lists, so ``--device cpu`` runs the plain PyTorch versions on the CPU;
the default is the GPU and its CUDA kernels.

Run:  python -m asr_craft_tpu_torch.recipes.timit_triphone [--ftr1_file ...]
          [extra flags]
"""
import sys

TRAIN_ARGS = [
    "--crf_label_size", "48",
    "--crf_states", "3",
    "--window_extent", "1",
    # route all windowed dims to state fns AND transition fns (Crandem-style
    # transition feature functions)
    "--crf_transftr_start", "0", "--crf_transftr_end", "144",
    "--crf_lr", "0.05", "--crf_lr_decay", "0.9",
    "--crf_epochs", "12",
    "--batch_size", "32",
    "--out_dir", "./runs/timit_tri",
    "--synthetic_utts", "200",
]

DECODE_ARGS = [
    "--crf_label_size", "48",
    "--crf_states", "3",
    "--window_extent", "1",
    "--crf_transftr_start", "0", "--crf_transftr_end", "144",
    "--weight_file", "./runs/timit_tri/weights.final.dat",
    "--timit_fold",
    "--synthetic_utts", "50",
]


def main(extra=()):
    from asr_craft_tpu_torch.cli.decode import main as decode_main
    from asr_craft_tpu_torch.cli.train import main as train_main
    train_main(TRAIN_ARGS + list(extra))
    decode_main(DECODE_ARGS + list(extra))


if __name__ == "__main__":
    main(sys.argv[1:])
