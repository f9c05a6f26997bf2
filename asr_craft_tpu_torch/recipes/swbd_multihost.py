"""Recipe 5 (BASELINE config 5): Switchboard-scale CRF training.

46 phones x 3 states, a +/-2 window with global normalization, large
batches (K4, K5 in training; K8 and the traceback kernel in the CV decode).

Twin of ``recipes/swbd_multihost.py``: the same ``TRAIN_ARGS``, handed to
the port's train CLI with the extra flags appended (``--device cpu`` runs
the plain PyTorch versions on the CPU; the default is the GPU and its CUDA
kernels).  As the JAX recipe trains data-parallel over every device, this
one trains data-parallel over the ranks torchrun starts, one GPU a rank
(``--device cpu``: gloo ranks on the CPU), each on its shard of the corpus:

    python -m torch.distributed.run --standalone --nproc_per_node 8 \
        -m asr_craft_tpu_torch.recipes.swbd_multihost [--ftr1_file ...]

The time-sharded decode is a flag of the decode CLI (``--time_shard N
[--shard_beam_labels K]``), and the weak-scaling measurement ``python -m
asr_craft_tpu_torch.bench --scaling --check``.

Run:  python -m asr_craft_tpu_torch.recipes.swbd_multihost [--ftr1_file
          swbd.pfile ...]
"""
import sys

TRAIN_ARGS = [
    "--crf_label_size", "46",
    "--crf_states", "3",
    "--window_extent", "2",
    "--normalize", "global",
    "--crf_lr", "0.03", "--crf_lr_decay", "0.9",
    "--crf_epochs", "8",
    "--batch_size", "64",
    "--bucket_sizes", "256,512,1024,2048",
    "--out_dir", "./runs/swbd",
    "--synthetic_utts", "500",
]


def main(extra=()):
    from asr_craft_tpu_torch.cli.train import main as train_main
    train_main(TRAIN_ARGS + list(extra))


if __name__ == "__main__":
    main(sys.argv[1:])
