"""glue_pct.seg_train: the device time of what is neither the port's own
kernels (csrc/) nor NCCL's, over the busy time: the frame scores' cuBLAS
products forward and backward, the gold numerator, the frame gradient's
assembly (``kernels.segmental.frame_grad``), the bias sums, SGD and the
gradient norm, the graphs' copies in, PyTorch's elementwise kernels.
Moves train_audio_s_per_s."""
from crfbench import readers


def read(ctx):
    return readers.glue_pct(ctx)
