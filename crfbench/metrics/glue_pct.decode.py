"""glue_pct.decode: the device time of what is neither the port's own
kernels (csrc/) nor NCCL's, over the busy time: the potentials' and the
packing's kernels, the graph's copies in and out, PyTorch's elementwise
kernels.  Moves decode_audio_s_per_s."""
from crfbench import readers


def read(ctx):
    return readers.glue_pct(ctx)
