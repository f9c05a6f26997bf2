"""capture_s.seg_train: ``capture_s.train``'s reading in the segmental
training cell: the self seconds of ``graph.warm_up`` and ``graph.capture``
over the cell's shapes, without ``kernels.load``.  Moves setup_s."""
from crfbench import harness


def read(ctx):
    return harness.metric_reader("capture_s.train")(ctx)
