"""mfu_pct.seg_train: the whole segmental training step's share of the
chip's peak.  The least time the traced steps' counted operations take
(the step model of crfbench/roofline_scrf.py for real frames: the frame
scores' product forward and backward at the rate of the configuration's
training precision; K9, K10, K11, the numerator, the gradient's assembly
and SGD at the fp32 rate) over the traced stretch.  Moves
train_audio_s_per_s."""
from crfbench import roofline_scrf


def read(ctx):
    return roofline_scrf.mfu_pct(ctx, "train")
