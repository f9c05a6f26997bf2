"""idle_pct.seg_train: the share of the traced stretch in which the device
ran nothing (no kernel, copy or set), 100 x (1 - union of the device's
intervals / stretch).  Moves train_audio_s_per_s."""
from crfbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
