"""mfu_pct.decode: the whole step's share of the chip's peak.  The least
time the traced steps' counted operations take (the frozen step model of
crfbench/roofline.py for real frames: products at the rate of the
configuration's decode precision, the rest at the fp32 rate) over the
traced stretch.  Moves decode_audio_s_per_s."""
from crfbench import readers


def read(ctx):
    return readers.mfu_pct(ctx, "decode")
