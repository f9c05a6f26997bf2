"""sol_pct.seg_decode: kernels/segmental's decode, K12's max-plus
recursion and K13's traceback (its bytes from the segments each traced
batch's best paths hold), against their frozen counts.  Moves
seg_decode_audio_s_per_s."""
from crfbench import readers

GROUP = {
    "seg_delta_kernel": "segmental_viterbi",
    "seg_forward_kernel": "segmental_viterbi",
    "seg_traceback_kernel": "segmental_viterbi_traceback",
}


def read(ctx):
    return readers.sol_pct(ctx, "decode", GROUP)
