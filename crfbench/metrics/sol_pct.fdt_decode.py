"""sol_pct.fdt_decode: kernels/fdt_viterbi, K3's planes (the plane kernel
of csrc/fdt_mma.cu), its forward and the traceback, against their frozen
counts at the decode precision.  Moves decode_audio_s_per_s."""
from crfbench import readers

GROUP = {
    "fdt_train_plane_kernel": "fdt_viterbi_plane",
    "fdt_vit_fwd_kernel": "fdt_viterbi_fwd",
    "fdt_vit_tb_kernel": "fdt_viterbi_traceback",
}


def read(ctx):
    return readers.sol_pct(ctx, "decode", GROUP)
