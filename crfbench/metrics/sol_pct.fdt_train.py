"""sol_pct.fdt_train: kernels/fdt_train with csrc/fdt_mma.cu and
csrc/fdt_train.cu, the planes, K1's and K2's recursions and the dWall
contraction, against their frozen counts at the training precision.  Moves
train_audio_s_per_s."""
from crfbench import readers

GROUP = {
    "fdt_train_plane_kernel": "fdt_train_plane",
    "fdt_train_fwd_kernel": "fdt_train_fwd",
    "fdt_train_bwd_kernel": "fdt_train_bwd",
    "fdt_train_contract_kernel": "fdt_train_contract",
    "fdt_train_sum_kernel": "fdt_train_contract",
}


def read(ctx):
    return readers.sol_pct(ctx, "train", GROUP)
