"""sol_pct.seg_train: kernels/segmental's training recursions, K9 (its own
frame, ``seg_alpha_kernel``, or the three-barrier ``seg_forward_kernel``),
K10 (``seg_beta_kernel`` or ``seg_backward_kernel``) and K11's three parts
(the message pass ``seg_message_kernel``; the xi pass ``seg_xi16_kernel``
or ``seg_xi_kernel`` with its gd sum, ``sum_partials_kernel``; the
contraction ``fb_contract_kernel``, whose chunks ``sum_partials_kernel``
adds too), against their frozen counts in crfbench/roofline_scrf.py for
real frames at the training precision.  Moves train_audio_s_per_s."""
from crfbench import roofline_scrf

GROUP = {
    "seg_alpha_kernel": "segmental_forward",
    "seg_forward_kernel": "segmental_forward",
    "seg_beta_kernel": "segmental_backward",
    "seg_backward_kernel": "segmental_backward",
    "seg_message_kernel": "segmental_grad_message",
    "seg_xi16_kernel": "segmental_grad",
    "seg_xi_kernel": "segmental_grad",
    "sum_partials_kernel": "segmental_grad",
    "fb_contract_kernel": "segmental_grad_contract",
}


def read(ctx):
    return roofline_scrf.sol_pct(ctx, "train", GROUP)
