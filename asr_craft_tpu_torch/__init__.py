"""asr_craft_tpu_torch — the PyTorch/CUDA port of :mod:`asr_craft_tpu`.

The JAX package stays the reference; this package mirrors its module names
(``ops``, ``models``, ``kernels``, ``cli``) so each piece has an obvious
counterpart, and is held to it on identical inputs by ``tests/test_torch_*``.

It imports ``torch`` and never ``jax``.  Framework-neutral host code
(``asr_craft_tpu.data``, ``asr_craft_tpu.decode.scorer``,
``asr_craft_tpu.cli.common``, ``asr_craft_tpu.utils.logging``) imports no
JAX either and is used from the JAX package as it is, not copied.

Ported so far: the frame-dependent-transition CRF path, decode and
training.  ``models.crf.decode`` -> ``kernels.fdt_viterbi`` -> the
hand-written CUDA kernels in ``csrc/fdt_viterbi.cu``; ``models.crf.crf_loss``
-> ``kernels.fdt_train.FdtNllDual`` -> ``csrc/fdt_train.cu``; the trainer
(``train``) and the ``crf-train`` / ``crf-decode`` CLI twins.  ROADMAP.md
lists what is still to come.
"""

__version__ = "0.1.0"
