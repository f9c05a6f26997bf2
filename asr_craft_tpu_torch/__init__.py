"""asr_craft_tpu_torch — the PyTorch/CUDA port of :mod:`asr_craft_tpu`.

The JAX package stays the reference; this package mirrors its module names
(``ops``, ``models``, ``kernels``, ``cli``) so each piece has an obvious
counterpart, and is held to it on identical inputs by ``tests/test_torch_*``.

It imports ``torch`` and never ``jax``, and nothing of ``asr_craft_tpu``:
the host code both packages need (``data``, ``decode``, ``cli.common``,
``utils.logging``: numpy and the C++ sources under ``native/``) lives here
as the port's own copy, held equal to the original by
``tests/test_torch_host_copies.py``.

Ported so far, decode and training alike: the frame-dependent-transition
CRF path (``models.crf`` -> ``kernels.fdt_viterbi`` / ``kernels.fdt_train``
-> ``csrc/fdt_viterbi.cu`` / ``csrc/fdt_train.cu``) and the
shared-transition path (``ops.mxu`` -> ``kernels.fwdbwd`` ->
``csrc/fwdbwd.cu``; ``kernels.viterbi`` -> ``csrc/viterbi.cu``), the trainer
(``train``) and the ``crf-train`` / ``crf-decode`` CLI twins; and the
segmental CRF (``models.segmental`` -> ``ops.segmental_stream`` ->
``kernels.segmental`` -> ``csrc/segmental.cu``, with the dense oracle
``ops.segmental`` and the recipe twin ``recipes.scrf``).  ROADMAP.md lists
what is still to come.
"""

__version__ = "0.1.0"
