"""Parallelism: data-parallel training on ``torch.distributed`` and the
time-sharded decode.

Counterpart of :mod:`asr_craft_tpu.parallel`: :mod:`.mesh` (process groups,
batch placement, replicated parameters; the trainer issues the gradient
all-reduce) and :mod:`.timeshard` (the time axis of the Viterbi and logZ
recursions cut into chunks, by the associativity of the semiring matrix
product).  The JAX names ``batch_shardings`` and ``replicated`` have no
counterpart here (see :mod:`.mesh`).
"""
from asr_craft_tpu_torch.parallel.mesh import (Mesh, data_shard_info,
                                               initialize_distributed,
                                               make_batch_put, make_mesh,
                                               replicate_tree)
