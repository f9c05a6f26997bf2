"""Plain PyTorch dynamic programs: the references the CUDA kernels meet.

Re-exports the names of :mod:`asr_craft_tpu.ops`, with one exception:
``viterbi`` is left out, so that the name stays the submodule
:mod:`asr_craft_tpu_torch.ops.viterbi` (``from asr_craft_tpu_torch.ops
import viterbi`` imports the module), whose ``viterbi`` decodes one
utterance and ``viterbi_batch`` a batch, as in the JAX package.
"""
from asr_craft_tpu_torch.ops.semiring import (LOG, NEG_INF, TROPICAL,
                                              Semiring, get_semiring, matmul,
                                              matvec)
from asr_craft_tpu_torch.ops.fwdbwd import (backward, broadcast_trans,
                                            forward, forward_batch,
                                            log_partition,
                                            log_partition_batch, path_score,
                                            path_score_batch, posteriors,
                                            posteriors_batch)
from asr_craft_tpu_torch.ops.viterbi import viterbi_batch
from asr_craft_tpu_torch.ops.segmental import (segmental_forward,
                                               segmental_forward_batch,
                                               segmental_viterbi,
                                               segmental_viterbi_batch,
                                               segments_to_frames)
