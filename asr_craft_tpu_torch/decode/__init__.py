"""Decode layer: batched Viterbi/beam decoding, scoring, FST lattice decode.

Replaces the reference's L6 (``CRF_ViterbiDecoder`` and its lattice class
— SURVEY.md §1): the dense DP lives in :mod:`asr_craft_tpu_torch.ops.viterbi` and
:func:`asr_craft_tpu_torch.models.crf.decode`; this package adds scoring
(PER/WER + TIMIT folding) and host-side lattice/FST word decoding.
"""
from asr_craft_tpu_torch.decode.scorer import (TIMIT_39, TIMIT_48, TIMIT_48_TO_39,
                                         ErrorRateScorer, collapse_frames,
                                         edit_distance, score_batch,
                                         timit_fold_indices)
