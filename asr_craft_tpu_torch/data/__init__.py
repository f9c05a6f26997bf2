"""Data layer: pfile/HTK/MLF I/O, feature transforms, sharded batch loader,
synthetic corpora.

Replaces the reference's QuickNet-stream-based L0/L1 (SURVEY.md §1):
``CRF_FeatureStream`` / ``CRF_FeatureStreamManager`` / ``CRF_MLFManager``.
"""
from asr_craft_tpu_torch.data.htk import (read_htk, read_htk_labels, write_htk,
                                    write_htk_labels)
from asr_craft_tpu_torch.data.loader import LoaderConfig, UtteranceLoader, train_cv_split
from asr_craft_tpu_torch.data.mlf import mlf_to_label_seqs, read_mlf, write_mlf
from asr_craft_tpu_torch.data.pfile import PFile, read_pfile, write_pfile
from asr_craft_tpu_torch.data.sparse import (SparseCorpus, densify, is_sparse_file,
                                       read_sparse_file, sparsify_frames,
                                       write_sparse_file)
from asr_craft_tpu_torch.data.synthetic import (SyntheticConfig, WordCorpusConfig,
                                          generate_corpus,
                                          generate_utterance,
                                          generate_word_corpus,
                                          nstate_frame_labels)
from asr_craft_tpu_torch.data.window import (Normalizer, add_deltas, concat_streams,
                                       context_window, deltas)
