"""CRF model pieces: topology, feature map, weight files, the model.

Re-exports the names of :mod:`asr_craft_tpu.models`.
"""
from asr_craft_tpu_torch.models.crf import (CrfConfig, crf_loss, decode,
                                            frame_accuracy, frame_posteriors,
                                            potentials)
from asr_craft_tpu_torch.models.feature_map import (FeatureMapConfig,
                                                    dense_potentials,
                                                    sparse_potentials)
from asr_craft_tpu_torch.models.topology import Topology
from asr_craft_tpu_torch.models import weights
