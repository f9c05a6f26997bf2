"""Training: the trainer loop and checkpoint/resume (counterpart of
:mod:`asr_craft_tpu.train`)."""
from asr_craft_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
from asr_craft_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                               make_eval_step, make_optimizer,
                                               make_train_step)

__all__ = ["TrainConfig", "Trainer", "make_eval_step", "make_optimizer",
           "make_train_step", "save_checkpoint", "load_checkpoint"]
