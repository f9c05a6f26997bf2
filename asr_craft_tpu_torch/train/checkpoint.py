"""Checkpoint / resume of the full training state.

Counterpart of :mod:`asr_craft_tpu.train.checkpoint`: a checkpoint is a
directory holding ``state.pt`` (``torch.save`` of ``{params, optimizer
state, averaged params}``, restored in place) and ``meta.json``
(``step``, ``epoch``, ``loader_state``), so ``--resume`` continues
mid-training exactly.  The
directory is replaced atomically: it is written beside the target and
renamed into place.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import torch

from asr_craft_tpu_torch.train.graphs import leaves, tree_map


def save_checkpoint(path: str, trainer, loader_state: Optional[Dict] = None
                    ) -> None:
    """Write a checkpoint directory at ``path`` (replaced atomically)."""
    path = os.path.abspath(path)
    tmp, old = f"{path}.tmp-{os.getpid()}", f"{path}.old-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"params": {k: v.detach().cpu()
                           for k, v in trainer.params.items()},
                "opt_state": tree_map(lambda t: t.detach().cpu(),
                                      trainer.opt_state),
                "avg_params": {k: v.detach().cpu()
                               for k, v in trainer.avg_params.items()}},
               os.path.join(tmp, "state.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": trainer.step, "epoch": trainer.epoch,
                   "loader_state": loader_state or {}}, f)
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def load_checkpoint(path: str, trainer) -> Dict:
    """Restore the trainer's state in place; returns the loader state."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state = torch.load(os.path.join(path, "state.pt"),
                       map_location=trainer.device, weights_only=True)
    # in place: the trainer's CUDA graphs read and write these tensors
    with torch.no_grad():
        for key in ("params", "avg_params", "opt_state"):
            for dst, src in zip(leaves(getattr(trainer, key)),
                                leaves(state[key]), strict=True):
                dst.copy_(src)
    trainer.step = int(meta["step"])
    trainer.epoch = int(meta["epoch"])
    return meta.get("loader_state", {})
