"""Checkpoint / resume of the full training state.

Counterpart of :mod:`asr_craft_tpu.train.checkpoint`: a checkpoint is a
directory holding ``state.pt`` (``torch.save`` of ``{params, optimizer
state, averaged params}``) and ``meta.json`` (``step``, ``epoch``,
``loader_state``), so ``--resume`` continues mid-training exactly.  The
directory is replaced atomically: it is written beside the target and
renamed into place.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import torch


def save_checkpoint(path: str, trainer, loader_state: Optional[Dict] = None
                    ) -> None:
    """Write a checkpoint directory at ``path`` (replaced atomically)."""
    path = os.path.abspath(path)
    tmp, old = f"{path}.tmp-{os.getpid()}", f"{path}.old-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"params": {k: v.detach().cpu()
                           for k, v in trainer.params.items()},
                "opt_state": trainer.opt.state_dict(),
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
    with torch.no_grad():
        for k, v in state["params"].items():
            trainer.params[k].copy_(v)
        for k, v in state["avg_params"].items():
            trainer.avg_params[k].copy_(v)
    trainer.opt.load_state_dict(state["opt_state"])
    trainer.step = int(meta["step"])
    trainer.epoch = int(meta["epoch"])
    return meta.get("loader_state", {})
