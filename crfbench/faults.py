"""Faults planted underneath the timed path, to show that the comparison
that decides ``correct`` catches them (``--fault <name>`` on the chip, and
the CPU tests).  Each patches the program's module attribute that the
timed path looks up at call time, and returns the function that takes the
patch out again.  The benchmark's own runs plant none.

- ``frozen``: the optimizer's update changes nothing (a step that returns
  its state unchanged).
- ``half_batch``: the loss sees the first half of the batch's rows, its
  mean taken over their frames (half of the batch left out).
- ``token``: the decode's first row has one label altered where it is
  produced (a state of its best path, or its first segment's label).
"""
from __future__ import annotations


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


def _frozen():
    from asr_craft_tpu_torch.train import trainer
    return _patch(trainer.Optimizer, "update",
                  lambda self, grads, state, params, lr=None: None)


def _half_batch():
    from asr_craft_tpu_torch.models import crf
    real = crf.crf_loss

    def half(cfg, params, feats, labels, lengths, *args, **kwargs):
        h = labels.shape[0] // 2
        return real(cfg, params, None if feats is None else feats[:h],
                    labels[:h], lengths[:h], *args, **kwargs)
    return _patch(crf, "crf_loss", half)


def _token():
    from asr_craft_tpu_torch.models import crf, segmental
    real_crf, real_seg = crf.decode, segmental.scrf_decode

    def crf_decode(cfg, *args, **kwargs):
        phones, paths, scores = real_crf(cfg, *args, **kwargs)
        paths = paths.clone()
        L = cfg.num_labels * cfg.num_states
        paths[0, 1] = (paths[0, 1] + 1) % L
        return cfg.topology.path_to_phones(paths), paths, scores

    def seg_decode(cfg, *args, **kwargs):
        starts, labels, n_segs, scores = real_seg(cfg, *args, **kwargs)
        labels = labels.clone()
        labels[0, 0] = (labels[0, 0] + 1) % cfg.num_labels
        return starts, labels, n_segs, scores
    undo = [_patch(crf, "decode", crf_decode),
            _patch(segmental, "scrf_decode", seg_decode)]
    return lambda: [u() for u in undo]


FAULTS = {"frozen": _frozen, "half_batch": _half_batch, "token": _token}


def plant(name: str):
    """Plant the fault ``name``; returns the undo."""
    return FAULTS[name]()
