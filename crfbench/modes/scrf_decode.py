"""Decode cells of the segmental CRF (``family`` scrf, ``mode`` decode):
``models.segmental.scrf_decode`` through ``train.graphs.Graphed``, one
caller in a closed loop, each call ending when its segments (starts,
labels, counts) and scores are on the host.  The loop is the
linear-chain decode's (``crf_decode.serve``); its end-to-end metrics are
``seg_decode_audio_s_per_s`` and ``seg_decode_p95_ms``."""
from __future__ import annotations

import torch

from crfbench import check, harness
from crfbench.modes.crf_decode import record, serve


def model_config(cell: harness.Cell):
    from asr_craft_tpu_torch.models.segmental import SegCrfConfig
    return SegCrfConfig(**cell.config["model"],
                        precision=cell.precision("decode"))


def decoder(cfg):
    """The timed entry: ``fn(params, batch) -> (starts, labels, n_segs,
    scores)`` on the device, one CUDA graph a batch shape."""
    from asr_craft_tpu_torch.models import segmental
    from asr_craft_tpu_torch.train import graphs

    def fn(p, b):
        return segmental.scrf_decode(cfg, p, b["feats"], b["lengths"])
    return graphs.Graphed(fn, name="scrf_decode")


def run(cell: harness.Cell, device: str = "cuda") -> dict:
    res, cmp = serve(cell, decoder,
                     lambda out: tuple(x.cpu() for x in out),
                     model_config, device)
    numbers = check.scrf_decode_numbers(cmp["params"], cmp["batches"],
                                        cmp["results"], cell.config["model"],
                                        torch.device(device))
    return record(res, numbers, "seg_decode")
