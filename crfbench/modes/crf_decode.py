"""Decode cells of the linear-chain CRF (``family`` crf, ``mode`` decode):
``models.crf.decode`` through ``train.graphs.Graphed``, one caller in a
closed loop.

A call hands a resident batch to the decode and ends when its best paths
and scores are on the host, as the decode CLI needs them to write the
batch's MLF; the next call starts then.  The pool's batches are taken in
turn.  Set-up warms each batch shape (the eager warm-up and the capture,
then one replay).  Once the window has closed, the last served result of
the batch that holds the longest utterance, and of a few more drawn from
the seed, is held to the reference.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from crfbench import check, gen, harness
from crfbench.modes.crf_train import model_config

SAMPLED = 4          # batches whose served results are compared


def decoder(cfg):
    """The timed entry: ``fn(params, batch) -> (paths, scores)`` on the
    device, one CUDA graph a batch shape."""
    from asr_craft_tpu_torch.models import crf as crf_mod
    from asr_craft_tpu_torch.train import graphs

    def fn(p, b):
        _, paths, scores = crf_mod.decode(cfg, p, b["feats"], b["lengths"])
        return paths, scores
    return graphs.Graphed(fn, name="decode")


def serve(cell, make_fn, to_host, model_kind, device: str):
    """The closed loop shared by the decode modes: ``make_fn(cfg)`` the
    timed entry, ``to_host(out)`` its results on the host.  Returns the
    run's record and what the comparison needs."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    cfg = model_kind(cell)
    plan = gen.plan_batches(cell.traffic, cell.seed)
    batches = gen.make_batches(plan, cfg.feat_dim, cfg.num_labels,
                               cell.traffic["phone_run"], cell.seed, dev)
    inputs = [{"feats": b["feats"], "lengths": b["lengths"]}
              for b in batches]
    frames = [int(l.sum()) for _, l in plan]
    shapes = cfg.param_shapes() if hasattr(cfg, "param_shapes") else \
        cfg.fmap.param_shapes()
    params = gen.init_params(shapes, float(cell.config["init_std"]),
                             cell.seed, dev)
    fn = make_fn(cfg)
    first = {}
    for i, (T, _) in enumerate(plan):
        first.setdefault(T, i)
    for i in first.values():
        for _ in range(2):                   # warm-up + capture, a replay
            to_host(fn(params, inputs[i]))
    sync()
    win = harness.Window(cell.seconds, cell.trace, sync)
    lat, served, k, n_frames = [], {}, 0, 0
    win.start()
    while win.elapsed() < cell.seconds:
        win.before_call()
        i = k % len(inputs)
        t = time.perf_counter()
        out = to_host(fn(params, inputs[i]))
        lat.append(time.perf_counter() - t)
        served[i] = out
        win.note({"T": plan[i][0], "B": len(plan[i][1]),
                  "frames": frames[i], "segments": _segments(out)})
        n_frames += frames[i]
        k += 1
    window_s = win.close()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace = harness.reduce_trace(win)
    del fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(gen.stream_seed(cell.seed, 0, 9))
    longest = max(served, key=lambda i: int(plan[i][1].max()))
    rest = sorted(i for i in served if i != longest)
    pick = sorted([longest] + [int(i) for i in rng.choice(
        rest, size=min(SAMPLED - 1, len(rest)), replace=False)])
    return {"window_s": window_s, "t0_epoch": win.t0_epoch,
            "calls": k, "frames": n_frames, "latencies": lat, "peak": peak,
            "trace": trace}, {
        "params": params, "batches": [batches[i] for i in pick],
        "results": [served[i] for i in pick]}


def _segments(out):
    """The segments a served segmentation holds (its ``n_segs``)."""
    return int(out[2].sum()) if len(out) == 4 else None


def record(res: dict, numbers: dict, name: str = "decode") -> dict:
    """The run's record; its end-to-end metrics ``<name>_audio_s_per_s``
    and ``<name>_p95_ms``."""
    return dict(res, numbers=numbers, attempted=res["calls"], failed=0,
                e2e={f"{name}_audio_s_per_s":
                     res["frames"] * harness.FRAME_S / res["window_s"],
                     f"{name}_p95_ms": 1e3 * harness.percentile(
                         res["latencies"], 0.95)})


def run(cell: harness.Cell, device: str = "cuda") -> dict:
    res, cmp = serve(cell, decoder,
                     lambda out: tuple(x.cpu() for x in out),
                     lambda c: model_config(c, "decode"), device)
    numbers = check.crf_decode_numbers(cmp["params"], cmp["batches"],
                                       cmp["results"], cell.config["model"],
                                       torch.device(device))
    return record(res, numbers)
