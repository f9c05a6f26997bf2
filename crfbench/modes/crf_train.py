"""Training cells of the linear-chain CRF (``family`` crf, ``mode``
train): the trainer's own call, ``Trainer.multi_step`` on up to
``steps_per_call`` K resident batches of one shape (one CUDA graph
replay), grouped as ``Trainer.train_epoch`` groups an epoch's batches
(``gen.calls``), the pool's calls in turn.

Set-up makes the weights and the batches from the seed, makes one call of
each shape once (the eager warm-up and the capture), puts the weights and
the optimizer's state back to the seed's in place, and makes the first
call again: its steps are the checked ones.  The window goes on from there.
The reference follows the checked steps once the window has closed and
the trainer is freed.
"""
from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from crfbench import check, gen, harness

def model_config(cell: harness.Cell, kind: str):
    from asr_craft_tpu_torch.models.crf import CrfConfig
    m = dict(cell.config["model"])
    for k in ("trans_range", "state_range"):
        if m.get(k) is not None:
            m[k] = tuple(m[k])
    return CrfConfig(**m, precision=cell.precision(kind))


def _snapshot(params):
    return {k: v.detach().clone().cpu() for k, v in params.items()}


def serve(cell: harness.Cell, device: str = "cuda") -> dict:
    """The set-up, the checked steps and the window; returns the run's
    record and the checked steps' readings (plain data)."""
    from asr_craft_tpu_torch.train import TrainConfig, Trainer
    from asr_craft_tpu_torch.utils.logging import MetricsLogger

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    cfg = model_config(cell, "train")
    opt = cell.config["optimizer"]
    lr = float(opt["lr"])
    K = int(cell.traffic["steps_per_call"])
    tc = TrainConfig(lr=lr, optimizer=opt["kind"], steps_per_call=K)
    plan = gen.plan_batches(cell.traffic, cell.seed)
    batches = gen.make_batches(plan, cfg.feat_dim, cfg.num_labels,
                               cell.traffic["phone_run"], cell.seed, dev)
    frames = [int(l.sum()) for _, l in plan]
    params0 = gen.init_params(cfg.fmap.param_shapes(),
                              float(cell.config["init_std"]), cell.seed, dev)
    trainer = Trainer(cfg, tc, params=params0,
                      logger=MetricsLogger(quiet=True), device=dev)
    p0 = _snapshot(trainer.params)

    # the window's calls: the trainer's groups of up to K batches, in turn
    calls = gen.calls(plan, K)

    def call(idx):
        return trainer.multi_step([batches[i] for i in idx], lr)

    shapes = {}                         # a call of each shape
    for idx in calls:
        shapes.setdefault((len(idx), plan[idx[0]][0]), idx)
    for idx in shapes.values():         # the warm-up and the capture
        call(idx)
    sync()
    # back to the seed's weights and a fresh optimizer state, in place
    with torch.no_grad():
        for k, p in trainer.params.items():
            p.copy_(params0[k])
            trainer.avg_params[k].copy_(params0[k])
        fresh = trainer.opt.init(trainer.params)
        for dst, src in zip(_leaves(trainer.opt_state), _leaves(fresh)):
            dst.copy_(src)
    trainer.step = 0
    # the checked steps, through the window's own call
    m = call(calls[0])
    obs = {"params0": p0, "params_after": _snapshot(trainer.params),
           "losses": m["loss"].cpu().numpy(),
           "grad_norms": m["grad_norm"].cpu().numpy(), "steps": calls[0]}

    # the window
    win = harness.Window(cell.seconds, cell.trace, sync)
    inflight = collections.deque()
    losses, n_steps, n_frames, k = [], 0, 0, 0
    win.start()
    while win.elapsed() < cell.seconds:
        win.before_call()
        idx = calls[(k + 1) % len(calls)]
        m = call(idx)
        win.note({"steps": [(plan[i][0], frames[i]) for i in idx]})
        losses.append(m["loss"])
        n_steps += len(idx)
        n_frames += sum(frames[i] for i in idx)
        k += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) > 2:
                inflight.popleft().synchronize()
    window_s = win.close()
    loss_all = torch.cat([x.reshape(-1) for x in losses]).cpu()
    failed = int((~torch.isfinite(loss_all)).sum())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace = harness.reduce_trace(win)
    del trainer, losses, m
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"window_s": window_s, "t0_epoch": win.t0_epoch,
            "steps": n_steps, "frames": n_frames, "failed": failed,
            "peak": peak, "trace": trace, "obs": obs}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def run(cell: harness.Cell, device: str = "cuda") -> dict:
    """The cell's run and, once the window has closed and the trainer is
    freed, the reference's comparison."""
    res = serve(cell, device)
    return dict(res, numbers=_compare(cell, res, device),
                e2e={"train_audio_s_per_s":
                     res["frames"] * harness.FRAME_S / res["window_s"]},
                attempted=res["steps"])


def _compare(cell: harness.Cell, res: dict, device: str) -> dict:
    """The checked steps against the reference, on the run's device."""
    dev = torch.device(device)
    cfg = model_config(cell, "train")
    plan = gen.plan_batches(cell.traffic, cell.seed)
    batches = gen.make_batches(plan, cfg.feat_dim, cfg.num_labels,
                               cell.traffic["phone_run"], cell.seed, dev)
    steps = [batches[i] for i in res["obs"]["steps"]]
    lr = float(cell.config["optimizer"]["lr"])
    ref = check.reference_train(res["obs"]["params0"], steps, lr,
                                cell.config["model"], dev)
    return check.train_numbers(res["obs"], ref)
