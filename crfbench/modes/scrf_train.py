"""Training cells of the segmental CRF (``family`` scrf, ``mode`` train):
the trainer's own call, ``Trainer.multi_step`` of a ``SegCrfConfig`` on up
to ``steps_per_call`` K resident batches of one shape (one CUDA graph
replay: the frame scores, K9, K10, K11, the gold numerator and SGD a
step), grouped as ``Trainer.train_epoch`` groups an epoch's batches
(``gen.calls``), the pool's calls in turn.  The loop is the linear-chain
training cell's (``crf_train.serve``) with a warm stretch: set-up makes
the weights and the batches from the seed, makes one call of each shape
once (the eager warm-up and the capture), runs the pool's calls for
``WARM_S`` seconds, puts the weights and the optimizer's state back to the
seed's in place, and makes the first call again: its steps are the
checked ones.  The window goes on from there, and the reference
(``reference/scrf_train.py``) follows the checked steps once the window
has closed and the trainer is freed.

The labels are a phone segmentation's: ``gen.phone_labels``' run lengths
(``phone_run``, at most the model's ``max_dur``) and streams, each run's
phone drawn from the phones other than the run before it, so that two runs
never join into one longer than a segment can be; a last run too short
for ``phone_run`` joins the run before it where the two fit a segment and
stands alone where they do not.  The gold segmentation is then the runs,
each of 1 to ``max_dur`` frames.
"""
from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from crfbench import check, gen, harness
from crfbench.modes.crf_train import _leaves, _snapshot
from crfbench.reference import scrf_train as ref

# the seconds of the pool's calls run between the captures and the checked
# call, at most two thirds of the window: on an H100 the step ran ~3%
# slower for the first 5-20 s of a process's steady calls (the same kernels
# timed by events, 45.7 ms a pass over the pool, then 44.3 ms), and a
# window that caught that stretch or not spread 1.5-2.8% over seeds
WARM_S = 20.0


def model_config(cell: harness.Cell, kind: str):
    from asr_craft_tpu_torch.models.segmental import SegCrfConfig
    return SegCrfConfig(**cell.config["model"],
                        precision=cell.precision(kind))


def segment_labels(rng: np.random.Generator, lengths: np.ndarray, T: int,
                   run: tuple, n_phones: int, max_dur: int) -> np.ndarray:
    """(rows, T) int32 phone labels in runs of ``run[0]..min(run[1],
    max_dur)`` frames, each run's phone uniform over the phones but the
    previous run's; zero past each length (see the module's docstring)."""
    lo, hi = int(run[0]), min(int(run[1]), int(max_dur))
    rows = len(lengths)
    n_runs = T // lo + 1
    runs = rng.integers(lo, hi + 1, size=(rows, n_runs))
    first = rng.integers(0, n_phones, size=(rows, 1))
    steps = rng.integers(1, n_phones, size=(rows, n_runs - 1))
    phones = np.concatenate([first, first + np.cumsum(steps, 1)],
                            1) % n_phones
    ends = np.cumsum(runs, axis=1)
    out = np.zeros((rows, T), np.int32)
    t = np.arange(T)
    for r, n in enumerate(lengths):
        idx = np.searchsorted(ends[r], t[:n], side="right")
        last = idx[n - 1] if n else 0
        start = ends[r, last - 1] if last else 0
        before = ends[r, last - 2] if last > 1 else 0
        if last and n - start < lo and n - before <= max_dur:
            idx[start:n] = last - 1                # too short: merge back
        out[r, :n] = phones[r, idx]
    return out


def pool_labels(plan: list, n_phones: int, run: tuple, max_dur: int,
                seed: int) -> list:
    """The labels of every planned batch, drawn in ``gen.make_batches``'
    order (shape by shape, then the pool's order) from its label stream."""
    rng = np.random.default_rng(gen.stream_seed(seed, 0, 2))
    out = [None] * len(plan)
    for T in sorted({T for T, _ in plan}):
        for i, (t, lens) in enumerate(plan):
            if t == T:
                out[i] = segment_labels(rng, lens, T, run, n_phones, max_dur)
    return out


def make_batches(plan: list, cfg, run: tuple, seed: int, device) -> list:
    """``gen.make_batches``' frames and lengths with :func:`pool_labels`'
    labels."""
    batches = gen.make_batches(plan, cfg.feat_dim, cfg.num_labels, run,
                               seed, device)
    for b, lab in zip(batches, pool_labels(plan, cfg.num_labels, run,
                                           cfg.max_dur, seed)):
        b["labels"] = torch.from_numpy(lab).to(device)
    return batches


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
    batches = make_batches(plan, cfg, cell.traffic["phone_run"], cell.seed,
                           dev)
    frames = [int(l.sum()) for _, l in plan]
    params0 = gen.init_params(cfg.param_shapes(),
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
    warm_s, k = min(WARM_S, cell.seconds * 2 / 3), 0
    t = time.perf_counter()             # the steady calls before the window
    while time.perf_counter() - t < warm_s:
        call(calls[k % len(calls)])
        k += 1
        if k % len(calls) == 0:         # a pass over the pool in flight
            sync()
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
    del trainer, losses, m, batches
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"window_s": window_s, "t0_epoch": win.t0_epoch,
            "steps": n_steps, "frames": n_frames, "failed": failed,
            "peak": peak, "trace": trace, "obs": obs}


def run(cell: harness.Cell, device: str = "cuda") -> dict:
    """The cell's run and, once the window has closed and the trainer is
    freed, the reference's comparison."""
    res = serve(cell, device)
    return dict(res, numbers=numbers(cell, res["obs"], device),
                e2e={"train_audio_s_per_s":
                     res["frames"] * harness.FRAME_S / res["window_s"]},
                attempted=res["steps"])


def reference_train(params0: dict, batches: list, lr: float, max_dur: int,
                    device) -> dict:
    """Follow SGD steps of the reference from ``params0``, one a batch of
    ``batches``: the losses, the gradient norms, the first gradient and
    the parameters after each step (float64), as
    ``check.reference_train`` gives them for the linear-chain CRF."""
    p = {k: v.to(device, ref.DT) for k, v in params0.items()}
    losses, gnorms, after, first = [], [], [], None
    for b in batches:
        loss, grads = ref.loss_and_grads(p, b["feats"].to(device),
                                         b["labels"].to(device),
                                         b["lengths"].to(device), max_dur)
        losses.append(loss)
        gnorms.append(float(torch.sqrt(sum((g * g).sum()
                                           for g in grads.values()))))
        if first is None:
            first = grads
        p = {k: v - lr * grads[k] for k, v in p.items()}
        after.append(p)
    return {"losses": losses, "grad_norms": gnorms, "first_grad": first,
            "params": after}


def numbers(cell: harness.Cell, obs: dict, device: str) -> dict:
    """The checked steps against the reference, on the run's device:
    ``check.train_numbers``' ``loss_gap``, ``grad_norm_gap`` and
    ``change_gap``."""
    dev = torch.device(device)
    cfg = model_config(cell, "train")
    plan = gen.plan_batches(cell.traffic, cell.seed)
    batches = make_batches(plan, cfg, cell.traffic["phone_run"], cell.seed,
                           dev)
    steps = [batches[i] for i in obs["steps"]]
    lr = float(cell.config["optimizer"]["lr"])
    return check.train_numbers(obs, reference_train(
        obs["params0"], steps, lr, cfg.max_dur, dev))
