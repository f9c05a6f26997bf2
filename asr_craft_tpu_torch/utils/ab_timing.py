"""Time the kernels and steps of two checkouts of the repository on one
card, in turns: A, B, B, A.

    python asr_craft_tpu_torch/utils/ab_timing.py DIR_A DIR_B [--out FILE]
        [--only GROUP[,GROUP...]]

Each turn is its own process, started in that checkout with its package
first on the path, so two versions of ``asr_craft_tpu_torch`` never meet in
one interpreter; each builds its kernels at first use into its own
``_build`` directory.  A turn times, with CUDA events after a warm-up, the
minimum of two runs of a few calls each:
- the config-2 flagship: K1 whole (``fdt_forward_cuda``), K2
  (``fdt_backward_grad_cuda``, handed K1's planes where the checkout's K1
  returns them, as its train step does), one train step (loss, backward,
  SGD) at B=128, T=512, K3's forward (``viterbi_forward_cuda``) and
  ``decode()`` at B=64, T=512, with its trace; the traceback
  (``fdt_vit_tb_kernel``) by its own device time in a trace (events would
  read its wrapper's host time): alone on L2-resident backpointers, right
  after the forward has written them and inside ``decode()``;
- the shared-transition decode at B=64, T=512, all rows full: K7
  (``viterbi_dense_fwd``) at configs 1 and 3 and on config 5's n-state
  problem, K8 (``viterbi_nstate_fwd``) at config 5, each exact and with
  ``beam_threshold=8`` (config 3's recipe flag), at config 1 (K7) and 5
  (K8) with ``beam_width=16`` too, and ``decode()`` at configs
  1, 3 and 5, with its trace as below; the traceback's device time alone
  and inside ``decode()`` at each config;
- the shared-transition path at B=128, T=512, all rows full: K4
  (``forward_dual_cuda``), K5 whole (``backward_dual_grad_cuda``) and one
  train step at configs 1 and 5, and K6a, K6b, K14 at config 5;
- the segmental CRF (config 4) at B=128, T=512: K9, K10, K11 (whole), K12,
  K13 (and its device time, alone and inside ``scrf_decode``), one train
  step (``scrf_loss_fused``, backward, SGD) and ``scrf_decode``; and, from
  a ``torch.profiler`` trace of five calls (``bench.device_busy``), the
  step's and the decodes' device-busy ms and share a call and the kernels
  a call launches.  Names ending in "device" are a kernel's device ms from
  a trace of ten calls (``launch_ms``).
Each path (the config-2 step, its 8 steps in one call, ``decode()`` at
configs 2, 1, 3, 5, the shared steps at configs 1, 3, 5, the config-4
step and ``scrf_decode``) is timed as the checkout runs it (CUDA graphs
where it has ``train.graphs``) and again eagerly (inside
``graphs.disabled()``; the same code in a checkout without graphs), each
with its trace (:func:`trace`: wall and device-busy ms a call, the busy
share, kernels a call and host launches a call); "x8" rows are a call of
eight steps (``Trainer.multi_step``, or eight ``train_step`` calls).
``--only`` times the groups named (``fdt``, ``viterbi``, ``shared``,
``segmental``: the four items above, in order) and no other.  It prints one
JSON line a turn and, last, the card and every turn's times and traces;
``--out`` also writes them there.  Only the two checkouts' own
APIs in common are called, so a checkout from before a change of a
wrapper's return value runs too.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

PATHS = ("train step", "train step x8", "decode", "decode config1",
         "decode config3", "decode config5", "shared step config1",
         "shared step config3", "shared step config5", "scrf step",
         "scrf_decode")
NAMES = ("K1", "K2", "train step", "K3 forward", "decode",
         "K3 traceback device", "K3 traceback after fwd device",
         "K3 traceback in decode device",
         "traceback config1 device", "traceback config1 in decode device",
         "traceback config3 device", "traceback config3 in decode device",
         "traceback config5 device", "traceback config5 in decode device",
         "K7 config1", "K7 config1 thr8", "K7 config1 bw16", "K7 config3",
         "K7 config3 thr8", "K7 config5", "K8 config5", "K8 config5 thr8",
         "K8 config5 bw16",
         "decode config1", "decode config3", "decode config5",
         "K4 config1", "K5 config1", "shared step config1",
         "K4 config5", "K5 config5", "shared step config5",
         "K6a config5", "K6b config5", "K14 config5",
         "K9", "K10", "K11", "K12", "K13", "K13 device",
         "K13 in scrf_decode device", "scrf step", "scrf_decode",
         "train step x8", "K4 config3", "K5 config3",
         "shared step config3") + tuple(
             f"{p} eager" for p in PATHS)
# (name, beam_threshold, beam_width) of the shared-transition forwards
VITERBI_RUNS = {
    "config1": (("K7 config1", None, None), ("K7 config1 thr8", 8.0, None),
                ("K7 config1 bw16", None, 16)),
    "config3": (("K7 config3", None, None), ("K7 config3 thr8", 8.0, None)),
    "config5": (("K7 config5", None, None), ("K8 config5", None, None),
                ("K8 config5 thr8", 8.0, None), ("K8 config5 bw16", None, 16)),
}
TRACED = PATHS + tuple(f"{p} eager" for p in PATHS)
# the host's calls that put work on the device, as a trace names them
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
               "cudaMemcpyAsync", "cudaMemsetAsync", "cuMemcpyAsync",
               "cuMemsetD8Async", "cuMemsetD32Async")
FDT_TB, SEG_TB = "fdt_vit_tb_kernel", "seg_traceback_kernel"


def _ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def launch_ms(dev, fn, match, reps=10):
    """Device ms a launch of the kernel whose name holds ``match`` (one
    launch a call of ``fn``), from a ``torch.profiler`` trace of ``reps``
    calls: its summed device time over the launches the trace recorded,
    which may be fewer than the calls (a trace now and then drops kernel
    records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(dev)
        rows = [e for e in prof.key_averages() if match in e.key
                and e.device_type == torch.autograd.DeviceType.CUDA
                and e.count and e.device_time_total > 0]
        if rows:
            return (sum(e.device_time_total for e in rows)
                    / sum(e.count for e in rows) / 1e3)
    raise RuntimeError(f"three traces hold no launch of {match}")


def trace(dev, fn, reps=5) -> dict | None:
    """``{"wall_ms", "busy_ms", "pct", "kernels", "host_launches"}`` a
    call of ``fn``: ``reps`` calls traced with ``torch.profiler`` after
    one untraced call; the wall time, the device's busy time and share,
    the kernels the device ran and the launch calls the host made
    (``LAUNCH_APIS``: one ``cudaGraphLaunch`` for a captured call).  None
    where the trace holds no device time.  Its own, not the checkout's
    ``bench.device_busy``: it times checkouts from before host launches
    were counted."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) / reps * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0]
    if not kernels:
        return None
    busy = sum(e.device_time_total for e in kernels) / reps / 1e3
    return {"wall_ms": round(wall, 4), "busy_ms": round(busy, 4),
            "pct": round(100.0 * busy / wall, 1),
            "kernels": sum(e.count for e in kernels) / reps,
            "host_launches": sum(e.count for e in events
                                 if e.key in LAUNCH_APIS) / reps}


def _eager():
    """``graphs.disabled()`` where the checkout has the graphs; nothing in
    a checkout that runs every path eagerly."""
    try:
        from asr_craft_tpu_torch.train import graphs
    except ImportError:
        return contextlib.nullcontext()
    return graphs.disabled()


def _captured(fn, name):
    """``fn(bound, inputs)`` as the checkout captures it
    (``graphs.Graphed``), or ``fn`` itself in a checkout without graphs."""
    try:
        from asr_craft_tpu_torch.train import graphs
    except ImportError:
        return fn
    return graphs.Graphed(fn, name=name)


def _path(torch, dev, out, traces, name, fn, reps):
    """Time and trace ``fn`` as the checkout runs it, then eagerly."""
    out[name] = _ms(torch, fn, reps)
    traces[name] = trace(dev, fn)
    with _eager():
        out[f"{name} eager"] = _ms(torch, fn, reps)
        traces[f"{name} eager"] = trace(dev, fn)


def _viterbi(torch, dev) -> dict:
    """K7, K8 and decode() at configs 1, 3 and 5, B=64, T=512."""
    from asr_craft_tpu_torch import flagship
    from asr_craft_tpu_torch.kernels import viterbi as KV
    from asr_craft_tpu_torch.models.crf import (apply_boundaries, decode,
                                                potentials)

    out, traces = {}, {}
    for key, cfg in (("config1", flagship.timit_mono()),
                     ("config3", flagship.wsj_crandem()),
                     ("config5", flagship.swbd())):
        params = cfg.init_params(torch.Generator().manual_seed(0), 0.1, dev)
        feats = flagship.tiny_batch(cfg, 64, 512, 0, dev)["feats"]
        lengths = torch.full((64,), 512, dtype=torch.int32, device=dev)
        with torch.no_grad():
            state, trans = potentials(cfg, params, feats)
            state = apply_boundaries(cfg, state, lengths).contiguous()
        trans = trans.contiguous()
        ns = cfg.num_states
        for name, thr, bw in VITERBI_RUNS[key]:
            if name.startswith("K8"):
                fn = lambda: KV.viterbi_nstate_fwd(state, trans, lengths, ns,
                                                   thr, bw)
            else:
                fn = lambda: KV.viterbi_dense_fwd(state, trans, lengths, thr,
                                                  bw)
            out[name] = _ms(torch, fn, 10)

        def dec():
            return decode(cfg, params, feats, lengths)

        captured = _captured(
            lambda p, b: decode(cfg, p, b["feats"], b["lengths"]), "decode")
        inputs = {"feats": feats, "lengths": lengths}
        _path(torch, dev, out, traces, f"decode {key}",
              lambda: captured(params, inputs), 10)
        bp, last, _ = (KV.viterbi_nstate_fwd(state, trans, lengths, ns)
                       if ns > 1 else
                       KV.viterbi_dense_fwd(state, trans, lengths))
        out[f"traceback {key} device"] = launch_ms(
            dev, lambda: KV.viterbi_traceback(bp, last, lengths), FDT_TB)
        out[f"traceback {key} in decode device"] = launch_ms(dev, dec,
                                                              FDT_TB)
    out["_traces"] = traces
    return out


def _shared(torch, dev) -> dict:
    """K4, K5 and a train step at configs 1, 3 and 5; K6a, K6b, K14 at
    5."""
    from asr_craft_tpu_torch import flagship
    from asr_craft_tpu_torch.kernels import fwdbwd as K
    from asr_craft_tpu_torch.models.crf import apply_boundaries, potentials
    from asr_craft_tpu_torch.train import TrainConfig, Trainer

    out, traces = {}, {}
    for key, cfg in (("config1", flagship.timit_mono()),
                     ("config3", flagship.wsj_crandem()),
                     ("config5", flagship.swbd())):
        params = cfg.init_params(torch.Generator().manual_seed(0), 0.1, dev)
        batch = flagship.tiny_batch(cfg, 128, 512, 0, dev)
        lengths = batch["lengths"]
        with torch.no_grad():
            state, trans = potentials(cfg, params, batch["feats"])
            state = apply_boundaries(cfg, state, lengths).contiguous()
        trans = trans.contiguous()
        dual = (state, trans, batch["labels"], lengths)
        ns = cfg.num_states
        af, ac, zf, zc = K.forward_dual_cuda(*dual, ns)
        ones = torch.ones_like(zf)
        grad_in = (af, ac, zf, zc, ones, -ones)
        trainer = Trainer(cfg, TrainConfig(lr=0.03), params=params)
        out[f"K4 {key}"] = _ms(torch, lambda: K.forward_dual_cuda(*dual, ns),
                               10)
        out[f"K5 {key}"] = _ms(
            torch, lambda: K.backward_dual_grad_cuda(*dual, *grad_in, ns), 10)
        _path(torch, dev, out, traces, f"shared step {key}",
              lambda: trainer.train_step(batch, 0.03), 5)
        if key == "config5":
            single = (state, trans, lengths)
            out["K6a config5"] = _ms(torch, lambda: K.forward_cuda(*single),
                                     10)
            out["K6b config5"] = _ms(torch, lambda: K.backward_cuda(*single),
                                     10)
            out["K14 config5"] = _ms(
                torch, lambda: K.backward_dual_cuda(*dual, ns), 10)
    out["_traces"] = traces
    return out


def _segmental(torch, dev) -> dict:
    """K9-K13, a train step and scrf_decode at config 4."""
    from asr_craft_tpu_torch import flagship
    from asr_craft_tpu_torch.kernels import segmental as K
    from asr_craft_tpu_torch.models.segmental import (_frame_scores_and_bias,
                                                      scrf_decode,
                                                      scrf_loss_fused)

    cfg = flagship.scrf()
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.1, dev)
    batch = flagship.scrf_batch(cfg, 128, 512, 0, dev, False)
    lengths = batch["lengths"]
    with torch.no_grad():
        frame, bias = _frame_scores_and_bias(cfg, params, batch["feats"])
    args = (frame.contiguous(), params["b_trans"].contiguous(),
            bias.contiguous(), lengths)
    alphas, logZ = K.segmental_forward_cuda(*args)
    betas = K.segmental_backward_cuda(*args)
    grad_in = (alphas, betas, logZ, torch.ones_like(logZ))
    deltas, arg_d, lab0, _ = K.segmental_viterbi_cuda(*args)
    tb_in = (deltas, arg_d, args[1], lab0, lengths)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    try:                        # the checkout's compiled step, SGD at 0.05
        from asr_craft_tpu_torch.train import TrainConfig, make_train_step
        from asr_craft_tpu_torch.train.trainer import scrf_loss_fn
    except ImportError:
        opt = torch.optim.SGD(p.values(), lr=0.05)

        def step():
            opt.zero_grad(set_to_none=True)
            loss, _ = scrf_loss_fused(cfg, p, batch["feats"],
                                      batch["labels"], lengths)
            loss.backward()
            opt.step()
    else:
        train, opt = make_train_step(cfg, TrainConfig(lr=0.05),
                                     loss_fn=scrf_loss_fn(cfg))
        opt_state = opt.init(p)

        def step():
            train(p, opt_state, {}, batch, 0.05)

    def decode():
        return scrf_decode(cfg, p, batch["feats"], lengths)

    captured = _captured(lambda q, b: scrf_decode(cfg, q, b["feats"],
                                                  b["lengths"]),
                         "scrf_decode")
    inputs = {"feats": batch["feats"], "lengths": lengths}
    out, traces = {}, {}
    _path(torch, dev, out, traces, "scrf step", step, 5)
    _path(torch, dev, out, traces, "scrf_decode",
          lambda: captured(p, inputs), 10)
    return {
        **out, "_traces": traces,
        "K9": _ms(torch, lambda: K.segmental_forward_cuda(*args), 10),
        "K10": _ms(torch, lambda: K.segmental_backward_cuda(*args), 10),
        "K11": _ms(torch, lambda: K.segmental_grad_cuda(*args, *grad_in),
                   10),
        "K12": _ms(torch, lambda: K.segmental_viterbi_cuda(*args), 10),
        "K13": _ms(torch, lambda: K.segmental_viterbi_traceback_cuda(*tb_in),
                   10),
        "K13 device": launch_ms(
            dev, lambda: K.segmental_viterbi_traceback_cuda(*tb_in), SEG_TB),
        "K13 in scrf_decode device": launch_ms(dev, decode, SEG_TB),
    }


def _fdt(torch, dev) -> dict:
    """K1, K2, a train step at config 2; K3's forward and decode()."""
    import inspect

    from asr_craft_tpu_torch.flagship import flagship, tiny_batch
    from asr_craft_tpu_torch.kernels import fdt_train as K1
    from asr_craft_tpu_torch.kernels import fdt_viterbi as K3
    from asr_craft_tpu_torch.kernels.wall import build_wall
    from asr_craft_tpu_torch.models.crf import decode
    from asr_craft_tpu_torch.train import TrainConfig, Trainer

    cfg = flagship()
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.01, dev)
    batch = tiny_batch(cfg, 128, 512, 0, dev)
    feats, labels, lengths = batch["feats"], batch["labels"], \
        batch["lengths"]
    Wall, u0, u1, dims = build_wall(params, cfg.fmap, cfg.num_states)
    kw = dict(u0=u0, u1=u1, ns=cfg.num_states, P=dims["P"],
              clamp_ns=cfg.num_states, boundaries=True)
    args = (Wall, feats, labels, lengths)
    out = K1.fdt_forward_cuda(*args, **kw)
    alphas, zf, zc = out[:3]
    ones = torch.ones_like(zf)
    grad_args = args + (alphas, zf, zc, ones, -ones)
    k2_kw = dict(kw)
    if "planes" in inspect.signature(K1.fdt_backward_grad_cuda).parameters:
        k2_kw["planes"] = out[3]
    trainer = Trainer(cfg, TrainConfig(lr=0.5), params=params)
    dec_feats = feats[:64].contiguous()
    dec_len = torch.full((64,), 512, dtype=torch.int32, device=dev)
    vkw = {k: v for k, v in kw.items() if k != "clamp_ns"}
    bp, last, _ = K3.viterbi_forward_cuda(Wall, dec_feats, dec_len, **vkw)

    def dec():
        return decode(cfg, params, dec_feats, dec_len)

    captured = _captured(
        lambda p, b: decode(cfg, p, b["feats"], b["lengths"]), "decode")
    inputs = {"feats": dec_feats, "lengths": dec_len}
    batches = [batch] * 8
    if hasattr(trainer, "multi_step"):
        steps8 = lambda: trainer.multi_step(batches, 0.5)
    else:
        steps8 = lambda: [trainer.train_step(b, 0.5) for b in batches]
    out, traces = {}, {}
    _path(torch, dev, out, traces, "train step",
          lambda: trainer.train_step(batch, 0.5), 5)
    _path(torch, dev, out, traces, "train step x8", steps8, 2)
    _path(torch, dev, out, traces, "decode",
          lambda: captured(params, inputs), 10)
    return {
        **out, "_traces": traces,
        "K3 traceback device": launch_ms(
            dev, lambda: K3.viterbi_traceback_cuda(bp, last, dec_len),
            FDT_TB),
        "K3 traceback after fwd device": launch_ms(
            dev, lambda: K3.viterbi_traceback_cuda(*K3.viterbi_forward_cuda(
                Wall, dec_feats, dec_len, **vkw)[:2], dec_len), FDT_TB),
        "K3 traceback in decode device": launch_ms(dev, dec, FDT_TB),
        "K1": _ms(torch, lambda: K1.fdt_forward_cuda(*args, **kw), 5),
        "K2": _ms(torch, lambda: K1.fdt_backward_grad_cuda(
            *grad_args, **k2_kw), 5),
        "K3 forward": _ms(torch, lambda: K3.viterbi_forward_cuda(
            Wall, dec_feats, dec_len, **vkw), 10),
    }


GROUPS = {"fdt": _fdt, "viterbi": _viterbi, "shared": _shared,
          "segmental": _segmental}


def _child(groups) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"_traces": {}}
    for name in groups:
        got = GROUPS[name](torch, dev)
        out["_traces"].update(got.pop("_traces", {}))
        out.update(got)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("a", help="the first checkout (timed first and last)")
    p.add_argument("b", help="the second checkout")
    p.add_argument("--out", help="also write the result here (JSON)")
    p.add_argument("--only", default=",".join(GROUPS),
                   help="comma-separated groups to time (default: all)")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    groups = [g for g in args.only.split(",") if g]
    if any(g not in GROUPS for g in groups):
        p.error(f"--only takes groups of {sorted(GROUPS)}")
    if args.child:
        print(json.dumps(_child(groups)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    turns = []
    for label, tree in (("a", args.a), ("b", args.b), ("b", args.b),
                        ("a", args.a)):
        tree = os.path.abspath(tree)
        # the checkout's package first on the path, not this file's
        env = dict(os.environ, PYTHONPATH=tree, PYTHONSAFEPATH="1")
        run = subprocess.run([sys.executable, "-P", os.path.abspath(__file__),
                              args.a, args.b, "--only", ",".join(groups),
                              "--child"], cwd=tree, env=env,
                             capture_output=True, text=True, timeout=1200)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        times = json.loads(run.stdout.strip().splitlines()[-1])
        traces = times.pop("_traces")
        turns.append({"tree": label, "dir": tree, "ms": times,
                      "traces": traces})
        print(json.dumps(turns[-1]), flush=True)
    result = {"card": card, "order": "a, b, b, a",
              "ms": {name: [t["ms"][name] for t in turns] for name in NAMES
                     if name in turns[0]["ms"]},
              "traces": {name: [t["traces"][name] for t in turns]
                         for name in TRACED if name in turns[0]["traces"]}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "turns": turns}, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
