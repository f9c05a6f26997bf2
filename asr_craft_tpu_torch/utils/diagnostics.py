"""Observability and correctness-paranoia utilities.

Counterpart of :mod:`asr_craft_tpu.utils.diagnostics`, with PyTorch's tools:

- ``profiler_session`` / ``step_annotation``: a ``torch.profiler`` trace (CPU
  and CUDA activities) around training, written as a Chrome trace (open it
  in Perfetto or ``chrome://tracing``) into ``--profile_dir``; the steps
  appear in it as named ranges.
- ``enable_debug_nans``: JAX raises ``FloatingPointError`` at the first NaN
  or inf any operation produces.  Here: autograd's anomaly detection (it
  checks what every backward produces, the custom ``autograd.Function``s'
  too) plus :func:`check_finite` on the loss, the gradient norm and the
  parameters of every step in ``Trainer.train_step``.  The parameters are in
  it because a kernel's guards can swallow a NaN (``fmaxf`` drops a NaN
  operand, so a poisoned weight comes out of K1 on the card as a huge finite
  loss).  It costs a host-device synchronisation a step; that is what the
  flag buys.
- ``deterministic``: a seeded ``torch.Generator``, the port's explicit
  generator idiom.  ``torch.use_deterministic_algorithms`` is left off: on a
  CUDA device the main path's ``cumsum`` (``kernels.segmental.frame_grad``,
  ``_pack_segment_markers``) refuses it, and the port's own kernels are
  deterministic by construction (no atomics; partials summed in a fixed
  order).  What is left to pin down is the seed, and presentation order
  derives from (seed, epoch) in ``data.loader``.
- ``assert_replicated``: the cross-rank sync assertion.  With one process
  it returns without comparing, as the JAX function does with one device;
  under an initialised ``torch.distributed`` world of several ranks it
  gathers every rank's copy and compares.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profiler_session(profile_dir: Optional[str]) -> Iterator[None]:
    """Trace everything inside the context into
    ``profile_dir/trace.json`` (no-op when None)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def step_annotation(name: str, step: int):
    """Named step marker visible in the trace viewer."""
    return torch.profiler.record_function(f"{name}#{step}")


def enable_debug_nans(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(bool(on), check_nan=bool(on))


def debug_nans_enabled() -> bool:
    """Whether the trainer checks every step (the anomaly mode is the
    flag)."""
    return torch.is_anomaly_enabled()


def check_finite(what: str, step: int, **values) -> None:
    """Raise ``FloatingPointError`` naming ``step`` if any of ``values``
    (tensors) holds a NaN or an inf.  One host fetch."""
    bad = [k for k, v in values.items()
           if not bool(torch.isfinite(v).all())]
    if bad:
        raise FloatingPointError(
            f"{what}: non-finite {', '.join(bad)} at step {step} "
            "(--debug_nans)")


def deterministic(seed: int = 0) -> torch.Generator:
    """A generator seeded with ``seed``: the root of a reproducible run
    (``init_params`` and the tests take it explicitly)."""
    return torch.Generator().manual_seed(seed)


def assert_replicated(tree: dict, atol: float = 0.0,
                      what: str = "params") -> None:
    """Assert that every rank holds the same values of each tensor of
    ``tree``.

    Run every N steps under data parallelism to catch replica divergence.
    Returns at once when ``torch.distributed`` is not initialised or the
    world has one rank.
    """
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return
    for key, leaf in tree.items():
        mine = leaf.detach().contiguous()
        copies = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(copies, mine)
        for rank, got in enumerate(copies[1:], start=1):
            if not torch.allclose(copies[0], got, atol=atol, rtol=0):
                diff = float((copies[0] - got).abs().max())
                raise AssertionError(
                    f"{what}[{key!r}] diverges across ranks 0 vs {rank}: "
                    f"max abs diff {diff}")


def grad_sync_check_hook(every: int = 100):
    """Returns ``hook(step, params)`` to call from the training loop."""
    def hook(step: int, params) -> None:
        if every and step % every == 0:
            assert_replicated(params)
    return hook
