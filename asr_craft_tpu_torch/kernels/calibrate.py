"""K15: the in-kernel elementwise calibration — the CUDA kernel, its plain
twin, the dispatch between them and the timing around it.

Counterpart of ``asr_craft_tpu.utils.roofline.measure_vpu_geps_pallas``.
The kernel is in ``csrc/calibrate.cu`` (the note there says which regime it
stands for and why it has the shape of the port's recursions).  It applies a
chain of ``steps * passes`` dependent elementwise operations (seven ``z *
0.999 + 1e-4``, then one ``exp(z * -0.5)``, repeating) to every element of a
``(Dmax, Ls, Bk)`` float32 window filled from ``x (Ls, Bk)``; ``steps`` is
the TPU kernel's ``grid_n * frames``.

================================  ==========================  ==============
dispatch                          kernel wrapper              plain
================================  ==========================  ==============
:func:`calibrate_chain` (K15)     ``calibrate_chain_cuda``    ``..._plain``
================================  ==========================  ==============

All three return the whole window ``(Dmax, Ls, Bk)``; slot 0 is what the
TPU kernel returns.  The dispatcher follows
:func:`asr_craft_tpu_torch.kernels.use_kernel`: a CUDA tensor under ``auto``
launches the kernel or raises, a CPU tensor takes the plain version.
The wrapper counts its launches in the counter ``kernels.calibrate``.

The kernel and the plain version agree to ~1e-6, not bit for bit: nvcc
contracts ``z * 0.999 + 1e-4`` into one fused multiply-add where PyTorch
rounds twice.  The map is a contraction (eight operations shrink a
difference by more than half), so the gap does not grow with the chain.

:func:`measure` times it: ``lo_n`` and ``hi_n`` launches back to back
between CUDA events, the slope between the two, the median over ``reps``.
"""
from __future__ import annotations

import ctypes
import time

import torch

from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.kernels import _build
from asr_craft_tpu_torch.utils import diagnostics

SMEM_LIMIT = 232448         # bytes of shared memory a Hopper block may use
LO_N, HI_N = 2, 6           # launches in the two timed runs of one slope
COUNTER = "kernels.calibrate"   # the wrapper's launch counter

_lib = None


def calibrate_chain_plain(x, Dmax: int = 16, passes: int = 16,
                          steps: int = 1):
    """The plain version of :func:`calibrate_chain_cuda`: the chain step by
    step with PyTorch operations on a ``(Dmax, Ls, Bk)`` tensor.  Slow by
    design at long chains (every operation is a pass over memory)."""
    z = x[None].expand(Dmax, *x.shape).clone()
    for _ in range(steps):
        for p in range(passes):
            if p % 8 == 7:
                z = torch.exp(z * -0.5)
            else:
                z = z * 0.999 + 1e-4
    return z


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library()
        lib.calibrate_chain.argtypes = ([ctypes.c_void_p] * 2
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
        lib.calibrate_chain.restype = ctypes.c_int
        _lib = lib
    return _lib


def calibrate_chain_cuda(x, Dmax: int = 16, passes: int = 16,
                         steps: int = 1):
    """K15 on the card: the window ``(Dmax, Ls, Bk)`` after ``steps`` steps
    of ``passes`` operations, as :func:`calibrate_chain_plain` returns."""
    dev = x.device
    _build.check_tensor("x", x, torch.float32, 2, dev)
    Ls, Bk = x.shape
    if min(Dmax, Ls, Bk) < 1 or passes < 0 or steps < 0:
        raise ValueError(f"Dmax {Dmax}, x {tuple(x.shape)}, passes {passes}, "
                         f"steps {steps}")
    if 4 * Dmax * Ls > SMEM_LIMIT:
        raise ValueError(f"Dmax = {Dmax}, Ls = {Ls}: the (Dmax, Ls) window "
                         f"must fit a block's shared memory ({SMEM_LIMIT} "
                         "bytes)")
    window = torch.empty((Dmax, Ls, Bk), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _library().calibrate_chain(
            x.data_ptr(), window.data_ptr(), Dmax, Ls, Bk, passes, steps,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(code, "calibrate launch")
    diagnostics.count(COUNTER)
    return window


def calibrate_chain(x, Dmax: int = 16, passes: int = 16, steps: int = 1):
    """The calibration chain: K15 or its plain version."""
    if kernels.use_kernel(x):
        return calibrate_chain_cuda(x.contiguous(), Dmax, passes, steps)
    return calibrate_chain_plain(x, Dmax, passes, steps)


def _timed_s(fn, device) -> float:
    """Seconds ``fn()`` takes on ``device``: CUDA events, or the host's
    clock for the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def measure(Dmax: int = 16, Ls: int = 48, Bk: int = 128, passes: int = 16,
            frames: int = 32, grid_n: int = 256, reps: int = 5,
            device="cuda", plain_steps: int = 2) -> dict:
    """The elementwise rate in giga-element-operations a second, ``steps *
    passes * Dmax * Ls * Bk / dt / 1e9`` with ``steps = grid_n * frames``
    and ``dt`` one launch's time, and how it was taken.

    Under the kernel (a CUDA device, backend ``auto`` or ``cuda``): ``LO_N``
    and ``HI_N`` launches back to back, each fed slot 0 of the one before,
    between CUDA events; ``dt`` is the slope between the two runs (what is
    constant per run cancels) and the result the median over ``reps``
    slopes.  ``2 + 6`` launches warm it up, ``reps * 8`` are timed.  No
    positive slope in any rep raises.

    Under the plain version (a CPU device, or backend ``torch``): the chain
    is timed once at ``plain_steps`` steps (at full length it would take
    minutes: every operation is a pass over memory) and the record says
    ``"calibration": "plain"``.  That figure describes the plain version on
    that device, never the kernel."""
    device = torch.device(device)
    x = torch.full((Ls, Bk), 0.1, dtype=torch.float32, device=device)
    elems = float(Dmax) * Ls * Bk
    out = {"Dmax": Dmax, "Ls": Ls, "Bk": Bk, "passes": passes,
           "device": str(device)}
    if not kernels.use_kernel(x):
        steps = plain_steps
        calibrate_chain_plain(x, Dmax, passes, 1)                 # warm
        dt = _timed_s(lambda: calibrate_chain_plain(x, Dmax, passes, steps),
                      device)
        out.update(calibration="plain", steps=steps, launches=0,
                   ms_per_launch=dt * 1e3,
                   geps=steps * passes * elems / dt / 1e9)
        return out
    steps = grid_n * frames
    state = {"x": x}

    def run(k):
        for _ in range(k):
            state["x"] = calibrate_chain_cuda(state["x"], Dmax, passes,
                                              steps)[0]

    before = diagnostics.launches().get(COUNTER, 0)
    run(LO_N)
    run(HI_N)
    torch.cuda.synchronize(device)
    slopes = []
    for _ in range(reps):
        lo = _timed_s(lambda: run(LO_N), device)
        hi = _timed_s(lambda: run(HI_N), device)
        dt = (hi - lo) / (HI_N - LO_N)
        if dt > 0:
            slopes.append(dt)
    if not slopes:
        raise RuntimeError("calibrate: no positive slope between "
                           f"{LO_N} and {HI_N} launches in {reps} reps")
    slopes.sort()
    dt = slopes[len(slopes) // 2]        # median: robust to a clock spike
    out.update(calibration="kernel", steps=steps,
               launches=diagnostics.launches()[COUNTER] - before,
               ms_per_launch=dt * 1e3,
               geps=steps * passes * elems / dt / 1e9)
    return out
