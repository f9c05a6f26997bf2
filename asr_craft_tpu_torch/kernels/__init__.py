"""Hand-written CUDA kernels for Hopper (sm_90a) and their dispatch.

Counterpart of :mod:`asr_craft_tpu.kernels`.  The backend is one of

- ``"auto"`` (default): the kernel for CUDA tensors, the plain PyTorch
  version for CPU tensors.  There is no other rule, and no fallback: a CUDA
  tensor the kernel refuses raises.
- ``"cuda"``: always the kernel; a CPU tensor raises.
- ``"torch"``: always the plain PyTorch version, on either device.

The sources live in ``asr_craft_tpu_torch/csrc`` and are built with nvcc at
first use (:mod:`asr_craft_tpu_torch.kernels._build`).  One module per
family, each with its kernels' wrappers, plain versions and launch counts:
``fdt_viterbi`` (K3), ``fdt_train`` (K1, K2), ``viterbi`` (K7, K8),
``fwdbwd`` (K4, K5, K6a, K6b, K14) and ``segmental`` (K9-K13).
"""
from __future__ import annotations

BACKENDS = ("auto", "cuda", "torch")
_BACKEND = "auto"


def set_backend(name: str) -> None:
    """Select the kernel backend for this process: one of ``BACKENDS``."""
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(f"kernel backend {name!r} not in {BACKENDS}")
    _BACKEND = name


def use_kernel(tensor) -> bool:
    """Whether the kernel (True) or the plain version (False) serves
    ``tensor`` under the selected backend."""
    if _BACKEND == "auto":
        return tensor.is_cuda
    return _BACKEND == "cuda"
