"""The matmul precisions of the model configs: ``highest``, ``bf16x3`` and
``default`` (``CrfConfig.precision``, ``SegCrfConfig.precision``).

The JAX package chooses with them how its products are formed; the
recursions stay IEEE fp32 in every mode.  One meaning per mode across the
port:

- ``highest``: fp32 products (3xTF32 in the tensor-core kernels, which keeps
  fp32 accuracy; TF32 off, the PyTorch default, everywhere else).
- ``bf16x3``: the reference's split (``asr_craft_tpu/kernels/
  fdt_pallas.py`` ``_mm``): each fp32 operand is ``hi = bf16(x)`` (round to
  nearest even) plus ``lo = bf16(x - hi)``, and the product is ``hi.hi +
  hi.lo + lo.hi`` accumulated in fp32.  Every product of two bf16 values is
  exact in fp32, so two implementations differ only in the order of their
  fp32 sums.
- ``default``: one TF32 pass.  JAX's ``Precision.DEFAULT`` on an fp32 dot is
  one TF32 pass on an NVIDIA card, and it is the card's single-pass product
  of fp32 operands.  (On the CPU, where there is no TF32, JAX and PyTorch
  both compute the fp32 product.)

Two kinds of product follow these definitions:

- :func:`kernel_matmul`, the plain version of the fdt product kernels
  (``csrc/fdt_mma.cu``): the operands rounded exactly as the kernel rounds
  them (``default``: to TF32 with ties away, as ``cvt.rna``, by integer
  arithmetic on the bits), their products then exact in fp32, TF32 off.
- :func:`product`, the products the JAX package forms outside Pallas (the
  shared configs' potentials, ``ops.fdt.factored_planes``, the segmental
  frame scores), on either device: ``default`` one ``torch.matmul`` with
  TF32 allowed for that call only, ``bf16x3`` the three split products.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("highest", "bf16x3", "default")
# the kernels' code for each mode (csrc/fdt_common.cuh fdtk::Precision)
CODES = {"highest": 0, "bf16x3": 1, "default": 2}


def check(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{PRECISIONS}")
    return precision


@contextlib.contextmanager
def tf32(allowed: bool):
    """TF32 in cuBLAS products allowed or not inside the block, the
    process-wide flag restored after it (the ``highest`` paths read it)."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = allowed
    try:
        yield
    finally:
        flags.allow_tf32 = before


def round_tf32(x):
    """``x`` (fp32) rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``); infinities and NaN pass."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _bf16(x):
    """``x`` rounded to bf16 (to nearest even), held in fp32, with the
    gradient of the identity: autograd of the cast itself would round the
    incoming gradient to bf16 too.  ``x + (r - x)`` is ``r`` exactly, as
    ``r - x`` is exact for two values this close (and 0 taken where ``x``
    is not finite, so that an infinity stays one)."""
    d = x.detach()
    r = d.to(torch.bfloat16).to(torch.float32)
    if not x.requires_grad:
        return r
    return x + torch.where(torch.isfinite(d), r - d, 0.0)


def split_bf16(x):
    """``(hi, lo)``, fp32 tensors holding bf16 values: ``hi = bf16(x)``,
    ``lo = bf16(x - hi)`` (round to nearest even; ``lo`` is NaN where ``x``
    is infinite, as ``x - hi`` is).  Differentiable: ``hi`` carries the
    gradient, ``lo`` none."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _split3(fn, a, b):
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return fn(ah, bh) + fn(ah, bl) + fn(al, bh)


def kernel_matmul(a, b, precision: str):
    """``a @ b`` as the fdt product kernels form it in ``precision``: the
    plain version the kernels are held to."""
    if check(precision) == "highest":
        return a @ b
    with tf32(False):
        if precision == "default":
            return round_tf32(a) @ round_tf32(b)
        return _split3(torch.matmul, a, b)


def product(fn, a, b, precision: str):
    """``fn(a, b)``, a product bilinear in its two operands (a matmul, an
    einsum), in ``precision``: ``highest`` as it is, ``default`` with TF32
    allowed for this call, ``bf16x3`` as the three split products."""
    if check(precision) == "highest":
        return fn(a, b)
    if precision == "default":
        with tf32(True):
            return fn(a, b)
    with tf32(False):
        return _split3(fn, a, b)
