"""Semirings of the port's dynamic programs.

Counterpart of :mod:`asr_craft_tpu.ops.semiring`, the same names: one
recursion written against ``(sum, prod, zero, one)`` runs sum-product in
log space (training) or max-product (Viterbi score, the time-sharded
decode).

``LOG``       : (logsumexp, +, NEG_INF, 0)
``TROPICAL``  : (max,       +, NEG_INF, 0)

All potentials are natural-log scores.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# Finite stand-in for -inf, equal to the JAX package's: NEG_INF + NEG_INF
# stays finite (-2e30), so masked entries never produce inf - inf = nan and
# masks agree bit for bit with the reference.
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A commutative semiring over log-domain scores.  ``sum(x, dim=None,
    keepdim=False)`` reduces; ``prod`` is ordinary ``+`` and ``one`` is 0.0
    for both semirings, fixed rather than parameterized, as in the JAX
    package."""

    name: str
    sum: Callable[..., torch.Tensor]
    zero: float

    def prod(self, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    @property
    def one(self) -> float:
        return 0.0


def _all_dims(x, dim):
    return tuple(range(x.dim())) if dim is None else dim


def _logsumexp(x, dim=None, keepdim=False):
    """Max-subtracted logsumexp whose max is clamped at NEG_INF
    (``m_safe = max(m, NEG_INF)``), so an all-NEG_INF slice stays at
    NEG_INF with zero gradient."""
    dim = _all_dims(x, dim)
    m = torch.clamp(torch.amax(x, dim=dim, keepdim=True), min=NEG_INF)
    out = m + torch.log(torch.sum(torch.exp(x - m), dim=dim, keepdim=True))
    if not keepdim:
        out = out.squeeze(dim)
    return out


def _max(x, dim=None, keepdim=False):
    return torch.amax(x, dim=_all_dims(x, dim), keepdim=keepdim)


LOG = Semiring(name="log", sum=_logsumexp, zero=NEG_INF)
TROPICAL = Semiring(name="tropical", sum=_max, zero=NEG_INF)

SEMIRINGS = {"log": LOG, "tropical": TROPICAL}


def get_semiring(name_or_sr) -> Semiring:
    if isinstance(name_or_sr, Semiring):
        return name_or_sr
    return SEMIRINGS[name_or_sr]


def matvec(sr: Semiring, trans, vec):
    """Semiring ``vec @ trans``: ``out[l] = sum_p(vec[p] + trans[p, l])``.
    ``trans (L, L)``, ``vec (L,)``; returns ``(L,)``."""
    return sr.sum(vec[:, None] + trans, dim=0)


def matmul(sr: Semiring, a, b):
    """Semiring matrix product: ``out[i, j] = sum_k(a[i, k] + b[k, j])``,
    ``(L, L) x (L, L) -> (L, L)``.  Associative: the building block of the
    time-sharded recursions (:mod:`asr_craft_tpu_torch.parallel`)."""
    return sr.sum(a[:, :, None] + b[None, :, :], dim=1)
