"""Semiring constants shared by the port's dynamic programs.

Counterpart of :mod:`asr_craft_tpu.ops.semiring`.  Only the constant is
needed so far: the max-plus decode is written out in ``ops.fdt``.
"""

# Finite stand-in for -inf, equal to the JAX package's: NEG_INF + NEG_INF
# stays finite (-2e30), so masked entries never produce inf - inf = nan and
# masks agree bit for bit with the reference.
NEG_INF = -1e30
