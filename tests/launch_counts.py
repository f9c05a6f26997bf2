"""Reading the kernels' launch counters (``kernels.*`` in
``asr_craft_tpu_torch.utils.diagnostics``) in the port's tests."""
from asr_craft_tpu_torch.utils import diagnostics


def moved(before: dict) -> dict:
    """The launch counters that moved since ``before`` (a
    ``diagnostics.launches()``), by how much."""
    now = diagnostics.launches()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


def ran(before: dict) -> dict:
    """:func:`moved` by kernel, each kernel's designs summed:
    ``kernels.fdt_viterbi_fwd[cluster]`` counts as ``fdt_viterbi_fwd``."""
    out: dict = {}
    for k, n in moved(before).items():
        name = k[len(diagnostics.LAUNCHES):].split("[")[0]
        out[name] = out.get(name, 0) + n
    return out
