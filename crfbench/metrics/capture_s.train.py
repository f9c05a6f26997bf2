"""capture_s.train: the seconds of set-up that the port's graph runner
spent on the cell's shapes: the self seconds of the set-up spans
``graph.warm_up`` (each shape's eager first call) and ``graph.capture``
(its capture and instantiation), from ``utils.diagnostics.summary()`` in
the run's own process.  Self seconds leave out the child span
``kernels.load`` (the kernels' library loaded, or built, at the first
launch).  A program without the spans gives nothing.  Moves setup_s."""


def read(ctx):
    try:
        from asr_craft_tpu_torch.utils import diagnostics
        spans = diagnostics.summary()["spans"]
    except (ImportError, AttributeError):
        return None
    got = [spans[k]["self_s"] for k in ("graph.warm_up", "graph.capture")
           if k in spans]
    return sum(got) if got else None
