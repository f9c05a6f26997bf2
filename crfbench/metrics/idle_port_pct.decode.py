"""idle_port_pct.decode: the share of the device's idle time in the traced
stretch (``harness.idle_gaps``: no kernel, copy or set running) during
which the host was inside one of the port's graph spans (``graph.call``
and its children, a ``graph.warm_up`` or ``graph.capture``), 100 x that
time / the idle time.  The rest of the idle is the caller's: the results'
copies to the host and the loop around the calls.  The ranges are the
program's spans (``utils.diagnostics``); a program without them gives
nothing.  Moves decode_audio_s_per_s."""
from crfbench import harness


def read(ctx):
    tr = ctx["trace"]
    if tr["span_s"] <= 0 or not tr["device"]:
        return None
    port = [(s, t) for n, s, t in tr["host"] if n.startswith("graph.")]
    if not port:
        return None
    gaps = harness.idle_gaps([(s, t) for _, s, t in tr["device"]],
                             tr["span_s"])
    idle = sum(t - s for s, t in gaps)
    if idle <= 0:
        return None
    # the union of the port's ranges, then its overlap with the gaps
    merged = []
    for s, t in sorted(port):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    inside, i = 0.0, 0
    for s, t in gaps:
        while i < len(merged) and merged[i][1] <= s:
            i += 1
        k = i
        while k < len(merged) and merged[k][0] < t:
            inside += min(t, merged[k][1]) - max(s, merged[k][0])
            k += 1
    return 100.0 * inside / idle
