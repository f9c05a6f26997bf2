"""host_us.decode: the port's host turn a decode call, in microseconds: the
mean over the traced stretch's replayed calls (``graph.call`` ranges that
hold a ``graph.replay``) of the call's length less its ``graph.replay``
(the graph's launch).  What is left is ``train/graphs.Graphed``'s own
work: the cache key and lookup, the copies into the graph's buffers and
the clones out of it.  The ranges are the program's spans
(``utils.diagnostics``), which open profiler ranges while a profiler
records; a program without them gives nothing.  Moves decode_p95_ms."""


def calls(trace, name="graph.call", child="graph.replay"):
    """``[(start, end, seconds of its ``child`` ranges)]`` of each ``name``
    range of the trace's host ranges that holds a ``child`` range."""
    host = trace["host"]
    parents = sorted((s, t) for n, s, t in host if n == name)
    kids = sorted((s, t) for n, s, t in host if n == child)
    out, j = [], 0
    for s, t in parents:
        while j < len(kids) and kids[j][0] < s:
            j += 1
        inside, k = 0.0, j
        while k < len(kids) and kids[k][1] <= t:
            inside += kids[k][1] - kids[k][0]
            k += 1
        if k > j:
            out.append((s, t, inside))
    return out


def read(ctx):
    got = calls(ctx["trace"])
    if not got:
        return None
    return 1e6 * sum(t - s - r for s, t, r in got) / len(got)
