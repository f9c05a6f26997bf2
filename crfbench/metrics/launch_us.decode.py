"""launch_us.decode: the mean length, in microseconds, of the traced
stretch's ``graph.replay`` ranges: the host's launch of a decode's CUDA
graph (``cudaGraphLaunch``), whose cost grows with the graph's node count
(the counter ``graph.nodes``).  The ranges are the program's spans
(``utils.diagnostics``); a program without them gives nothing.  Moves
decode_p95_ms."""


def read(ctx):
    got = [t - s for n, s, t in ctx["trace"]["host"] if n == "graph.replay"]
    if not got:
        return None
    return 1e6 * sum(got) / len(got)
