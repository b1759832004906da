"""The window's wall time over the supersteps its queries completed (each
query's supersteps as the runner counts them: to convergence, or the
app's own count, never the predicated tail of a fused chunk)."""


def read(r):
    steps = sum(s for _, s in r.queries)
    return 1e3 * r.window_s / steps if steps else None
