"""The whole superstep's share of its bytes bound: the least time of the
supersteps the traced window completed (``yardstick.work_bytes`` over the
HBM peak) over the window's wall time, in %."""


def read(r):
    steps = sum(s for _, s in r.queries)
    if not steps or r.bound_s is None:
        return None
    return 100.0 * r.bound_s * steps / r.window_s
