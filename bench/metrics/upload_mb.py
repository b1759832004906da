"""MB (1e6 B) of the static tree a query makes on the device: the
program's ``bsp.h2d_bytes`` counter over the run's queries."""
import program_obs


def _mb(t):
    n = t["counters"].get("bsp.h2d_bytes")
    return None if n is None else n / 1e6


def read(r):
    return program_obs.per_query(r, _mb)
