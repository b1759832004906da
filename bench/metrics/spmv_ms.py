"""Device ms of a ``bsr_spmv`` launch: the mean of its profiler events in
whole sessions of one query (``yardstick.profile_calls``)."""
import yardstick

NEEDS_SESSIONS = True


def read(r):
    s = yardstick.kernel_s(r.sessions, "bsr_spmv")
    return None if s is None else 1e3 * s
