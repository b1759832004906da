"""``bsr_spmv``'s share of its bytes bound: the least time of one
superstep's edge work (``yardstick.work_bytes``, the work's bytes and not
the layout's) over the kernel's device time a launch, in %."""
import yardstick

NEEDS_SESSIONS = True


def read(r):
    s = yardstick.kernel_s(r.sessions, "bsr_spmv")
    if s is None or r.bound_s is None:
        return None
    return 100.0 * r.bound_s / s
