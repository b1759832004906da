"""The benchmark's yardstick: the H100's published peak, the bytes that a
superstep's edge work needs, whole profiler sessions, and the reduction of
a profiler trace to busy time, idle gaps and device time by operation.

Later changes to the program leave these alone, so a metric means the same
before and after them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

#: H100 SXM's published HBM3 bandwidth (NVIDIA data sheet, at the full
#: 700 W power limit); a roofline share is stated against it, with the
#: card's power limit beside it
HBM_BYTES_PER_S = 3.35e12

#: bytes of a column id of the work count
INDEX_BYTES = 4

#: what a profiler session runs before and after the profiled calls: spin
#: kernels of ``SPIN_CYCLES`` clock cycles each, then the host's wait
SPIN_KERNELS, SPIN_CYCLES, SPIN_HOST_S = 64, 50_000, 0.02

#: kernel names and host operations are cut to this length in a breakdown
NAME_CHARS = 120

#: entries of each list of a breakdown
BREAKDOWN_ENTRIES = 10

#: the prefix of the harness's own ``record_function`` spans; the profiler
#: also gives each a device-side annotation, which is no device work
SPAN_PREFIX = "bench."


def work_bytes(edges: np.ndarray, assign: np.ndarray, p: int,
               message_bytes: int) -> int:
    """Bytes one superstep's edge work needs on an edge partition: for each
    machine, each local directed edge's operand and column id once, and x
    and y once over the largest machine's vertex count, at the message
    dtype.  The count is the same whatever layout or kernel does the
    work."""
    assign = np.asarray(assign, dtype=np.int64)
    edges_per = np.bincount(assign, minlength=p)
    member = np.zeros((p, int(edges.max()) + 1), dtype=bool)
    member[assign, edges[:, 0]] = True
    member[assign, edges[:, 1]] = True
    vmax = int(member.sum(axis=1).max())
    return int(2 * edges_per.sum() * (message_bytes + INDEX_BYTES)
               + p * 2 * vmax * message_bytes)


def bound_s(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S


# ---------------------------------------------------------------------------
# whole profiler sessions (as the repository's chip_smoke.py takes them)
# ---------------------------------------------------------------------------

def is_device_event(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def spin(scale: int = 1) -> None:
    """Pad a profiler window: ``scale`` times ``SPIN_KERNELS`` spin
    kernels, then the host waits ``scale`` times ``SPIN_HOST_S``."""
    for _ in range(SPIN_KERNELS * scale):
        torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize()
    time.sleep(SPIN_HOST_S * scale)


def device_events(prof) -> list:
    """Device events by kernel (``key_averages``), the spin kernels left
    out."""
    return [e for e in prof.key_averages() if is_device_event(e)
            and "spin_kernel" not in e.key]


def profile_calls(fn, reps: int, attempts: int = 5):
    """Device time by kernel over ``reps`` calls of ``fn()``, after one
    warm-up call, from a whole torch.profiler session.

    The launches of the first milliseconds after the profiler starts can
    go unrecorded, the same in every session of a process late in its
    run, so spin kernels and a host wait pad each session, twice as long
    in each session taken again.  A session is whole when every kernel's
    count of events is a multiple of ``reps`` and an earlier session kept
    the same counts; one that is not is taken again, up to ``attempts``
    sessions.  Returns ``{kernel name: (events a call, device seconds an
    event)}`` of the whole session, or None if no session was whole."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            spin(2 ** attempt)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            spin(2 ** attempt)
        events = device_events(prof)
        counts = {e.key: e.count for e in events}
        whole = (bool(counts) and all(c % reps == 0 for c in counts.values())
                 and counts in seen)
        seen.append(counts)
        if whole:
            return {e.key: (e.count / reps,
                            e.self_device_time_total / e.count / 1e6)
                    for e in events}
    return None


def kernel_s(sessions: dict | None, key: str) -> float | None:
    """Device seconds a launch of the kernels whose name holds ``key``, in
    ``profile_calls``' sessions; None where they saw none."""
    if not sessions:
        return None
    mine = [(calls, s) for name, (calls, s) in sessions.items()
            if key in name]
    launches = sum(c for c, _ in mine)
    return sum(c * s for c, s in mine) / launches if launches else None


# ---------------------------------------------------------------------------
# a traced window
# ---------------------------------------------------------------------------

def _merged(intervals: np.ndarray) -> np.ndarray:
    """Union of (k, 2) [start, end) intervals, sorted and disjoint."""
    if not len(intervals):
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.float64)


def _host_op_at(t: float, starts: np.ndarray, ends: np.ndarray,
                names: list, lookback: int = 256) -> str:
    """The innermost host operation running at ``t`` (the latest-started
    one that covers it), or ``python`` where none does."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(-1, i - lookback), -1):
        if ends[j] >= t:
            return names[j]
    return "python"


def reduce_trace(events, window: tuple[float, float]) -> dict:
    """Busy and idle time of the device within ``window`` (microseconds
    on the profiler's clock), from a profile's events.

    Returns ``busy_s`` (the union of device operations' intervals, the
    annotations of the harness's spans left out),
    ``window_s``, ``device_ops`` (device seconds by operation, the
    largest ``BREAKDOWN_ENTRIES``) and ``idle_gaps`` (idle device seconds
    by the host operation running in the middle of each gap, the largest
    ``BREAKDOWN_ENTRIES``)."""
    w0, w1 = window
    dev, host, host_names, by_op = [], [], [], {}
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if is_device_event(e) and e.name.startswith(SPAN_PREFIX):
            continue
        if is_device_event(e):
            if t <= w0 or s >= w1:
                continue
            s, t = max(s, w0), min(t, w1)
            dev.append((s, t))
            name = e.name[:NAME_CHARS]
            by_op[name] = by_op.get(name, 0.0) + (t - s) / 1e6
        elif t > w0 and s < w1:
            host.append((s, t))
            host_names.append(e.name[:NAME_CHARS])
    busy = _merged(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
    busy_us = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    order = np.argsort([h[0] for h in host], kind="stable")
    starts = np.asarray([host[i][0] for i in order], dtype=np.float64)
    ends = np.asarray([host[i][1] for i in order], dtype=np.float64)
    names = [host_names[i] for i in order]
    gaps: dict = {}
    for a, b in edges:
        if b > a:
            op = _host_op_at((a + b) / 2, starts, ends, names)
            gaps[op] = gaps.get(op, 0.0) + (b - a) / 1e6
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": top(by_op), "idle_gaps": top(gaps)}
