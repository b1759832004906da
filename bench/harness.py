"""One run of one cell: set-up, a closed loop of queries or jobs for the
window, the readings, and the comparison that decides ``correct``.

Everything is found by name:

* the cell, its configuration and its metrics in ``BENCHMARK.json``;
* the configuration's sizes in the file ``BENCHMARK.json`` names, and its
  graph's generator in ``generators/<generator>.py``;
* the traffic mix in ``traffic/<traffic>.json``;
* the limits of the comparison in ``limits/<cell>.json``;
* each metric's reader in ``metrics/<metric>.py``, or where there is no
  such file in ``metrics/<part of the name before its first dot>.py``: a
  function ``read(readings)`` that returns the number, or None where the
  run has nothing for it to read;
* a query's program call, ``repro_torch.bsp.apps.<app>``, and its plain
  reference, ``references/<app>.py``, by the app's name in the traffic.

A traffic mix is one of two kinds.  ``"query": "app"`` sends one client's
queries of a BSP app, each after the last has returned, on a graph that
set-up partitions and packs once.  ``"query": "partition_job"`` runs the
whole partition job in a loop over graphs that set-up makes: WindGP, the
pack, the app, and freeing the runtime.  Either names the app
(``"app"``), the keyword arguments of its call (``"args"``, handed to the
program's app and to its reference alike), the edge weights
(``"weights"``: ``"unit"`` or ``"uniform"``, drawn from the seed), and
with ``"source": "random"`` a source vertex for each query, drawn from the
seed among the vertices with an edge.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import importlib.util
import itertools
import json
import pathlib
import sys
import time
import traceback

import numpy as np

import reference
import yardstick

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent

#: the longest window that a ``--trace 1`` run traces
TRACE_WINDOW_S = 10.0
#: calls of a query in each whole profiler session
SESSION_REPS = 3
#: independent streams drawn from a run's seed
WEIGHT_STREAM, SOURCE_STREAM, ORDER_STREAM, SAMPLE_STREAM = 1, 2, 3, 4
#: bytes of each message dtype
MESSAGE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


@dataclasses.dataclass
class Cell:
    """A cell as ``BENCHMARK.json`` and its data files give it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Outcome:
    """A run's readings, its comparison's numbers, the queries or jobs
    attempted, those that failed (raised, or passed a limit), the answers
    compared, and the peak of device memory."""

    readings: "Readings"
    checks: dict
    attempted: int
    failed: int
    compared: int
    peak: int


@dataclasses.dataclass
class Readings:
    """What a run gives the metric readers.

    ``queries``: (seconds, supersteps) of each query the window completed;
    ``jobs``: the span seconds of each job it completed; ``bound_s``: the
    least time of one superstep's edge work (``yardstick.work_bytes`` at
    the peak), None for jobs; ``trace``: ``yardstick.reduce_trace`` of the
    traced window; ``sessions``: ``yardstick.profile_calls`` of one query.
    """

    setup_s: float
    window_s: float
    queries: list
    jobs: list
    bound_s: float | None
    peak_window_bytes: int
    trace: dict | None = None
    sessions: dict | None = None


def load_module(path: pathlib.Path):
    """Import a benchmark file by its path (its name may hold dots)."""
    name = "bench_" + "".join(c if c.isalnum() else "_"
                              for c in str(path.relative_to(BENCH)))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _named(entries: list, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named "
                       f"{name!r}")
    return found[0]


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell named ``workload``, with its files read."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = _named(spec["workloads"], workload, "workloads")
    cfg = _named(spec["configs"], wl["config"], "configs")
    applies = lambda m: workload in m.get("workloads", [workload])
    return Cell(
        name=workload, chips=int(wl["chips"]),
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{wl['traffic']}.json")
                           .read_text()),
        limits=json.loads((BENCH / "limits" / f"{workload}.json")
                          .read_text()),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def reader(name: str):
    """The reader of the metric ``name``: ``metrics/<name>.py``, or that
    of the part of the name before its first dot."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path)


def read_metrics(metrics: list, readings: Readings) -> dict:
    """Each metric its reader finds something for, with its unit."""
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def needs_sessions(metrics: list) -> bool:
    """Whether a metric of the run reads whole profiler sessions."""
    return any(getattr(reader(m["name"]), "NEEDS_SESSIONS", False)
               for m in metrics)


# ---------------------------------------------------------------------------
# graphs, weights and the cluster, as both sides get them
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Instance:
    """One graph: its canonical edges, vertex count, edge weights (None
    for unit weights) and machines, and the program's view of them."""

    edges: np.ndarray
    n: int
    weights: np.ndarray | None
    machines: list
    graph: object = None
    cluster: object = None


def make_instance(config: dict, graph_seed: int,
                  weights_rng: np.random.Generator | None) -> Instance:
    from repro_torch.core import Cluster, Machine, from_edge_list

    gen = load_module(BENCH / "generators" / f"{config['generator']}.py")
    raw, n = gen.make(config, graph_seed)
    edges = reference.canonical(raw, n)
    weights = None if weights_rng is None else weights_rng.random(
        len(edges), dtype=np.float32)
    machines = reference.cluster_machines(config["cluster"], len(edges))
    g = from_edge_list(edges, num_vertices=n)
    if not np.array_equal(g.edges, edges):
        raise RuntimeError("the program's graph orders its edges otherwise "
                           "than the benchmark's: the weights would not "
                           "line up")
    cl = Cluster(machines=tuple(Machine(*m) for m in machines),
                 m_node=config["cluster"]["m_node"],
                 m_edge=config["cluster"]["m_edge"])
    return Instance(edges, n, weights, machines, g, cl)


@dataclasses.dataclass
class Query:
    """A traffic mix's query: the program's ``apps.<app>`` called with
    ``args`` (and a source vertex where ``sourced``), on edges of
    ``weights``, and its reference ``references/<app>.py``: a function
    ``expected(edges, n, weights, source, args, device)``, and optionally
    ``gap(got, want)`` and the name ``NUMBER`` of the compared number
    (by default ``reference.rel_err`` and ``<app>_rel_err``)."""

    app: str
    args: dict
    weights: str
    sourced: bool

    @classmethod
    def of(cls, traffic: dict, overrides: dict | None = None) -> "Query":
        if traffic["weights"] not in ("unit", "uniform"):
            raise ValueError(f"weights must be 'unit' or 'uniform', got "
                             f"{traffic['weights']!r}")
        args = dict(traffic["args"], **(overrides or {}))
        return cls(traffic["app"], args, traffic["weights"],
                   traffic.get("source") == "random")

    @functools.cached_property
    def ref(self):
        return load_module(BENCH / "references" / f"{self.app}.py")

    @property
    def number(self) -> str:
        return getattr(self.ref, "NUMBER", f"{self.app}_rel_err")

    @property
    def message_bytes(self) -> int:
        return MESSAGE_BYTES[self.args.get("message_dtype", "float32")]

    def weights_rng(self, seed: int):
        if self.weights == "unit":
            return None
        return np.random.default_rng([seed, WEIGHT_STREAM])

    def sources(self, inst: Instance, seed: int):
        """Endless source vertices drawn from the seed among those with an
        edge; None each where the app takes no source."""
        if not self.sourced:
            return itertools.repeat(None)
        has_edge = np.zeros(inst.n, dtype=bool)
        has_edge[inst.edges.ravel()] = True
        candidates = np.flatnonzero(has_edge)
        rng = np.random.default_rng([seed, SOURCE_STREAM])
        return (int(candidates[rng.integers(len(candidates))])
                for _ in itertools.count())

    def run(self, rt, source):
        """One query; returns ((V,) result, supersteps run)."""
        from torch.profiler import record_function

        from repro_torch.bsp import apps

        head = () if source is None else (source,)
        with record_function("bench.app"):
            out, act = getattr(apps, self.app)(rt, *head, **self.args)
        return out, len(act)

    def expected(self, inst: Instance, source, device) -> np.ndarray:
        """The reference's answer to a query."""
        return self.ref.expected(inst.edges, inst.n, inst.weights, source,
                                 self.args, device)

    def gap(self, got, want) -> float:
        return getattr(self.ref, "gap", reference.rel_err)(got, want)


def partition(inst: Instance, config: dict, device):
    """WindGP and the pack: ((E,) assignment, runtime, span seconds)."""
    from torch.profiler import record_function

    from repro_torch.bsp import PartitionRuntime
    from repro_torch.core import windgp

    t0 = time.perf_counter()
    with record_function("bench.windgp"):
        assign = windgp(inst.graph, inst.cluster, **config["windgp"]).assign
    t1 = time.perf_counter()
    with record_function("bench.pack"):
        rt = PartitionRuntime.create(inst.graph, assign=assign,
                                     cluster=inst.cluster,
                                     edge_weights=inst.weights, device=device)
    return assign, rt, {"windgp_s": t1 - t0,
                        "pack_s": time.perf_counter() - t1}


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """A closed loop that runs ``step()`` until ``seconds`` have passed,
    under torch.profiler when traced; ``step`` returns False to stop."""

    def __init__(self, seconds: float, traced: bool, device):
        self.seconds = min(seconds, TRACE_WINDOW_S) if traced else seconds
        self.traced, self.device = traced, device
        self.trace = None
        self.wall_s = 0.0

    def run(self, step) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        _sync(self.device)
        if self.traced:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        t0 = time.perf_counter()
        with record_function("bench.window"):
            while time.perf_counter() - t0 < self.seconds:
                if not step():
                    break
            _sync(self.device)
        self.wall_s = time.perf_counter() - t0
        if self.traced:
            prof.stop()
            events = prof.events()
            marks = [e for e in events if e.name == "bench.window"]
            window = (float(marks[0].time_range.start),
                      float(marks[0].time_range.end))
            self.trace = yardstick.reduce_trace(events, window)


def _query_loop(rt, query: Query, sources, window: Window, results: list,
                queries: list) -> int:
    """Queries until the window closes; returns the failures (0 or 1: the
    loop stops at the first)."""
    failed = [0]

    def step() -> bool:
        source = next(sources)
        t0 = time.perf_counter()
        try:
            out, steps = query.run(rt, source)
        except (RuntimeError, ValueError):
            traceback.print_exc(file=sys.stderr)
            failed[0] += 1
            return False
        queries.append((time.perf_counter() - t0, steps))
        results.append((source, out, steps))
        return True

    window.run(step)
    return failed[0]


def _free(device) -> None:
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _peak(device, reset: bool = False) -> int:
    """Bytes allocated at the peak since the last reset (0 off the card);
    ``reset`` starts a new count after reading."""
    import torch
    if torch.device(device).type != "cuda":
        return 0
    peak = int(torch.cuda.max_memory_allocated(device))
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def app_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, query: Query) -> Outcome:
    """Closed-loop queries on one partitioned graph."""
    config = cell.config
    inst = make_instance(config, config["graph_seed"],
                         query.weights_rng(seed))
    assign, rt, _ = partition(inst, config, device)
    sources = query.sources(inst, seed)
    query.run(rt, next(sources))                     # warm-up
    _sync(device)
    setup_s = time.perf_counter() - t_start

    window = Window(seconds, traced, device)
    results, queries = [], []
    peak_setup = _peak(device, reset=True)
    failed = _query_loop(rt, query, sources, window, results, queries)
    peak_window = _peak(device)
    sessions = None
    if traced and needs_sessions(cell.per_layer) and results:
        first = results[0][0]
        sessions = yardstick.profile_calls(lambda: query.run(rt, first),
                                           SESSION_REPS)
    peak = max(peak_setup, _peak(device))
    nbytes = yardstick.work_bytes(inst.edges, assign, len(inst.machines),
                                  query.message_bytes)
    del rt
    inst.graph = inst.cluster = None
    _free(device)

    checks, compared, over = compare_queries(cell, inst, query, results,
                                             seed, device)
    readings = Readings(setup_s=setup_s, window_s=window.wall_s,
                        queries=queries, jobs=[],
                        bound_s=yardstick.bound_s(nbytes),
                        peak_window_bytes=peak_window, trace=window.trace,
                        sessions=sessions)
    return Outcome(readings, checks, len(queries) + failed, failed + over,
                   compared, peak)


def compare_queries(cell: Cell, inst: Instance, query: Query, results: list,
                    seed: int, device) -> tuple[dict, int, int]:
    """The widest gap of the compared answers, how many were compared, and
    how many passed their limit.  ``compare`` in the traffic mix is
    ``"all"`` or a count: a sample drawn from the seed, with the query of
    most supersteps in it."""
    want = cell.traffic["compare"]
    idx = list(range(len(results)))
    if want != "all" and len(idx) > int(want):
        rng = np.random.default_rng([seed, SAMPLE_STREAM])
        longest = max(idx, key=lambda i: results[i][2])
        rest = [i for i in idx if i != longest]
        idx = [longest] + sorted(rng.choice(rest, int(want) - 1,
                                            replace=False).tolist())
    key = query.number
    limit = cell.limits[key]
    worst, over, cache = 0.0, 0, {}
    for i in idx:
        source, got, _ = results[i]
        if source not in cache:
            cache[source] = query.expected(inst, source, device)
        err = query.gap(got, cache[source])
        worst = max(worst, err)
        over += err > limit
    return {key: {"value": worst, "limit": limit}}, len(idx), over


def job_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, query: Query) -> Outcome:
    """Closed-loop partition jobs over the graphs that set-up makes."""
    config, traffic = cell.config, cell.traffic
    count = int(traffic["graphs"])
    rng = query.weights_rng(seed)
    insts = [make_instance(config, config["graph_seed"] + k, rng)
             for k in range(count)]
    sources = [next(query.sources(inst, seed)) for inst in insts]
    order = np.random.default_rng([seed, ORDER_STREAM]).permutation(count)
    outputs, jobs = [], []

    def job(k: int) -> dict:
        t0 = time.perf_counter()
        assign, rt, spans = partition(insts[k], config, device)
        t1 = time.perf_counter()
        out, steps = query.run(rt, sources[k])
        rt.clear_bsr_cache()
        del rt
        spans.update(run_s=time.perf_counter() - t1,
                     total_s=time.perf_counter() - t0, supersteps=steps,
                     graph=k)
        outputs.append((k, assign, out))
        return spans

    job(int(order[0]))                               # warm-up
    outputs.clear()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    window = Window(seconds, traced, device)
    failed = [0]

    def step() -> bool:
        k = int(order[(len(jobs) + 1) % count])
        try:
            jobs.append(job(k))
        except (RuntimeError, ValueError):
            traceback.print_exc(file=sys.stderr)
            failed[0] += 1
            return False
        return True

    peak_setup = _peak(device, reset=True)
    window.run(step)
    peak_window = _peak(device)
    peak = max(peak_setup, peak_window)
    for spans in jobs:
        print("job " + " ".join(f"{key} {value:.4f}" if isinstance(value, float)
                                else f"{key} {value}"
                                for key, value in spans.items()),
              file=sys.stderr)
    for inst in insts:
        inst.graph = inst.cluster = None
    _free(device)

    violations, worst, over, refs = 0, 0.0, 0, {}
    limit = cell.limits[query.number]
    for k, assign, out in outputs:
        inst = insts[k]
        bad = reference.assignment_violations(
            assign, inst.edges, inst.n, inst.machines,
            config["cluster"]["m_node"], config["cluster"]["m_edge"])
        if k not in refs:
            refs[k] = query.expected(inst, sources[k], device)
        err = query.gap(out, refs[k])
        violations += bad
        worst = max(worst, err)
        over += bool(bad) or err > limit
    checks = {"assign_violations": {"value": violations,
                                    "limit": cell.limits["assign_violations"]},
              query.number: {"value": worst, "limit": limit}}
    readings = Readings(setup_s=setup_s, window_s=window.wall_s, queries=[],
                        jobs=jobs, bound_s=None,
                        peak_window_bytes=peak_window, trace=window.trace)
    return Outcome(readings, checks, len(jobs) + failed[0], failed[0] + over,
                   len(outputs), peak)


KINDS = {"app": app_cell, "partition_job": job_cell}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda", overrides: dict | None = None
             ) -> dict:
    """One run: the result's fields, the comparison's numbers last.

    ``overrides`` replaces keyword arguments of the traffic's app call
    (the control's lower message precision)."""
    query = Query.of(cell.traffic, overrides)
    out = KINDS[cell.traffic["query"]](cell, seed, seconds, traced, device,
                                       t_start, query)
    correct = (out.failed == 0 and out.attempted > 0 and out.compared > 0
               and all(c["value"] <= c["limit"]
                       for c in out.checks.values()))
    metrics = read_metrics(cell.per_layer if traced else cell.end_to_end,
                           out.readings)
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": device_info(device, cell.chips, out.peak),
              "compared": out.compared}
    if traced:
        trace = out.readings.trace
        result["device"].update(busy_s=trace["busy_s"],
                                window_s=trace["window_s"])
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = out.checks
    return result


def device_info(device, chips: int, peak: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}
