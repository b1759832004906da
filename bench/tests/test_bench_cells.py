"""Each cell's run, at a small size on the CPU: sound runs come out
correct; the control (bfloat16 messages) and each fault the cell can have,
planted under the timed path, come out not correct."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import BENCH, run_small

CELLS = [w["name"] for w in json.loads(
    (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_small(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s"}
    assert list(out)[-1] == "checks"


#: mixes that a later cell could add as a traffic file alone: (kind, the
#: file's app, args and weights); each runs on the first cell's graph
MIXES = {
    "sssp-pallas-fused": ("app", {
        "app": "sssp", "source": "random", "weights": "uniform",
        "args": {"num_iters": 256, "backend": "pallas", "fused": True}}),
    "sssp-scatter-stepwise": ("app", {
        "app": "sssp", "source": "random", "weights": "uniform",
        "args": {"num_iters": 256, "backend": "scatter"}}),
    "bfs-pallas": ("app", {
        "app": "bfs", "source": "random", "weights": "unit",
        "args": {"num_iters": 64, "backend": "pallas", "fused": True}}),
    "cc-scatter": ("app", {
        "app": "connected_components", "weights": "unit",
        "args": {"num_iters": 64, "backend": "scatter"}}),
    "pagerank-tol": ("app", {
        "app": "pagerank", "weights": "unit",
        "args": {"num_iters": 200, "backend": "pallas", "tol": 1e-9}}),
    "job-sssp": ("partition_job", {
        "app": "sssp", "source": "random", "weights": "uniform", "graphs": 2,
        "args": {"num_iters": 256, "backend": "scatter", "fused": True}}),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_mix_added_as_data_alone_runs_correct(mix):
    import harness
    from conftest import small_cell
    kind, traffic = MIXES[mix]
    cell = small_cell(CELLS[0])
    cell.traffic = dict(traffic, query=kind, compare=4)
    number = harness.Query.of(cell.traffic).number
    cell.limits = {number: 1e-4, "assign_violations": 0}
    out = harness.run_cell(cell, 2 ** 31 + 5, 0.3, False, 0.0, device="cpu")
    assert out["correct"], out["checks"]
    assert out["checks"][number]["value"] < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_control_bfloat16_messages_fails(name):
    out = run_small(name, overrides={"message_dtype": "bfloat16"})
    assert not out["correct"], out["checks"]


def _no_exchange(monkeypatch):
    import repro_torch.bsp.backends as backends
    monkeypatch.setattr(backends, "exchange",
                        lambda partial, *a, **k: partial)


def _half_the_machines(monkeypatch):
    """The second half of the machines' edge work left out."""
    import repro_torch.bsp.apps as apps
    resolve = apps._resolve

    def halved(rt, backend, semiring, *a, **k):
        eb, static, combine = resolve(rt, backend, semiring, *a, **k)
        none = float("inf") if semiring == "min_plus" else 0.0

        def combine_half(sa, x):
            y = combine(sa, x).clone()
            y[y.shape[0] // 2:] = none
            return y
        return eb, static, combine_half

    monkeypatch.setattr(apps, "_resolve", halved)


def _state_unchanged(monkeypatch):
    import repro_torch.bsp.apps as apps
    for name in ("run_bsp", "run_bsp_fused"):
        run = getattr(apps, name)
        monkeypatch.setattr(
            apps, name, lambda step, state, static, n, _run=run, **k:
            (state, _run(step, state, static, n, **k)[1]))


def _answer_altered(monkeypatch):
    from repro_torch.bsp import PartitionRuntime
    gather = PartitionRuntime.gather_global

    def altered(self, *a, **k):
        out = gather(self, *a, **k)
        v = np.flatnonzero(np.isfinite(out) & (out > 0))[0]
        out[v] += out[v] + 1.0
        return out

    monkeypatch.setattr(PartitionRuntime, "gather_global", altered)


def _assignment_altered(monkeypatch):
    """Every edge placed on the first machine, past its memory cap."""
    import repro_torch.core as core
    windgp = core.windgp

    def one_machine(*a, **k):
        res = windgp(*a, **k)
        return dataclasses.replace(res, assign=np.zeros_like(res.assign))

    monkeypatch.setattr(core, "windgp", one_machine)


FAULTS = {"exchange_left_out": _no_exchange,
          "half_the_machines_left_out": _half_the_machines,
          "state_unchanged": _state_unchanged,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_under_the_timed_path_fails(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert not run_small(name)["correct"]


def run_partition_jobs() -> dict:
    """The partition job's traffic file on the first cell's graph, small:
    WindGP, the pack, PageRank and the caps checked on every job."""
    import time

    import harness
    from conftest import SMALL_GRAPHS, SMALL_SECONDS, small_cell
    cell = small_cell(CELLS[0])
    cell.traffic = dict(json.loads(
        (BENCH / "traffic" / "partition-windgp-pagerank.json").read_text()),
        graphs=SMALL_GRAPHS)
    cell.limits = {"pagerank_rel_err": 1e-4, "assign_violations": 0}
    return harness.run_cell(cell, 2 ** 31 + 11, SMALL_SECONDS, False,
                            time.perf_counter(), device="cpu")


def test_partition_jobs_run_correct():
    out = run_partition_jobs()
    assert out["correct"], out["checks"]
    assert out["checks"]["assign_violations"]["value"] == 0


def test_assignment_past_the_caps_fails(monkeypatch):
    _assignment_altered(monkeypatch)
    out = run_partition_jobs()
    assert not out["correct"]
    assert out["checks"]["assign_violations"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, cuda_device):
    assert run_small(name, device=cuda_device)["correct"]
    control = run_small(name, device=cuda_device,
                        overrides={"message_dtype": "bfloat16"})
    assert not control["correct"]
    torch.cuda.empty_cache()
