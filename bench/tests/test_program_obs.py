"""The readers of the program's spans and counters (``program_obs``), and
a harness that runs as before where the program has no
``repro_torch.obs``."""
import json
import sys
import time

import pytest

import harness
import program_obs
from conftest import BENCH, SMALL_SECONDS, run_small, small_cell

CELL = json.loads((BENCH.parent / "BENCHMARK.json").read_text())[
    "workloads"][0]["name"]
#: the readers of the program's spans and counters
PROGRAM_METRICS = ["windgp_s", "pack_s", "layout_host_s", "layout_device_s",
                   "prepare_ms", "upload_mb"]


@pytest.fixture
def fresh_obs(monkeypatch):
    """The program's totals as in a process that has run nothing yet."""
    from repro_torch import obs
    monkeypatch.setattr(obs, "_spans", {})
    monkeypatch.setattr(obs, "_counters", {})
    return obs


def _readings(traced=True, queries=1):
    return harness.Readings(setup_s=1.0, window_s=1.0,
                            queries=[(0.1, 20)] * queries, jobs=[],
                            bound_s=None, peak_window_bytes=0,
                            trace={} if traced else None)


def _record(obs, name, count, total_ns, self_ns=None):
    obs._spans[name] = [count, total_ns, total_ns if self_ns is None
                        else self_ns]


def test_per_query_readings(fresh_obs):
    """The self time of ``bsp.prepare`` (less its layout spans) and the
    bytes uploaded, over the queries, one ``bsp.prepare`` each."""
    _record(fresh_obs, "bsp.prepare", 4, 3 * 10 ** 7, 2 * 10 ** 7)
    fresh_obs.count("bsp.h2d_bytes", 8_000_000)
    r = _readings()
    assert harness.reader("prepare_ms").read(r) == pytest.approx(5.0)
    assert harness.reader("upload_mb").read(r) == pytest.approx(2.0)


def test_nothing_read_untraced(fresh_obs):
    _record(fresh_obs, "bsp.prepare", 2, 10 ** 7)
    _record(fresh_obs, "windgp", 1, 10 ** 9)
    fresh_obs.count("bsp.h2d_bytes", 8)
    for m in ["windgp_s", "prepare_ms", "upload_mb"]:
        assert harness.reader(m).read(_readings(traced=False)) is None, m
    # a traced run whose window completed no query: no per-query reading
    assert harness.reader("prepare_ms").read(_readings(queries=0)) is None
    assert harness.reader("upload_mb").read(_readings(queries=0)) is None


def test_no_prepare_span_reads_nothing(fresh_obs):
    fresh_obs.count("bsp.h2d_bytes", 8)
    assert harness.reader("prepare_ms").read(_readings()) is None
    assert harness.reader("upload_mb").read(_readings()) is None


@pytest.mark.parametrize("name,span", [("windgp_s", "windgp"),
                                       ("pack_s", "pack"),
                                       ("layout_host_s", "layout.host"),
                                       ("layout_device_s", "layout.device")])
def test_setup_span_read_only_where_it_ran_once(fresh_obs, name, span):
    """A process that ran the step more than once (several cells, or
    partition jobs) gives no set-up reading rather than a sum."""
    reader = harness.reader(name)
    assert reader.read(_readings()) is None
    _record(fresh_obs, span, 1, 1_500_000_000)
    assert reader.read(_readings()) == pytest.approx(1.5)
    _record(fresh_obs, span, 2, 3_000_000_000)
    assert reader.read(_readings()) is None


def _traced_small_run() -> dict:
    """The first cell, small, traced on the CPU: its metrics that need no
    device session."""
    cell = small_cell(CELL)
    cell.per_layer = [m for m in cell.per_layer if not getattr(
        harness.reader(m["name"]), "NEEDS_SESSIONS", False)]
    return harness.run_cell(cell, 2 ** 31 + 17, SMALL_SECONDS, True,
                            time.perf_counter(), device="cpu")


def test_traced_run_reads_the_program(fresh_obs):
    out = _traced_small_run()
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert set(got) >= set(PROGRAM_METRICS)
    for m in PROGRAM_METRICS:
        assert got[m]["value"] > 0, m
    spans = fresh_obs.snapshot()["spans"]
    assert got["prepare_ms"]["value"] == pytest.approx(
        1e3 * spans["bsp.prepare"]["self_s"] / spans["bsp.prepare"]["count"])


def test_harness_without_the_program_spans(monkeypatch):
    """A program without ``repro_torch.obs`` (an older commit) runs traced
    and untraced as before, and its readers of the program give nothing."""
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert program_obs.totals(_readings()) is None
    out = _traced_small_run()
    assert out["correct"], out["checks"]
    assert "device_idle.superstep" in out["metrics"]
    assert not set(out["metrics"]) & set(PROGRAM_METRICS)
    assert run_small(CELL)["correct"]
