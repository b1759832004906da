"""The harness finds its files by name, its frozen copies match the
program's originals, and it loads neither JAX nor the JAX package."""
import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import harness
import reference
import yardstick

BENCH = pathlib.Path(harness.__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    from repro_torch.bsp import apps
    cell = harness.load_cell(name)
    query = harness.Query.of(cell.traffic)
    assert (BENCH / "generators" / f"{cell.config['generator']}.py").exists()
    assert cell.traffic["query"] in harness.KINDS
    assert callable(getattr(apps, query.app))
    assert callable(query.ref.expected)
    assert set(cell.limits) >= {query.number}
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in [m["name"] for m in cell.end_to_end]


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    reader = harness.reader(name)
    empty = harness.Readings(setup_s=1.0, window_s=1.0, queries=[], jobs=[],
                             bound_s=None, peak_window_bytes=0)
    if name != "setup_s":
        assert reader.read(empty) is None      # nothing to read: no number


@pytest.mark.parametrize("name,file", [("device_idle.superstep",
                                        "device_idle.py"),
                                       ("peak_gb.any_cell_family",
                                        "peak_gb.py"),
                                       ("superstep_ms", "superstep_ms.py")])
def test_suffixed_metric_reads_with_its_base_reader(name, file):
    assert pathlib.Path(harness.reader(name).__file__).name == file


@pytest.mark.parametrize("scale,seed", [(6, 0), (9, 42), (10, 2 ** 31 + 3)])
def test_graph500_copy_matches_the_program(scale, seed):
    from repro_torch.data import graph500
    gen = harness.load_module(BENCH / "generators" / "graph500.py")
    raw, n = gen.make({"scale": scale, "edgefactor": 16, "a": 0.57,
                       "b": 0.19, "c": 0.19}, seed)
    g = graph500(scale, seed=seed)
    assert n == g.num_vertices
    assert np.array_equal(reference.canonical(raw, n), g.edges)


def test_cluster_copy_matches_the_program():
    from repro_torch.core import scaled_paper_cluster
    cfg = harness.load_cell(CELLS[0]).config["cluster"]
    want = scaled_paper_cluster(3, 6, 909_440, slack=1.8)
    assert reference.cluster_machines(cfg, 909_440) == \
        [m.as_tuple() for m in want.machines]


def test_work_bytes_hand_count():
    # machine 0 holds edges 0-1, 1-2 (vertices 0, 1, 2); machine 1 holds
    # 2-3 (vertices 2, 3): Vmax 3, 3 edges, float32 messages
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    assign = np.array([0, 0, 1])
    want = 2 * 3 * (4 + 4) + 2 * 2 * 3 * 4
    assert yardstick.work_bytes(edges, assign, 2, 4) == want
    assert yardstick.work_bytes(edges, assign, 2, 2) == \
        2 * 3 * (2 + 4) + 2 * 2 * 3 * 2


def test_reduce_trace_busy_and_gaps():
    import torch

    class Ev:
        def __init__(self, name, s, e, dev):
            self.name = name
            self.time_range = type("R", (), {"start": s, "end": e})
            self.device_type = (torch.autograd.DeviceType.CUDA if dev
                                else torch.autograd.DeviceType.CPU)

    events = [Ev("k1", 0, 300, True), Ev("k2", 200, 400, True),
              Ev("k1", 700, 1000, True), Ev("aten::item", 350, 800, False),
              Ev("outside", 5000, 6000, True),
              Ev("bench.window", 0, 1000, True)]
    out = yardstick.reduce_trace(events, (0.0, 1000.0))
    assert out["busy_s"] == pytest.approx(700e-6)
    assert out["window_s"] == pytest.approx(1000e-6)
    assert out["idle_gaps"] == [["aten::item", pytest.approx(300e-6)]]
    assert dict((k, v) for k, v in out["device_ops"]) == {
        "k1": pytest.approx(600e-6), "k2": pytest.approx(200e-6)}


def _imported(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_jax_or_jax_package(path):
    assert not _imported(BENCH / path) & {"jax", "jaxlib", "flax", "repro"}


REFERENCES = ["reference.py"] + sorted(
    p.relative_to(BENCH).as_posix()
    for p in (BENCH / "references").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCES)
def test_reference_loads_nothing_of_the_program(path):
    assert not {n for n in _imported(BENCH / path) if n.startswith("repro")}
    code = ("import sys; sys.path.insert(0, %r); import harness; "
            "harness.load_module(harness.BENCH / %r); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(BENCH), path))
    loaded = subprocess.run([sys.executable, "-c", code], check=True,
                            capture_output=True, text=True).stdout
    assert "repro" not in loaded and "jax" not in loaded
