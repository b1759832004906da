"""The port's partition CLI against the reference CLI on the CPU."""
import ast
import json
import signal

import numpy as np
import pytest
import torch

from repro.launch import partition as ref_cli

from repro_torch.launch import partition as port_cli

#: seconds the ``--workers`` test may take (it takes about one)
WORKERS_LIMIT_S = 60


def report_of(out: str) -> dict:
    """The JSON report block the CLIs print after the graph line."""
    start = out.index("{")
    depth = 0
    for i, ch in enumerate(out[start:], start):
        depth += {"{": 1, "}": -1}.get(ch, 0)
        if depth == 0:
            return json.loads(out[start:i + 1])
    raise AssertionError("no report in output")


def test_cli_pallas_pagerank_matches_reference_report(capsys):
    assert ref_cli.main(["--graph", "rmat:9"]) == 0
    ref_out = capsys.readouterr().out
    assert port_cli.main(["--graph", "rmat:9", "--pagerank", "--backend",
                          "pallas", "--device", "cpu",
                          "--pagerank-iters", "5"]) == 0
    out = capsys.readouterr().out
    a, b = report_of(ref_out), report_of(out)
    for key in ("method", "TC", "RF", "feasible", "edges_per_machine",
                "t_total_per_machine"):
        assert a[key] == b[key], key
    assert ref_out.splitlines()[0] == out.splitlines()[0]     # graph line
    assert "pagerank[pallas/stepwise/float32]: 5/5 supersteps on p=9" in out
    assert "top-5:" in out


@pytest.mark.parametrize("flags", [
    ["--backend", "segment", "--fused"],
    ["--backend", "pallas", "--message-dtype", "bfloat16", "--tol", "1e-7"],
    ["--backend", "scatter", "--message-dtype", "float16"],
])
def test_cli_pagerank_flags_print_the_reference_report(capsys, flags):
    """The pagerank line as the reference CLI prints it, less the time,
    and the same top-5 vertices."""
    argv = ["--graph", "rmat:9", "--pagerank", "--pagerank-iters", "8",
            *flags]
    assert ref_cli.main(argv) == 0
    ref_out = capsys.readouterr().out
    assert port_cli.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out

    def lines(text):
        pr = next(x for x in text.splitlines() if x.startswith("pagerank["))
        top = next(x for x in text.splitlines() if x.startswith("top-5:"))
        return (pr.split(" in ")[0],
                sorted(ast.literal_eval(top[len("top-5:"):])))
    assert lines(out) == lines(ref_out)


def test_cli_run_returns_runtime_and_ranks():
    res = port_cli.run(["--graph", "mesh:12", "--pagerank", "--device",
                        "cpu", "--pagerank-iters", "3"])
    assert res.runtime.p == res.cluster.p
    assert res.pagerank.shape == (res.graph.num_vertices,)
    assert res.actives.shape == (3, res.cluster.p)


def test_cli_requires_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["--graph", "rmat:8", "--pagerank"])
    with pytest.raises(RuntimeError):
        port_cli.main(["--graph", "rmat:8"])


def test_cli_rejects_unported_inputs(tmp_path, capsys):
    """The port rejects what the reference CLI rejects, in the same way:
    a stream over a generator spec, ``--block-size`` on a method that is
    no block-stream scorer, ``--stream --pagerank`` without ``--out-dir``,
    no ``--graph``, and a missing edge-list file."""
    path = edge_file(tmp_path)
    for argv in (["--graph", "rmat:8", "--stream"],
                 ["--graph", "rmat:8", "--method", "hash",
                  "--block-size", "8"],
                 ["--graph", path, "--stream", "--pagerank"],
                 ["--graph", path, "--stream", "--method", "ne"],
                 ["--method", "hdrf"]):
        with pytest.raises(SystemExit):
            ref_cli.main(argv)
        ref_err = capsys.readouterr().err.splitlines()[-1]
        with pytest.raises(SystemExit):
            port_cli.main([*argv, "--device", "cpu"])
        assert capsys.readouterr().err.splitlines()[-1] == ref_err
    missing = ["--graph", str(tmp_path / "missing.txt")]
    with pytest.raises(FileNotFoundError):
        ref_cli.main(missing)
    with pytest.raises(FileNotFoundError):
        port_cli.main([*missing, "--device", "cpu"])


def edge_file(tmp_path, scale=9):
    """An R-MAT edge list with duplicates and reversed pairs, as text."""
    path = tmp_path / "edges.txt"
    if not path.exists():
        from repro.data import rmat
        rows = rmat(scale, seed=5).edges
        rows = np.concatenate([rows, rows[::4, ::-1]])
        path.write_text("".join(f"{u} {v}\n" for u, v in rows))
    return str(path)


def both(capsys, argv, port_extra=("--device", "cpu")):
    """Run both CLIs on ``argv``; their stdouts."""
    assert ref_cli.main(argv) == 0
    ref_out = capsys.readouterr().out
    assert port_cli.main([*argv, *port_extra]) == 0
    return ref_out, capsys.readouterr().out


def reports(text):
    """Every JSON block a CLI printed, less its wall time."""
    out, rest = [], text
    while "{\n" in rest:
        rest = rest[rest.index("{\n"):]
        block = report_of(rest)
        block.pop("seconds")
        out.append(block)
        rest = rest[rest.index("\n}") + 2:]
    return out


def plain_lines(text, *dirs):
    """The lines outside the JSON blocks (whose lines all start with a
    brace or an indent), the time of a pagerank line dropped and each of
    ``dirs`` named alike."""
    keep = []
    for line in text.splitlines():
        if line[:1] in "{} ":
            continue
        for i, d in enumerate(dirs):
            line = line.replace(str(d), f"<dir{i}>")
        keep.append(line.split(" in ")[0] if line.startswith("pagerank[")
                    else line)
    return keep


@pytest.mark.parametrize("flags", [
    ["--method", "hdrf"],
    ["--method", "greedy", "--block-size", "64"],
    ["--method", "ebv", "--block-size", "1"],
    ["--method", "metis"],
], ids=["file-hdrf", "block-size-64", "block-size-1", "file-metis"])
def test_cli_edge_list_file_report(tmp_path, capsys, flags):
    ref_out, out = both(capsys, ["--graph", edge_file(tmp_path), *flags])
    assert reports(out) == reports(ref_out)
    assert plain_lines(out) == plain_lines(ref_out)


@pytest.mark.parametrize("dedup", ["block", "two_pass"])
def test_cli_stream_report_and_assignment(tmp_path, capsys, dedup):
    path = edge_file(tmp_path)
    argv = ["--graph", path, "--stream", "--method", "hdrf", "--dedup",
            dedup, "--block-size", "512"]
    assert ref_cli.main([*argv, "--out-dir", str(tmp_path / "ref")]) == 0
    ref_out = capsys.readouterr().out
    res = port_cli.run([*argv, "--out-dir", str(tmp_path / "port"),
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert reports(out) == reports(ref_out)
    assert plain_lines(out, tmp_path / "port") == \
        plain_lines(ref_out, tmp_path / "ref")
    assert res.assignment.meta == json.loads(
        (tmp_path / "ref" / "meta.json").read_text())
    for i in range(res.assignment.p):
        name = f"shard{i}.edges"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()


@pytest.fixture()
def time_limit():
    """A SIGALRM that fails the test after ``WORKERS_LIMIT_S`` seconds: the
    worker pipeline forks, and a wedged fork would hang the run."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {WORKERS_LIMIT_S} s limit")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(WORKERS_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def test_cli_workers_sync1_and_compact(tmp_path, capsys, time_limit):
    """``--workers 2 --sync-blocks 1`` prints the reference's report and
    writes the shards of the one-worker run; ``--compact`` on the result
    prints the reference's report."""
    path = edge_file(tmp_path)
    argv = ["--graph", path, "--stream", "--method", "hdrf", "--dedup",
            "two_pass", "--block-size", "256"]
    dirs = {k: tmp_path / k for k in ("ref", "port", "one")}
    assert ref_cli.main([*argv, "--workers", "2", "--sync-blocks", "1",
                         "--out-dir", str(dirs["ref"])]) == 0
    ref_out = capsys.readouterr().out
    assert port_cli.main([*argv, "--workers", "2", "--sync-blocks", "1",
                          "--out-dir", str(dirs["port"]),
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert port_cli.main([*argv, "--out-dir", str(dirs["one"]),
                          "--device", "cpu"]) == 0
    capsys.readouterr()
    assert reports(out) == reports(ref_out)
    names = sorted(f.name for f in dirs["ref"].iterdir())
    for name in names:
        if name.startswith("shard"):
            assert (dirs["port"] / name).read_bytes() == \
                (dirs["ref"] / name).read_bytes() == \
                (dirs["one"] / name).read_bytes()
    for frac in ("0.5", "0.0"):
        ref_out, out = both(capsys, ["--compact", str(dirs["ref"]),
                                     "--compact-tomb-frac", frac])
        assert reports(out) == reports(ref_out)


@pytest.fixture(scope="module")
def baseline_runs(tmp_path_factory):
    """The reference's and the port's CLI run of HDRF on an edge-list file
    with ``--pagerank`` on ``pallas`` (the reference in interpret mode)."""
    tmp = tmp_path_factory.mktemp("baseline")
    argv = ["--graph", edge_file(tmp), "--method", "hdrf", "--pagerank",
            "--backend", "pallas", "--pagerank-iters", "8"]
    res = port_cli.run([*argv, "--device", "cpu"])
    import repro.bsp as J
    rt_ref = J.PartitionRuntime.create(ref_cli.load_graph(argv[1]),
                                       assign=res.assign, cluster=res.cluster)
    return res, rt_ref


def test_cli_pallas_pagerank_on_a_baseline(baseline_runs):
    import repro.bsp as J
    res, rt_ref = baseline_runs
    want, acts = J.pagerank(rt_ref, num_iters=8, backend="pallas")
    assert res.actives.shape == np.asarray(acts).shape
    np.testing.assert_allclose(res.pagerank, np.asarray(want), atol=1e-6,
                               rtol=1e-5)


def test_cli_pallas_sssp_on_a_baseline(baseline_runs):
    import repro.bsp as J
    import repro_torch.bsp as T
    res, rt_ref = baseline_runs
    source = int(np.argmax(res.graph.degree()))
    want, acts_ref = J.sssp(rt_ref, source=source, num_iters=12,
                            backend="pallas")
    got, acts = T.sssp(res.runtime, source=source, num_iters=12,
                       backend="pallas")
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(acts, np.asarray(acts_ref))


def test_cli_stream_pagerank_on_pallas(tmp_path, capsys):
    """``--stream --out-dir --pagerank`` packs the runtime from the shards
    and prints the reference's pagerank line and top-5."""
    path = edge_file(tmp_path)
    argv = ["--graph", path, "--stream", "--method", "hdrf", "--dedup",
            "two_pass", "--pagerank", "--backend", "pallas",
            "--pagerank-iters", "6"]
    assert ref_cli.main([*argv, "--out-dir", str(tmp_path / "ref")]) == 0
    ref_out = capsys.readouterr().out
    res = port_cli.run([*argv, "--out-dir", str(tmp_path / "port"),
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert plain_lines(out, tmp_path / "port") == \
        plain_lines(ref_out, tmp_path / "ref")
    assert res.runtime.p == res.cluster.p and res.graph is None
