"""The port's partition CLI against the reference CLI on the CPU."""
import ast
import json

import pytest
import torch

from repro.launch import partition as ref_cli

from repro_torch.launch import partition as port_cli


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


def test_cli_rejects_unported_inputs():
    with pytest.raises(SystemExit):
        port_cli.main(["--graph", "rmat:8", "--stream", "--device", "cpu"])
    with pytest.raises(ValueError):
        port_cli.main(["--graph", "edges.txt", "--device", "cpu"])
