"""The port's examples (``examples/torch_*.py``) against the reference's of
the same name, each run as a subprocess, the port's with ``--device cpu``.

Every subprocess of the module starts at once (one fixture), so the module
takes about as long as its slowest pair.  Holds:

* ``quickstart``, ``hetero_moe_placement``: every printed line equal, the
  WindGP line's seconds aside (TC, RF, makespans, placement and batch
  split are host numpy, bitwise the reference's);
* ``partition_and_pagerank``: every line equal with its ``wall`` and
  ``maxerr`` fields aside, and each of the port's ``maxerr`` within
  PageRank's 1e-5;
* ``partition_edgelist`` on an ``rmat(9)`` edge list: ``meta.json`` equal
  but for ``seconds``, the shard files and the assignment directory equal
  byte for byte, and the printed lines equal but for seconds, with
  ``--pagerank --backend pallas`` (the reference's Pallas interpreter, the
  port's plain ``bsr_spmv``);
* ``train_lm``: the argv each hands its train CLI equal apart from the
  port's ``--device cpu`` and the temporary checkpoint directory; the
  port's, at ``--steps 2``, exits 0 and writes its checkpoint.  Losses are
  not compared: the port's CLI draws its weights from a
  ``torch.Generator``, the reference's from ``jax.random``.

Without ``--device`` the port's examples ask for CUDA, and raise where
there is none.
"""
import filecmp
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TIMEOUT_S = 300

#: run an example with its train CLI's ``main`` replaced by one that prints
#: the argv it was handed
CAPTURE = r"""
import json, runpy, sys
import {module} as cli
cli.main = lambda argv=None: print("ARGV " + json.dumps(argv)) or 0
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def commands(tmp: pathlib.Path) -> dict:
    """name -> (argv, working directory) of every run of the module."""
    edges = tmp / "edges.txt"
    py = sys.executable
    ex = lambda name: str(EXAMPLES / name)
    cpu = ["--device", "cpu"]
    el = [str(edges), "--pagerank", "--backend", "pallas"]
    return {
        "quickstart": [py, ex("quickstart.py")],
        "torch_quickstart": [py, ex("torch_quickstart.py"), *cpu],
        "torch_quickstart_cuda": [py, ex("torch_quickstart.py")],
        "hetero": [py, ex("hetero_moe_placement.py")],
        "torch_hetero": [py, ex("torch_hetero_moe_placement.py"), *cpu],
        "pagerank": [py, ex("partition_and_pagerank.py")],
        "torch_pagerank": [py, ex("torch_partition_and_pagerank.py"), *cpu],
        "edgelist": [py, ex("partition_edgelist.py"), *el, "--out-dir",
                     str(tmp / "ref_parts")],
        "torch_edgelist": [py, ex("torch_partition_edgelist.py"), *el,
                           "--out-dir", str(tmp / "port_parts"), *cpu],
        "train_argv": [py, "-c", CAPTURE.format(module="repro.launch.train"),
                       ex("train_lm.py"), "--steps", "2"],
        "torch_train_argv": [py, "-c", CAPTURE.format(
            module="repro_torch.launch.train"), ex("torch_train_lm.py"),
            "--steps", "2", *cpu],
        "torch_train": [py, ex("torch_train_lm.py"), "--steps", "2", *cpu],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """name -> CompletedProcess-like (returncode, stdout, stderr)."""
    tmp = tmp_path_factory.mktemp("examples")
    from repro_torch.data import rmat, write_edge_list
    write_edge_list(rmat(9, seed=1), str(tmp / "edges.txt"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "TMPDIR": str(tmp)}
    procs = {name: subprocess.Popen(argv, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    env=env, cwd=str(tmp))
             for name, argv in commands(tmp).items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        out[name] = (proc.returncode, stdout, stderr)
    out["tmp"] = tmp
    return out


def ok(runs, name: str) -> list:
    rc, stdout, stderr = runs[name]
    assert rc == 0, f"{name}: rc {rc}\n{stderr[-3000:]}"
    return stdout.splitlines()


def without(lines: list, pattern: str) -> list:
    return [re.sub(pattern, "", line) for line in lines]


def test_quickstart_prints_the_reference_lines(runs):
    seconds = r"\(\d+\.\d+s\)"
    want = without(ok(runs, "quickstart"), seconds)
    assert without(ok(runs, "torch_quickstart"), seconds) == want
    assert any(line.startswith("WindGP : TC=") for line in want)


def test_hetero_moe_placement_prints_the_reference_lines(runs):
    want = ok(runs, "hetero")
    assert ok(runs, "torch_hetero") == want
    assert want[0].startswith("expert -> pod:")


def test_partition_and_pagerank_prints_the_reference_lines(runs):
    fields = r"  wall=\S+  maxerr=\S+"
    got = ok(runs, "torch_pagerank")
    assert without(got, fields) == without(ok(runs, "pagerank"), fields)
    errs = [float(m) for m in re.findall(r"maxerr=(\S+)", "\n".join(got))]
    assert len(errs) == 3 and max(errs) <= 1e-5, errs


def test_partition_edgelist_writes_the_reference_shards(runs):
    seconds = r"(\"seconds\": \S+|in \d+\.\d+s)"
    got = ok(runs, "torch_edgelist")
    assert without(got, seconds) == without(ok(runs, "edgelist"), seconds)
    assert any(line.startswith("pagerank[pallas/") for line in got)
    ref, port = runs["tmp"] / "ref_parts", runs["tmp"] / "port_parts"
    meta = [json.loads((d / "meta.json").read_text()) for d in (ref, port)]
    for m in meta:
        m.pop("seconds")
    assert meta[0] == meta[1]
    names = meta[0]["files"]
    match, mismatch, errors = filecmp.cmpfiles(ref, port, names,
                                               shallow=False)
    assert match == names and not mismatch and not errors
    cmp = filecmp.dircmp(ref / "assignment", port / "assignment")
    assert cmp.left_list == cmp.right_list
    match, mismatch, errors = filecmp.cmpfiles(
        ref / "assignment", port / "assignment", cmp.common_files,
        shallow=False)
    assert not mismatch and not errors


def argv_of(runs, name: str) -> list:
    lines = [line for line in ok(runs, name) if line.startswith("ARGV ")]
    assert len(lines) == 1, runs[name]
    argv = json.loads(lines[0][len("ARGV "):])
    at = argv.index("--checkpoint-dir")
    return argv[:at + 1] + ["<tmp>"] + argv[at + 2:]


def test_train_lm_hands_the_reference_argv(runs):
    assert argv_of(runs, "torch_train_argv") == \
        argv_of(runs, "train_argv") + ["--device", "cpu"]


def test_train_lm_trains_and_checkpoints(runs):
    lines = ok(runs, "torch_train")
    assert any(line.startswith("step     2  loss ") for line in lines)
    ckpt = pathlib.Path(lines[-1].split("checkpoints in ", 1)[1])
    assert sorted(os.listdir(ckpt)) == ["step_0000000002"]


def test_examples_ask_for_cuda_by_default(runs):
    rc, _, stderr = runs["torch_quickstart_cuda"]
    assert rc != 0 and "torch.cuda.is_available() is False" in stderr
