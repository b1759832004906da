"""The port stands alone: it imports neither JAX nor the JAX package."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")
#: everything that runs on the card's machine, where there is no JAX
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"]


def absolute_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in absolute_imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.partition, repro_torch.bsp, "
            "repro_torch.convert, repro_torch.models, repro_torch.serve, "
            "repro_torch.configs, repro_torch.kernels.decode_attn, "
            "repro_torch.kernels.ssd, repro_torch.core.baselines, "
            "repro_torch.core.extensions, repro_torch.core.parallel, "
            "repro_torch.core.dynamic, repro_torch.data.io, "
            "repro_torch.bsp.stream_assignment, repro_torch.sampling, "
            "repro_torch.sampling.machine_csc, repro_torch.sampling.sampler, "
            "repro_torch.sampling.service, repro_torch.sampling.features, "
            "repro_torch.sampling.pipeline, repro_torch.bsp.distributed, "
            "repro_torch.sharding.windgp_placement, repro_torch.train, "
            "repro_torch.launch.train, repro_torch.data.lm_data; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def forbidden_loaded(rt, mesh):
    """A rank function: the forbidden modules the rank has loaded."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def test_spawned_rank_leaves_jax_unloaded():
    """A rank of ``spawn_machines`` starts afresh and loads no JAX, even
    when the launching process has."""
    import numpy as np
    from repro_torch.bsp import spawn_machines
    from repro_torch.data import rmat
    g = rmat(5, seed=1)
    got = spawn_machines(forbidden_loaded, 2, graph=g,
                         assign=np.arange(g.num_edges) % 2, device="cpu",
                         timeout=120)
    assert got == [[], []]
