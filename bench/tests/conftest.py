"""Puts the benchmark's files and the program on the import path, and
gives the tests small copies of the cells."""
import pathlib
import sys
import time

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

#: each cell's sizes cut so that a run takes about a second on the CPU
SMALL = {"graph500": {"scale": 8}}
SMALL_GRAPHS = 2
SMALL_SECONDS = 0.3


def small_cell(name: str):
    import harness
    cell = harness.load_cell(name)
    cell.config.update(SMALL[cell.config["generator"]])
    if "graphs" in cell.traffic:
        cell.traffic["graphs"] = SMALL_GRAPHS
    return cell


def run_small(name: str, device: str = "cpu", seed: int = 2 ** 31 + 11,
              **kw) -> dict:
    import harness
    return harness.run_cell(small_cell(name), seed, SMALL_SECONDS, False,
                            time.perf_counter(), device=device, **kw)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never while
    the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
