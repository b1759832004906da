"""Build a hand-written CUDA source into a shared library loaded by ctypes.

``nvcc`` compiles the ``.cu`` file for Hopper (``sm_90a``) into
``build/torch_ext/<stem>-<hash>.so`` at the repository root, at first use;
the hash covers the source and the flags, so an edited kernel rebuilds and
an unchanged one is reused.  The source includes no PyTorch header: it
exposes plain C functions that take ``data_ptr()``s, sizes and the stream,
which keeps a build to seconds.  ``--use_fast_math`` is deliberately
absent (see each kernel's source).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_ext"


@dataclasses.dataclass(frozen=True)
class Built:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float      # build (or load) time at first use
    log: str            # nvcc's output (register/shared-memory use), "" if cached


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME): "
                       "the CUDA kernels are built from source at first use")


@functools.cache
def load_library(source: pathlib.Path) -> Built:
    """Compile ``source`` (once per content) and load it; cached per path."""
    source = pathlib.Path(source).resolve()
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)    # atomic: concurrent builders never see half a file
        log = proc.stdout + proc.stderr
    return Built(ctypes.CDLL(str(out)), out, time.perf_counter() - t0, log)
