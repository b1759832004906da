"""Architecture registry of the port: the archs whose serving path is ported.

``get_config(name)`` gives the published configuration and
``get_reduced(name)`` the smoke-test-sized one of the same family.  Only
qwen3-4b (dense GQA) and mamba2-780m (SSM) are here; the reference's other
archs (MLA, MoE, hybrid, embedding-input) are still to port
(``ROADMAP.md`` §A) and raise ``KeyError``.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import mamba2_780m, qwen3_4b

_MODULES = {
    "mamba2-780m": mamba2_780m,
    "qwen3-4b": qwen3_4b,
}

ARCHS = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported yet (ported: "
                       f"{', '.join(ARCHS)}); see ROADMAP.md §A")
    return _MODULES[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """Smoke-test-sized config of the same family/pattern."""
    return _module(name).REDUCED
