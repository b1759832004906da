"""Architecture registry of the port: the archs whose serving path is ported.

``get_config(name)`` gives the published configuration and
``get_reduced(name)`` the smoke-test-sized one of the same family: dense
GQA (qwen3-4b), SSM (mamba2-780m), MoE (granite-moe-3b-a800m,
phi3.5-moe-42b-a6.6b) and hybrid (jamba-v0.1-52b).  The reference's other
archs (MLA, embedding-input, glm4-9b, qwen3-14b) are still to port
(``ROADMAP.md`` §A) and raise ``KeyError``.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (granite_moe_3b_a800m, jamba_v01_52b, mamba2_780m,
               phi35_moe_42b, qwen3_4b)

_MODULES = {
    "mamba2-780m": mamba2_780m,
    "qwen3-4b": qwen3_4b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "jamba-v0.1-52b": jamba_v01_52b,
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
