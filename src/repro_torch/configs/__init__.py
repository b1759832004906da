"""Architecture registry of the port, the reference's
(``src/repro/configs/__init__.py``): ``--arch <id>`` resolves here.

``get_config(name)`` gives the published configuration and
``get_reduced(name)`` the smoke-test-sized one of the same family; an
unknown name raises ``KeyError``.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (glm4_9b, granite_moe_3b_a800m, jamba_v01_52b, mamba2_780m,
               minicpm3_4b, musicgen_medium, paligemma_3b, phi35_moe_42b,
               qwen3_14b, qwen3_4b)

_MODULES = {
    "mamba2-780m": mamba2_780m,
    "glm4-9b": glm4_9b,
    "qwen3-4b": qwen3_4b,
    "minicpm3-4b": minicpm3_4b,
    "qwen3-14b": qwen3_14b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "jamba-v0.1-52b": jamba_v01_52b,
    "musicgen-medium": musicgen_medium,
    "paligemma-3b": paligemma_3b,
}

ARCHS = tuple(_MODULES)

# Input shapes assigned to the LM family (seq_len, global_batch, kind).
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k needs a sub-quadratic sequence path: only SSM/hybrid qualify.
LONG_CONTEXT_ARCHS = ("mamba2-780m", "jamba-v0.1-52b")


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r} (known: {', '.join(ARCHS)})")
    return _MODULES[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """Smoke-test-sized config of the same family/pattern."""
    return _module(name).REDUCED


def cells():
    """All (arch, shape) dry-run cells, honoring the long-context skip."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                continue
            out.append((a, s))
    return out
