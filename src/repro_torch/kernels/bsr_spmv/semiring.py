"""Semirings for the edge-kernel layer: (⊕, ⊗) pairs the SpMV runs over.

An edge-centric BSP superstep is a sparse matrix–vector product over a
semiring: PageRank accumulates weighted messages ((+, ×)), SSSP relaxes
tentative distances ((min, +)), BFS propagates frontier membership
((or, and)).  Boolean semirings run in float32 0/1: ``or`` is ``max`` and
``and`` is ``×`` on {0, 1}.

Each semiring fixes the scalars the layouts and kernels share:

* ``zero``   — the ⊕ identity: reduction init, and the value of an empty row;
* ``absent`` — the value stored for a *missing* matrix entry, the ⊗
  annihilator (``absent ⊗ x = zero`` for every finite ``x``), so padding
  blocks and ELL fill slots contribute the identity;
* ``times``/``plus``/``plus_reduce`` — the torch elementwise ⊗, pairwise ⊕
  and ⊕-reduction over a dim.  ``torch.minimum``/``amin`` (and the max
  forms) propagate NaN, as the CUDA kernel's ⊕ does.

``code`` is the integer the CUDA kernel's C entry point takes for the
semiring (its template instance).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    code: int                   # semiring id of the CUDA entry point
    zero: float                 # ⊕ identity (reduction init / empty row)
    absent: float               # stored value of a missing entry
    times: Callable             # torch elementwise ⊗ (weight, operand)
    plus: Callable              # torch pairwise ⊕
    plus_reduce: Callable       # torch ⊕-reduction over a dim
    #: in-place numpy ⊕-accumulation (``np.add.at``-style): how parallel
    #: edges landing in the same matrix cell combine in the host layout
    np_accum_at: Callable
    #: ``scatter_reduce_`` name of ⊕, None for (+, ×) (``index_add_``)
    reduce: str | None

    def scatter_accum(self, arr: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
        """In-place ``arr[idx] ⊕= vals`` over dim 0 of a 1-D ``arr``."""
        if self.reduce is None:
            return arr.index_add_(0, idx, vals)
        return arr.scatter_reduce_(0, idx, vals, self.reduce,
                                   include_self=True)

    def weights(self, weight: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
        """Effective per-edge ⊗ operand: ``weight`` where valid, else the
        annihilator (padding edges contribute the ⊕ identity)."""
        return torch.where(valid, weight, self.absent)


PLUS_TIMES = Semiring(
    name="plus_times", code=0, zero=0.0, absent=0.0,
    times=lambda a, x: a * x,
    plus=lambda a, b: a + b,
    plus_reduce=lambda a, dim: a.sum(dim=dim),
    np_accum_at=np.add.at, reduce=None)

MIN_PLUS = Semiring(
    name="min_plus", code=1, zero=float("inf"), absent=float("inf"),
    times=lambda a, x: a + x,
    plus=torch.minimum,
    plus_reduce=lambda a, dim: a.amin(dim=dim),
    np_accum_at=np.minimum.at, reduce="amin")

#: boolean (or, and) in float 0/1: and = ×, or = max
OR_AND = Semiring(
    name="or_and", code=2, zero=0.0, absent=0.0,
    times=lambda a, x: a * x,
    plus=torch.maximum,
    plus_reduce=lambda a, dim: a.amax(dim=dim),
    np_accum_at=np.maximum.at, reduce="amax")

SEMIRINGS = {s.name: s for s in (PLUS_TIMES, MIN_PLUS, OR_AND)}


def get_semiring(s) -> Semiring:
    """Resolve a semiring by name (or pass a ``Semiring`` through)."""
    if isinstance(s, Semiring):
        return s
    try:
        return SEMIRINGS[s]
    except KeyError:
        raise ValueError(f"unknown semiring {s!r} "
                         f"(choices: {sorted(SEMIRINGS)})") from None
