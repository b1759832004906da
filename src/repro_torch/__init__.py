"""PyTorch/CUDA port of the WindGP system.

The host-side partitioner (``core``, ``data``) is numpy, as in the JAX
package it mirrors; the BSP runtime (``bsp``) runs on torch tensors, and
the semiring SpMV (``kernels.bsr_spmv``: the row layout's kernel the
``pallas`` backend launches, and the dense Block-ELL kernel) is
hand-written CUDA for Hopper (``sm_90a``).  Every entry point takes ``device=``,
defaulting to ``"cuda"``, and raises when no GPU is present unless the
caller asks for ``"cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
