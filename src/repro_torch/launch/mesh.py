"""Device meshes of the launch tooling, the counterpart of the reference's
``launch/mesh.py``.

A mesh here is a description: its axis names and sizes, which is all that
the split rules (``sharding/specs.py``) and the fit check
(``launch/dryrun.py``) read.  ``pod16x16`` and ``pod2x16x16`` are the
reference's production meshes; ``one`` is a single card.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes; ``shape`` is a ``{name: size}`` dict in axis
    order, as ``jax.sharding.Mesh.shape`` is."""

    axes: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axes) != len(self.sizes):
            raise ValueError(f"{len(self.axes)} axes {self.axes} for "
                             f"{len(self.sizes)} sizes {self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axes, self.sizes))

    @property
    def devices(self) -> int:
        return math.prod(self.sizes)

    def device_mesh(self, device_type: str = "cuda"):
        """The ``torch.distributed.device_mesh.DeviceMesh`` of this shape
        over a running ``torch.distributed`` group of ``devices`` ranks.
        Nothing in the port needs one on a single card: the fit check and
        ``perf.py`` read the shape only."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError("device_mesh() needs a running "
                               "torch.distributed process group")
        if dist.get_world_size() != self.devices:
            raise ValueError(f"a {self.sizes} mesh needs {self.devices} "
                             f"ranks, the group has "
                             f"{dist.get_world_size()}")
        return init_device_mesh(device_type, self.sizes,
                                mesh_dim_names=self.axes)


def make_mesh(shape, axes) -> MeshShape:
    """A mesh of any shape (tests, other layouts)."""
    return MeshShape(tuple(axes), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 × 16 = 256 devices a pod; 2 pods = 512 devices multi-pod."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def one_card() -> MeshShape:
    """A single card: ``data`` = 1 and ``model`` = 1."""
    return make_mesh((1, 1), ("data", "model"))


#: the mesh names of the launch CLIs
MESHES = {"pod": lambda: make_production_mesh(),
          "multipod": lambda: make_production_mesh(multi_pod=True),
          "one": one_card}
MESH_NAMES = {"pod": "pod16x16", "multipod": "pod2x16x16", "one": "one"}
