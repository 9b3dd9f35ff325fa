"""Production mesh construction (port of ``repro.launch.mesh``).

A mesh here is a :class:`MeshSpec`: axis names and sizes, which is all
the sharding rules read. Kept as FUNCTIONS (never module-level state) so
importing this module touches no device and no process group;
:func:`device_mesh` builds the ``torch.distributed`` ``DeviceMesh`` over
the process group in force when a program (the dry-run's trace) needs one.
"""
from __future__ import annotations

import math
from typing import NamedTuple


class MeshSpec(NamedTuple):
    """Axis names and sizes of a device mesh, row-major."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes, strict=True))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def label(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16 x 16 = 256 devices ("data", "model"); two pods = 2 x 16 x 16 =
    512 devices ("pod", "data", "model")."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_host_mesh() -> MeshSpec:
    """The devices this program drives, all on the data axis: the world
    size of the process group in force, else 1 (one process, one device)."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return MeshSpec(("data", "model"), (n, 1))


def trace_mesh(mesh: MeshSpec) -> MeshSpec:
    """The 2-D mesh a trace runs on: the data axes (pod, data) folded into
    one "data" axis of their product. Every rule names them together, so
    the groups and bytes are the same; DTensor plans a 3-D mesh's moves
    far more slowly, and issues a sum over (pod, data) as two collectives
    where XLA issues one."""
    data = tuple(a for a in mesh.axis_names if a != "model")
    if data == ("data",):
        return mesh
    return MeshSpec(("data", "model"), (math.prod(mesh.shape[a] for a in data),
                                        mesh.shape["model"]))


def device_mesh(mesh: MeshSpec, device_type: str = "cpu"):
    """The ``DeviceMesh`` of ``mesh`` over the default process group, whose
    world size must be ``mesh.size``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, mesh.sizes, mesh_dim_names=mesh.axis_names)
