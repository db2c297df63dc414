"""Device meshes: the counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dims
("data", "model") or ("pod", "data", "model"), built over the ranks of the
default process group, which the caller initialises first
(``torch.distributed.init_process_group`` with its own store, world size
and rank). An ``AbstractMesh`` carries the same names and sizes without
devices, so the sharding rules (``repro_torch.distributed.sharding``) can
compute the specs of the production meshes, (16, 16) and (2, 16, 16), on
any machine, as the reference's rule engine does from ``mesh.devices.shape``
alone. Meshes live on the card unless the caller asks for the CPU
(``device.resolve``; the CPU takes the gloo backend).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import device as device_lib


class AbstractMesh(NamedTuple):
    """A mesh's dim sizes and names, as ``DeviceMesh.shape`` and
    ``DeviceMesh.mesh_dim_names`` give them, with no devices."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def abstract_mesh(dp: int = 1, tp: int = 1, pods: int = 1) -> AbstractMesh:
    if pods > 1:
        return AbstractMesh((pods, dp, tp), ("pod", "data", "model"))
    return AbstractMesh((dp, tp), ("data", "model"))


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    return abstract_mesh(16, 16, 2 if multi_pod else 1)


def _device_mesh(layout: AbstractMesh, device) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs torch.distributed initialised "
                           "first (init_process_group)")
    n, world = math.prod(layout.shape), dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {layout.shape} needs {n} ranks, the process "
                         f"group has {world}")
    return init_device_mesh(device_lib.resolve(device).type, layout.shape,
                            mesh_dim_names=layout.mesh_dim_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """(16, 16) or (2, 16, 16) over 256 or 512 ranks; raises on any other
    world size."""
    return _device_mesh(abstract_production_mesh(multi_pod=multi_pod),
                        device)


def make_mesh(dp: int = 1, tp: int = 1, pods: int = 1,
              device=None) -> DeviceMesh:
    """Arbitrary (pod, data, model) mesh for trials / tests / smoke runs;
    dp × tp × pods must be the world size."""
    return _device_mesh(abstract_mesh(dp, tp, pods), device)


def single_device_mesh(device=None) -> DeviceMesh:
    return make_mesh(1, 1, device=device)
