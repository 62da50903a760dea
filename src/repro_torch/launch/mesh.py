"""Production mesh construction (port of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the leading 'pod' axis
carries only data parallelism, never TP.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world
the caller started (``torch.distributed.init_process_group``, one process
a rank), on the card where CUDA is present, else on the CPU.  Defined as
functions, so importing this module touches no process group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(
            f"mesh {shape} needs a world of {n} ranks, have {world}: start "
            f"{n} processes and call torch.distributed.init_process_group "
            f"in each (rank, world_size={n}) before make_production_mesh")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """A small mesh over the world the caller started (its size must be
    the product of ``shape``)."""
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))
