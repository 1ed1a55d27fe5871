"""Device meshes: counterpart of ``fedml_tpu/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` over local (or pod-wide)
devices and lets the compiler insert the collectives. Here a mesh is a named
grid: with a ``torch.distributed`` process group up, each position is a rank
(and its card) and the mesh is ``torch.distributed.device_mesh``'s
``DeviceMesh`` (:func:`init_device_mesh`), whose per-axis process groups
carry the collectives; without one, it is a plain grid of devices
(:class:`DeviceGrid`) for code that places work itself. A mesh that needs
more devices (or ranks) than there are raises the JAX package's
``ValueError``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class DeviceGrid:
    """A named grid of devices, the single-process form of a mesh:
    ``devices`` is an object array of ``torch.device`` of ``shape``."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"DeviceGrid({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def local_devices() -> List[torch.device]:
    """Every visible card, or the CPU where there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]


def _dist_world() -> Optional[int]:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else None


def create_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], devices=None):
    """A mesh of ``axis_shapes`` named ``axis_names``. With a process group
    up and no ``devices`` given, a ``DeviceMesh`` over the first
    ``prod(axis_shapes)`` ranks, each on its own device type; otherwise a
    :class:`DeviceGrid` over ``devices`` (default: :func:`local_devices`)."""
    n = int(np.prod(axis_shapes))
    world = _dist_world()
    if devices is None and world is not None:
        if n > world:
            raise ValueError(f"mesh needs {n} devices, have {world}")
        from torch.distributed.device_mesh import DeviceMesh

        from .multihost import process_device

        mesh = torch.arange(n).reshape(tuple(int(s) for s in axis_shapes))
        return DeviceMesh(process_device().type, mesh, mesh_dim_names=tuple(axis_names))
    devices = list(devices) if devices is not None else local_devices()
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    return DeviceGrid(arr.reshape(tuple(int(s) for s in axis_shapes)), tuple(axis_names))


def dp_mesh(n_devices: Optional[int] = None, devices=None):
    """1-D data-parallel mesh (the DDP analogue): ``n_devices`` ranks (or
    devices), default all of them."""
    if n_devices is None:
        world = _dist_world()
        n_devices = world if devices is None and world is not None else \
            len(list(devices) if devices is not None else local_devices())
    return create_mesh((n_devices,), ("dp",), devices)


def fsdp_mesh(dp: int, fsdp: int, devices=None):
    return create_mesh((dp, fsdp), ("dp", "fsdp"), devices)


def tp_mesh(dp: int, fsdp: int, tp: int, devices=None):
    """3-D mesh for the LLM path: data x fully-sharded x tensor."""
    return create_mesh((dp, fsdp, tp), ("dp", "fsdp", "tp"), devices)
