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

The LLM trainer's mesh is a :class:`RankMesh`: the ranks of the process
group laid out row-major over named axes (``("dp", "fsdp", "tp", "sp",
"ep")``, JAX's ``mesh_shape()``), with one process group for every set of
axes a collective runs over (a rank's ``tp`` group, its data group over
``dp`` x ``fsdp`` x ``sp``, ...). The sharded step (``parallel/fsdp.py``),
ring attention and the MoE read it as JAX's code reads its ``Mesh``.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

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


class RankMesh:
    """Ranks ``0..n-1`` of the process group as a row-major grid of
    ``axis_shapes`` named ``axis_names`` (rank ``r`` sits where
    ``torch.arange(n).reshape(axis_shapes)`` holds ``r``). Built collectively:
    every rank constructs it with the same arguments, and it creates the
    process group of every set of axes whose size is above 1 (the whole
    world's group is reused). A mesh of one position needs no process group
    and is this rank alone, whatever the group. A mesh of more positions
    than the process group's ranks, or of fewer but more than one, raises
    ``ValueError``."""

    def __init__(self, axis_shapes: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {n: int(s) for n, s in zip(axis_names, axis_shapes)}
        self.size = int(np.prod([int(s) for s in axis_shapes])) if axis_shapes else 1
        world = _dist_world()
        have = world if world is not None else 1
        if self.size > have:
            raise ValueError(f"mesh needs {self.size} devices, have {have}")
        if self.size > 1 and self.size != have:
            raise ValueError(f"mesh of {self.size} ranks over a process group of {have}: the "
                             "LLM mesh spans every rank of the group")
        self._grid = np.arange(self.size).reshape([self.shape[n] for n in self.axis_names])
        self.rank = 0
        self._groups: Dict[Tuple[str, ...], object] = {}
        if self.size > 1:
            import torch.distributed as dist

            self.rank = dist.get_rank()
            wide = [n for n in self.axis_names if self.shape[n] > 1]
            for k in range(1, len(wide) + 1):
                for axes in itertools.combinations(wide, k):
                    ranks = self._partition(axes)
                    if len(ranks) == 1:
                        self._groups[axes] = dist.group.WORLD
                    else:
                        self._groups[axes], _ = dist.new_subgroups_by_enumeration(ranks)

    def _partition(self, axes: Sequence[str]) -> List[List[int]]:
        """The rank lists of the groups varying over ``axes`` (ascending)."""
        keep = [i for i, n in enumerate(self.axis_names) if n in axes]
        moved = np.moveaxis(self._grid, keep, list(range(len(self.axis_names) - len(keep),
                                                            len(self.axis_names))))
        flat = moved.reshape(-1, int(np.prod([self.shape[self.axis_names[i]] for i in keep])))
        return [sorted(int(r) for r in row) for row in flat]

    def present(self, *axes: Optional[str]) -> Tuple[str, ...]:
        """``axes`` the mesh has with a size above 1, in mesh order."""
        return tuple(n for n in self.axis_names if n in axes and self.shape[n] > 1)

    def axis_size(self, *axes: str) -> int:
        """The product of the sizes of ``axes`` (1 for an axis the mesh lacks)."""
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        where = np.argwhere(self._grid == (self.rank if rank is None else rank))[0]
        return dict(zip(self.axis_names, (int(i) for i in where)))

    def index(self, *axes: str, rank: Optional[int] = None) -> int:
        """The row-major index of ``rank`` (default: this one) over ``axes``
        in mesh order; an axis the mesh lacks counts as size 1."""
        c = self.coords(rank)
        idx = 0
        for n in self.axis_names:
            if n in axes:
                idx = idx * self.shape[n] + c[n]
        return idx

    def group(self, *axes: str):
        """The process group of this rank's neighbours along ``axes``, or
        None when they span one rank."""
        return self._groups.get(self.present(*axes))

    def group_ranks(self, *axes: str) -> List[int]:
        """The global ranks of this rank's group along ``axes``, in the
        group's rank order."""
        axes = self.present(*axes)
        if not axes:
            return [self.rank]
        return next(r for r in self._partition(axes) if self.rank in r)

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, rank={self.rank})"
