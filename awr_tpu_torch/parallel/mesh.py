"""Device meshes and batch sharding (the JAX package's
``parallel/mesh.py``, its data axis).

A :class:`Mesh` is a tuple of ``torch.device``s on one axis.  PyTorch
has no global-view arrays, so a sharding here is explicit: a batch is
split into one tensor per mesh device (:func:`shard_batch`), and a
replicated tensor or module is one copy per device (:func:`replicated`).
The blocks are those of ``NamedSharding(mesh, P("data"))``: the leading
axis in contiguous, equal blocks, in mesh order.

Unlike a JAX mesh, a mesh may list one device more than once: each
entry is a replica of its own (its own copy of the weights) that happens
to share the device.  That is how one card, or the CPU, holds a mesh of
two or eight.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` in order along ``axis_name``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = DATA_AXIS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A data-parallel mesh over the visible CUDA devices (the first
    ``n_devices`` of them), or over ``devices`` as given (names or
    ``torch.device``s, repeats allowed)."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device visible: name the mesh's "
                               "devices, e.g. devices=['cpu'] * 8")
        devices = [torch.device("cuda", i) for i in range(count)]
        if n_devices is not None:
            if not 0 < n_devices <= count:
                raise ValueError(f"{n_devices} devices asked, {count} "
                                 f"visible")
            devices = devices[:n_devices]
    return Mesh(tuple(devices), DATA_AXIS)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a value lies on a mesh: split along its leading axis
    (``axis`` :data:`DATA_AXIS`) or copied whole (``axis`` None)."""

    mesh: Mesh
    axis: Optional[str]

    def slices(self, n: int) -> Tuple[slice, ...]:
        """The rows of each device's block of an ``n``-row batch."""
        size = self.mesh.size
        if self.axis is None:
            return (slice(0, n),) * size
        if n % size:
            raise ValueError(f"a batch of {n} does not split over the "
                             f"{size}-device mesh; pad it first")
        per = n // size
        return tuple(slice(i * per, (i + 1) * per) for i in range(size))

    def put(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """One tensor per mesh device: its block, or a copy of ``x``."""
        return tuple(x[s].to(d) for s, d in
                     zip(self.slices(len(x)), self.mesh.devices))


def data_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis (batch) sharding."""
    return Sharding(mesh, DATA_AXIS)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """A batch dict of tensors (or arrays) -> ``{key: (block on device 0,
    block on device 1, ...)}``.  The batch size must divide by the mesh
    size; callers pad a partial batch (``Trainer._pad``)."""
    sh = data_sharding(mesh)
    return {k: sh.put(torch.as_tensor(v)) for k, v in batch.items()}
