"""Device meshes and sharding (the JAX package's ``parallel/mesh.py``).

A :class:`Mesh` is a tuple of ``torch.device``s on one axis, the data
axis (:func:`make_mesh`) or the spatial one (:func:`spatial_mesh`).
PyTorch has no global-view arrays, so a sharding here is explicit: a
batch is split into one tensor per mesh device (:func:`shard_batch`),
and a replicated tensor or module is one copy per device
(:func:`replicated`).  The blocks are those of ``NamedSharding(mesh,
P("data"))``: the leading axis in contiguous, equal blocks, in mesh
order; or, for :func:`spatial_sharding`, those of ``P(None,
"spatial")``: the image rows (axis 1) of (B, H, W) frames.

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
SPATIAL_AXIS = "spatial"


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


def _mesh_devices(n_devices: Optional[int], devices: Optional[Sequence]):
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
    return tuple(devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A data-parallel mesh over the visible CUDA devices (the first
    ``n_devices`` of them), or over ``devices`` as given (names or
    ``torch.device``s, repeats allowed)."""
    return Mesh(_mesh_devices(n_devices, devices), DATA_AXIS)


def spatial_mesh(n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A mesh that splits the image HEIGHT of a request over its devices
    (the JAX package's ``spatial_mesh``), for latency serving: a
    Predictor on it runs each request band by band
    (:mod:`~awr_tpu_torch.parallel.spatial`).  Devices as
    :func:`make_mesh` takes them."""
    return Mesh(_mesh_devices(n_devices, devices), SPATIAL_AXIS)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a value lies on a mesh: split along its axis ``dim`` (``axis``
    :data:`DATA_AXIS`, ``dim`` 0, the batch; or :data:`SPATIAL_AXIS`,
    ``dim`` 1, the image rows) or copied whole (``axis`` None)."""

    mesh: Mesh
    axis: Optional[str]
    dim: int = 0

    def slices(self, n: int) -> Tuple[slice, ...]:
        """The indices of each device's block of ``n`` along ``dim``."""
        size = self.mesh.size
        if self.axis is None:
            return (slice(0, n),) * size
        if n % size:
            if self.axis == SPATIAL_AXIS:
                raise ValueError(f"an image of {n} rows does not split "
                                 f"over the {size}-device mesh")
            raise ValueError(f"a batch of {n} does not split over the "
                             f"{size}-device mesh; pad it first")
        per = n // size
        return tuple(slice(i * per, (i + 1) * per) for i in range(size))

    def put(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """One tensor per mesh device: its block, or a copy of ``x``."""
        lead = (slice(None),) * self.dim
        return tuple(x[lead + (s,)].to(d) for s, d in
                     zip(self.slices(x.shape[self.dim]), self.mesh.devices))


def data_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis (batch) sharding."""
    return Sharding(mesh, DATA_AXIS)


def spatial_sharding(mesh: Mesh) -> Sharding:
    """(B, H, W) frames split by image rows (axis 1) into equal bands;
    H must divide by the mesh size (``ValueError`` otherwise), as
    ``jax.device_put`` on the JAX package's ``spatial_sharding``
    demands."""
    return Sharding(mesh, SPATIAL_AXIS, dim=1)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """A batch dict of tensors (or arrays) -> ``{key: (block on device 0,
    block on device 1, ...)}``.  The batch size must divide by the mesh
    size; callers pad a partial batch (``Trainer._pad``)."""
    sh = data_sharding(mesh)
    return {k: sh.put(torch.as_tensor(v)) for k, v in batch.items()}
