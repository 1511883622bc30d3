"""Process groups and per-rank data (the JAX package's
``parallel/multihost.py``).

One process per GPU, as PyTorch runs data parallelism: a launcher
(``python -m torch.distributed.run --nproc_per_node N ...``) starts N
processes and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; :func:`initialize_distributed`
joins them into a process group (NCCL on CUDA, gloo on the CPU).  The
JAX package instead runs one process per host that drives every local
chip.

PyTorch has no global-view arrays.  Where the JAX package assembles a
global array from each host's rows, here each rank keeps its own rows
as tensors on its own device (:func:`host_local_batch_to_global`,
:func:`rank_rows`); collectives combine what the ranks compute.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from awr_tpu_torch.config import resolve_device
from awr_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> None:
    """``torch.distributed.init_process_group`` for this process; a
    no-op when a process group exists already (so it is idempotent) and
    for a single process.

    Unset arguments come from the launcher's environment: ``WORLD_SIZE``
    (1 without a launcher), ``RANK``, and ``MASTER_ADDR:MASTER_PORT``.
    ``coordinator_address`` is ``host:port`` (TCP) or an init URL such as
    ``file:///shared/path``.  ``device``: the device the ranks compute on
    (default CUDA): NCCL on CUDA, gloo on the CPU.  On CUDA the rank's
    current device becomes :func:`local_device`'s."""
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=coordinator_address,
                            world_size=int(num_processes),
                            rank=int(process_id))


def shutdown_distributed() -> None:
    """Destroy this process's group, if it has one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple:
    """``(rank, world size)`` of this process: ``(0, 1)`` without a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device(device=None) -> torch.device:
    """The device this rank computes on: ``device`` (default CUDA, as
    :func:`~awr_tpu_torch.config.resolve_device`), and for CUDA without
    an index under a process group the launcher's ``LOCAL_RANK`` (else
    the current device)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        if dist.is_initialized() and "LOCAL_RANK" in os.environ:
            return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        return torch.device("cuda", torch.cuda.current_device())
    return device


def global_mesh(axis_name: str = DATA_AXIS, device=None) -> Mesh:
    """This rank's view of the data-parallel mesh: the one device it
    addresses (a rank cannot place tensors on another rank's device; the
    process group spans the ranks)."""
    return Mesh((local_device(device),), axis_name)


def rank_rows(n: int, world_size: int, rank: int,
              grad_accum: int = 1) -> np.ndarray:
    """The rows of an ``n``-row global batch that ``rank`` holds: the
    batch splits into ``grad_accum`` microbatches, and each microbatch
    into ``world_size`` contiguous blocks, as the JAX package shards
    every microbatch over the mesh.  So the rank's microbatch i is its
    block of global microbatch i (with one microbatch, its contiguous
    block of the batch)."""
    accum = max(1, int(grad_accum))
    if n % accum:
        raise ValueError(f"batch size {n} not divisible by grad_accum "
                         f"{accum}")
    mb = n // accum
    if mb % world_size:
        raise ValueError(
            f"microbatch {mb} (batch {n} / grad_accum {accum}) not "
            f"divisible by the {world_size}-device data-parallel mesh")
    per = mb // world_size
    return np.concatenate([np.arange(i * mb + rank * per,
                                     i * mb + (rank + 1) * per)
                           for i in range(accum)])


def host_local_batch_to_global(batch: dict, mesh: Mesh,
                               axis_name: str = DATA_AXIS) -> dict:
    """The global host batch dict (every rank holds the same one) -> this
    rank's rows as tensors on its device ``mesh.devices[0]``
    (:func:`global_mesh`): its contiguous block, the block
    :func:`~awr_tpu_torch.parallel.mesh.shard_batch` gives the rank's
    device on a mesh of one device a rank.  The JAX function instead
    takes each host's own rows and returns one global-view array;
    without such arrays the rows stay apart, one tensor a rank.
    ``axis_name`` is the mesh's axis, kept for the JAX signature."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis {mesh.axis_name!r}, not {axis_name!r}")
    rank, size = world()
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(np.asarray(v))
        rows = torch.from_numpy(rank_rows(len(v), size, rank))
        out[k] = v[rows].to(mesh.devices[0])
    return out
