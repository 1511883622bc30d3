"""Data parallelism (the JAX package's ``parallel`` package, its data
axis).

Training: one process per GPU in a ``torch.distributed`` process group
(:mod:`~awr_tpu_torch.parallel.multihost`); the Trainer wraps the model
in ``DistributedDataParallel``, takes BatchNorm statistics over the
global batch (``models.common.GlobalBatchNorm2d``) and normalizes the
loss by the global batch's valid rows, so a step computes what one
device computes on the global batch.  Serving: a Predictor holds one
replica of the model on each device of a :class:`~.mesh.Mesh` and
splits each padded batch over them.
"""

from awr_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    data_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
