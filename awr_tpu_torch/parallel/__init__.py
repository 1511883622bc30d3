"""Data and spatial parallelism (the JAX package's ``parallel``
package).

Training: one process per GPU in a ``torch.distributed`` process group
(:mod:`~awr_tpu_torch.parallel.multihost`); the Trainer wraps the model
in ``DistributedDataParallel``, takes BatchNorm statistics over the
global batch (``models.common.GlobalBatchNorm2d``) and normalizes the
loss by the global batch's valid rows, so a step computes what one
device computes on the global batch.  Serving: a Predictor holds one
replica of the model on each device of a :class:`~.mesh.Mesh` and
splits each padded batch over them; on a spatial mesh it splits each
request's image rows over them instead and runs the model band by band
(:mod:`~awr_tpu_torch.parallel.spatial`).
"""

from awr_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    data_sharding,
    make_mesh,
    replicated,
    shard_batch,
    spatial_mesh,
    spatial_sharding,
)
