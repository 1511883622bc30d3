"""Depth data pipeline.

Host side (numpy, reference-exact): depth-PNG decode, crop geometry,
normalization, choose-one augmentation (:mod:`awr_tpu_torch.data.transforms`,
:mod:`awr_tpu_torch.data.cvwarp`) and the dataset loaders.

Device side: the same crop/normalize/augmentation as batched torch ops
from the raw depth frames (:mod:`awr_tpu_torch.data.device`).

Synthetic data where the real files are absent:
:mod:`awr_tpu_torch.data.synthetic`.
"""

from awr_tpu_torch.data.hands17 import Hands17Dataset  # noqa: F401
from awr_tpu_torch.data.icvl import ICVLDataset  # noqa: F401
from awr_tpu_torch.data.msra import MSRADataset  # noqa: F401
from awr_tpu_torch.data.nyu import NYUDataset  # noqa: F401
from awr_tpu_torch.data.synthetic import SyntheticHandDataset  # noqa: F401
