"""Experiment configuration of the PyTorch port.

The same fields and defaults as the JAX package's ``Config`` (the
reference's NYU recipe), minus the JAX-only knobs (device mesh, matmul
precision, Pallas switch): on a CUDA tensor the port always runs its
hand-written kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Per-dataset tables (reference config.py:1-18).
JOINT = {"nyu": 14, "icvl": 16, "msra": 21, "hands17": 21}
STEP = {"nyu": 30, "icvl": 10, "msra": 10, "hands17": 5}
EPOCH = {"nyu": 40, "icvl": 40, "msra": 25, "hands17": 10}

# Compute dtypes by name (the JAX package's ``DTYPES``).  Parameters,
# BatchNorm statistics, optimizer state and checkpoints stay float32 in
# either.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Camera intrinsics (fx, fy, u0, v0) per dataset.
NYU_PARAS = (588.03, 587.07, 320.0, 240.0)
DATASET_PARAS = {
    "nyu": NYU_PARAS,
    "icvl": (241.42, 241.42, 160.0, 120.0),
    "msra": (241.42, 241.42, 160.0, 120.0),
}
# y-axis flip in xyz<->uvd transforms (reference nyu_loader.py:34)
DATASET_FLIP = {"nyu": -1, "icvl": 1, "msra": 1, "hands17": 1}
# crop cube defaults (mm)
DATASET_CUBE = {
    "nyu": (300.0, 300.0, 300.0),
    "icvl": (250.0, 250.0, 250.0),
    "msra": (200.0, 200.0, 200.0),
    "hands17": (300.0, 300.0, 300.0),
}


@dataclasses.dataclass
class Config:
    """All knobs for data, model, optimization and evaluation.

    Defaults follow the reference's published NYU recipe
    (reference config.py:19-52).
    """

    # --- experiment bookkeeping ---
    exp_id: str = "nyu_hourglass"
    log_id: str = "dense"
    data_dir: str = "./data"
    dataset: str = "nyu"
    output_dir: str = "./output/"
    load_model: str = ""

    # --- geometry / data ---
    jt_num: int = JOINT["nyu"]
    cube: Tuple[float, float, float] = (300.0, 300.0, 300.0)
    # (sigma_trans mm, sigma_scale, sigma_rot deg)
    augment_para: Tuple[float, float, float] = (10.0, 0.1, 180.0)
    img_size: int = 128
    batch_size: int = 32
    num_workers: int = 8

    # --- model ---
    net: str = "hourglass_1"  # 'hourglass_<nstack>' | 'resnet_{18,50,101,152}'
    downsample: int = 2  # output stride in {1,2,4}

    # --- optimization ---
    max_epoch: int = EPOCH["nyu"]
    loss_type: str = "MyL1Loss"
    dense_weight: float = 1.0
    coord_weight: float = 0.0
    kernel_size: float = 0.4  # 0.4 for hourglass, 1.0 for resnet
    lr: float = 1e-3
    optimizer: str = "adam"  # 'adam' | 'sgd'
    scheduler: str = "step"  # 'step' | 'auto' (ReduceLROnPlateau)
    step: int = STEP["nyu"]
    weight_decay: float = 0.0
    print_freq: int = 100
    vis_freq: int = 1

    # --- additions of the JAX package kept by the port ---
    param_dtype: str = "float32"
    # "float32" or "bfloat16": the dtype the convs, BatchNorm outputs and
    # heads run in; the dense map leaves the model as float32
    compute_dtype: str = "float32"
    supervise_all_stacks: bool = True
    device_prefetch: int = 2
    grad_accum: int = 1
    remat: bool = False
    step_timeout_s: Optional[float] = None
    seed: int = 23455
    ckpt_max_to_keep: Optional[int] = None

    def __post_init__(self):
        if self.compute_dtype not in DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: one of "
                             f"{sorted(DTYPES)}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def feature_size(self) -> int:
        """Side of the dense 4J-channel output map."""
        return self.img_size // self.downsample

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def nstack(self) -> int:
        if self.net.startswith("hourglass"):
            return int(self.net.split("_")[-1])
        return 1

    @property
    def paras(self) -> Tuple[float, float, float, float]:
        try:
            return DATASET_PARAS[self.dataset]
        except KeyError:
            raise NotImplementedError(
                f"unknown dataset {self.dataset!r}") from None

    @property
    def flip(self) -> int:
        return DATASET_FLIP.get(self.dataset, 1)


def resnet_config(layers: int = 18, **kw) -> Config:
    """Reference resnet recipe: kernel_size 1.0 (reference config.py:42)."""
    kw.setdefault("kernel_size", 1.0)
    kw.setdefault("exp_id", f"nyu_resnet{layers}")
    return Config(net=f"resnet_{layers}", **kw)


def hourglass_config(nstack: int = 1, **kw) -> Config:
    kw.setdefault("kernel_size", 0.4)
    return Config(net=f"hourglass_{nstack}", **kw)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a GPU, CUDA (named or by default) is an error, never
    a silent CPU run."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return device
