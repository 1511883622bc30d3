"""Backbones emitting dense (B, 4J, F, F) AWR maps: the hourglass stacked
per stage, (S, B, 4J, F, F); the ResNet-deconv unstacked.

:func:`build_model` is the reference's net-string factory
('hourglass_2', 'resnet_18', ...; reference train.py:51-57).
"""

from torch import nn

from awr_tpu_torch.models.common import set_compute_dtype
from awr_tpu_torch.models.hourglass import PoseNet
from awr_tpu_torch.models.resnet import get_deconv_net


def build_model(net: str, joint_num: int, downsample: int = 2,
                remat: bool = False, compute_dtype=None) -> nn.Module:
    """``remat``: recompute each hourglass stack's encoder-decoder, or each
    ResNet block, in the backward pass instead of storing its
    activations (``Config.remat``).  ``compute_dtype``: the ``torch.dtype``
    the model computes in (``Config.torch_compute_dtype``; the JAX
    package's ``dtype``), its parameters' dtype if None."""
    if net.startswith("hourglass"):
        if downsample != 2:
            raise ValueError("the hourglass has output stride 2")
        model = PoseNet(nstack=int(net.split("_")[1]), joint_num=joint_num,
                        remat=remat)
    elif net.startswith("resnet"):
        model = get_deconv_net(int(net.split("_")[1]), joint_num, downsample,
                               remat=remat)
    else:
        raise ValueError(f"unknown net {net!r}")
    return set_compute_dtype(model, compute_dtype)
