"""Backbones emitting dense (B, 4J, F, F) AWR maps: the hourglass stacked
per stage, (S, B, 4J, F, F); the ResNet-deconv unstacked.

:func:`build_model` is the reference's net-string factory
('hourglass_2', 'resnet_18', ...; reference train.py:51-57).
"""

from torch import nn

from awr_tpu_torch.models.hourglass import PoseNet
from awr_tpu_torch.models.resnet import get_deconv_net


def build_model(net: str, joint_num: int, downsample: int = 2,
                remat: bool = False) -> nn.Module:
    """``remat``: recompute each hourglass stack's encoder-decoder, or each
    ResNet block, in the backward pass instead of storing its
    activations (``Config.remat``)."""
    if net.startswith("hourglass"):
        if downsample != 2:
            raise ValueError("the hourglass has output stride 2")
        return PoseNet(nstack=int(net.split("_")[1]), joint_num=joint_num,
                       remat=remat)
    if net.startswith("resnet"):
        return get_deconv_net(int(net.split("_")[1]), joint_num, downsample,
                              remat=remat)
    raise ValueError(f"unknown net {net!r}")
