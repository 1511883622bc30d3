"""The backbones in plain PyTorch, float32, NCHW: one file under
``reference/`` for each architecture, named by a configuration file's
``arch`` (``hourglass.py``, ``resnet_deconv.py``), with ``build(config)``
and ``heads(model)``; a new architecture is a new file.

A frozen copy kept with the benchmark, so that a change to the program
cannot move what the benchmark holds it to.  No compute dtype, no int8,
no recomputation: ``nn.Conv2d``, ``nn.BatchNorm2d(eps=1e-5, momentum=
0.1)`` and ``nn.ConvTranspose2d`` as PyTorch defines them.  Module names
give ``state_dict()`` the reference's key layout (``pre.0.conv.weight``,
``hgs.0.0.up1.bn1.weight``, ``layer1.0.conv1.weight``,
``deconv_layers.3.running_var``, ``final1.bias``, ...), so one state
dict loads into the reference's model and into the program's.
"""

from __future__ import annotations

import importlib

import torch
from torch import nn


def batch_norm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def conv2d(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
           bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                     bias=bias)


def arch(config: dict):
    """The module of the configuration's architecture."""
    return importlib.import_module(f"portbench.reference.{config['arch']}")


def build(config: dict) -> nn.Module:
    """The backbone a configuration file describes."""
    return arch(config).build(config)


def heads(config: dict, model: nn.Module):
    """The (offset, heatmap) head convs of ``model``'s last stack."""
    return arch(config).heads(model)


def stacked(out: torch.Tensor) -> torch.Tensor:
    """A backbone's output as (S, B, 4J, F, F)."""
    return out if out.dim() == 5 else out[None]
