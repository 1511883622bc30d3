"""The inference form of a ResNet-deconv (:mod:`awr_tpu_torch.models.resnet`):
the frozen serving backbone as a few fused layers.

Built once from an eval-mode module, it holds:

- every conv -> BatchNorm pair folded into one conv: W' = W * s and bias
  b' = beta - mu * s per output channel, s = gamma / sqrt(var + eps)
  (the output channel of a transposed conv's (in, out, kh, kw) weight is
  dim 1), computed in float64 from the module's float32 parameters and
  running statistics; W' rounded once to the compute dtype and stored
  channels-last, b' kept in float32 (or the compute dtype where that is
  wider);
- a block's ``downsample`` as its conv alone: its bias joins the bias of
  the block's last conv, whose epilogue adds the residual;
- the two 1x1 heads as one conv of 4J outputs, their weights and biases
  concatenated.

The activations are channels-last (NHWC) from the stem to the heads, so
cuDNN's bf16 convs read and write them as they lie, with no transposes.
Each conv (and transposed conv) is followed by one pass that adds its
bias and, in a block's last conv, the residual, then applies the ReLU, in
the bias's dtype with one rounding (the op ``awr_tpu_torch::bias_relu_``).
The stem's conv, its bias and ReLU and the max-pool after it are one
pass (``::stem_pool``).  The map leaves as float32 (the compute dtype if
wider) NCHW contiguous, the heads' bias added in that one conversion
(``::head_out``).  On a GPU those three ops run hand-written kernels
(``csrc/folded.cu``), on the CPU their plain versions
(:mod:`awr_tpu_torch.ops.library`).

cuDNN's runtime-fused plans (``torch.cudnn_convolution_relu`` and
``_add_relu``) would put the bias, residual and ReLU in the conv's own
epilogue, but on the H100 they compiled for about 13 s at their first
call and ran the form no faster (PERF.md §6).

:func:`inference_form` decides from what it can observe whether a model
takes this form; ``serving.Predictor`` serves through it on one device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from awr_tpu_torch.models.quant import quant_layers
from awr_tpu_torch.models.resnet import ResNetDeconv
from awr_tpu_torch.ops.library import bias_relu_, head_out, stem_pool


class FoldedConv(NamedTuple):
    """A conv with its BatchNorm folded in: ``weight`` channels-last in
    the compute dtype, ``bias`` (out,) in the epilogue's dtype (None: the
    bias is added elsewhere)."""

    weight: torch.Tensor
    bias: Optional[torch.Tensor]
    stride: int
    padding: int


class FoldedBlock(NamedTuple):
    """A residual block: ``convs`` in order (ReLU after each, the last
    adding the residual), ``downsample`` (no bias, no ReLU) or None."""

    convs: List[FoldedConv]
    downsample: Optional[FoldedConv]


def _scale_shift(bn: nn.BatchNorm2d):
    """Eval BatchNorm as y = x * scale + shift, per channel, float64."""
    scale = bn.weight.double() / torch.sqrt(bn.running_var.double()
                                            + bn.eps)
    return scale, bn.bias.double() - bn.running_mean.double() * scale


def _fold(conv: nn.Module, bn: nn.BatchNorm2d, dtype, extra_bias=None):
    """``conv`` -> ``bn`` as one :class:`FoldedConv` in ``dtype``
    (``extra_bias``, float64, added to its bias)."""
    transposed = isinstance(conv, nn.ConvTranspose2d)
    scale, shift = _scale_shift(bn)
    w = conv.weight.detach().double()
    w = w * (scale[None, :, None, None] if transposed
             else scale[:, None, None, None])
    if extra_bias is not None:
        shift = shift + extra_bias
    return FoldedConv(
        w.to(dtype).contiguous(memory_format=torch.channels_last),
        shift.to(torch.promote_types(dtype, torch.float32)),
        conv.stride[0], conv.padding[0])


class FoldedResNetDeconv(nn.Module):
    """(B, 1, H, W) depth -> (B, 4J, H/ds, W/ds) map: ``model``'s eval
    forward with its BatchNorms folded, in ``dtype`` (default the
    model's compute dtype, else its parameters').  A snapshot: later
    changes to ``model`` do not reach it."""

    def __init__(self, model: ResNetDeconv, dtype=None):
        super().__init__()
        if dtype is None:
            dtype = model.compute_dtype or model.final1.weight.dtype
        self.dtype = dtype
        map_dtype = torch.promote_types(dtype, torch.float32)
        with torch.no_grad():
            self.stem = _fold(model.pre[0], model.pre[1], dtype)
            self.blocks = [self._block(b) for stage in (
                model.layer1, model.layer2, model.layer3, model.layer4)
                for b in stage]
            layers = list(model.deconv_layers)
            self.deconvs = [_fold(layers[i], layers[i + 1], dtype)
                            for i in range(0, len(layers), 3)]
            heads = (model.final1, model.final2)
            self.head_weight = torch.cat([h.weight.detach() for h in heads]
                                         ).to(dtype).contiguous(
                memory_format=torch.channels_last)
            self.head_bias = torch.cat([h.bias.detach() for h in heads]).to(
                map_dtype)

    def _block(self, block: nn.Module) -> FoldedBlock:
        n = 3 if hasattr(block, "conv3") else 2
        pairs = [(getattr(block, f"conv{i}"), getattr(block, f"bn{i}"))
                 for i in range(1, n + 1)]
        ds, ds_bias = None, None
        if block.downsample is not None:
            ds_conv, ds_bn = block.downsample
            ds = _fold(ds_conv, ds_bn, self.dtype)._replace(bias=None)
            ds_bias = _scale_shift(ds_bn)[1]
        convs = [_fold(c, b, self.dtype) for c, b in pairs[:-1]]
        convs.append(_fold(*pairs[-1], self.dtype, extra_bias=ds_bias))
        return FoldedBlock(convs, ds)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = stem_pool(x, self.stem.weight, self.stem.bias)
        for block in self.blocks:
            ds = block.downsample
            residual = x if ds is None else F.conv2d(
                x, ds.weight, None, ds.stride, ds.padding)
            for i, c in enumerate(block.convs, start=1):
                x = bias_relu_(F.conv2d(x, c.weight, None, c.stride,
                                        c.padding), c.bias,
                               residual if i == len(block.convs) else None)
        for d in self.deconvs:
            x = bias_relu_(F.conv_transpose2d(x, d.weight, None, d.stride,
                                              d.padding), d.bias)
        return head_out(F.conv2d(x, self.head_weight), self.head_bias)


def inference_form(model: nn.Module) -> Optional[FoldedResNetDeconv]:
    """``model``'s inference form where it applies, else None: a
    :class:`~awr_tpu_torch.models.resnet.ResNetDeconv` computing in
    bfloat16, every module in eval mode, every quantizable layer in mode
    "off".  (A train-mode BatchNorm normalizes with the batch's
    statistics, and int8 layers run their own kernels.)"""
    if not (isinstance(model, ResNetDeconv)
            and model.compute_dtype == torch.bfloat16
            and not any(m.training for m in model.modules())
            and all(m.mode == "off" for m in quant_layers(model).values())):
        return None
    return FoldedResNetDeconv(model)
