"""Carry weights into the port's hourglass and ResNet-deconv.

- :func:`load_flax_variables`: the JAX package's ``{"params",
  "batch_stats"}`` tree (nested dicts of arrays) -> the port's module;
  the inverse of the JAX package's reference-``.pth`` importer.
- :func:`load_flax_train_state`: a JAX ``TrainState`` (weights, and
  optax Adam's ``mu``/``nu``/``count``) -> the port's module and a torch
  Adam, so both packages can go on from one mid-training state;
- :func:`load_flax_quant`: the JAX package's int8 ``quant`` collection
  (``{..: {"act_scale": ()}}``) -> the port's activation scales.
- :func:`load_reference_state_dict`: a reference ``state_dict`` -> the
  port's module (the port's own key layout is the reference's).

Layouts: a conv kernel (kh, kw, in, out) becomes a weight (out, in, kh,
kw), and a flax ``transpose_kernel`` deconv kernel (kh, kw, out, in) the
``ConvTranspose2d`` weight (in, out, kh, kw): both by the permutation
(3, 2, 0, 1).  BatchNorm ``scale``/``bias``/``mean``/``var`` become
``weight``/``bias``/``running_mean``/``running_var``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from awr_tpu_torch.models.hourglass import PoseNet, Residual
from awr_tpu_torch.models.resnet import Bottleneck, ResNetDeconv


def _residual(sd_pfx, path, has_skip):
    for k in (1, 2, 3):
        yield "bn", f"{sd_pfx}.bn{k}", path + (f"bn{k}",)
        yield "conv", f"{sd_pfx}.conv{k}.conv", path + (f"conv{k}", "Conv_0")
    if has_skip:
        yield "conv", f"{sd_pfx}.skip_layer.conv", path + ("skip", "Conv_0")


def _conv_block(sd_pfx, path):
    yield "conv", f"{sd_pfx}.conv", path + ("conv", "Conv_0")
    yield "bn", f"{sd_pfx}.bn", path + ("bn",)


def _hourglass(sd_pfx, path, n):
    yield from _residual(f"{sd_pfx}.up1", path + ("up1",), False)
    yield from _residual(f"{sd_pfx}.low1", path + ("low1",), False)
    if n > 1:
        yield from _hourglass(f"{sd_pfx}.low2", path + ("low2",), n - 1)
    else:
        yield from _residual(f"{sd_pfx}.low2", path + ("low2",), False)
    yield from _residual(f"{sd_pfx}.low3", path + ("low3",), False)


def _posenet_layout(nstack):
    """(kind, state_dict prefix, flax path) for every conv and BN."""
    yield from _conv_block("pre.0", ("pre_conv",))
    yield from _residual("pre.1", ("pre_res1",), True)  # 64 -> 128
    yield from _residual("pre.3", ("pre_res2",), True)  # 128 -> 256
    yield from _residual("pre.4", ("pre_res3",), False)
    for i in range(nstack):
        yield from _hourglass(f"hgs.{i}.0", (f"hg{i}",), 4)
        yield from _residual(f"features.{i}.0", (f"feature_res{i}",), False)
        yield from _conv_block(f"features.{i}.1", (f"feature_conv{i}",))
        yield "conv", f"outs_1.{i}", (f"out_vec{i}", "Conv_0")
        yield "conv", f"outs_2.{i}", (f"out_ht{i}", "Conv_0")
        if i < nstack - 1:
            yield ("conv", f"merge_preds.{i}.conv.conv",
                   (f"merge_preds{i}", "Conv_0"))
            yield ("conv", f"merge_features.{i}.conv.conv",
                   (f"merge_features{i}", "Conv_0"))


def _resnet_layout(model: ResNetDeconv):
    """(kind, state_dict prefix, flax path) for every layer; "kernel" is
    a conv or deconv without bias, "conv" one with a bias."""
    yield "kernel", "pre.0", ("pre_conv",)
    yield "bn", "pre.1", ("pre_bn",)
    for stage in range(1, 5):
        for i, block in enumerate(getattr(model, f"layer{stage}")):
            pfx, dst = f"layer{stage}.{i}", (f"layer{stage}_{i}",)
            for c in range(1, 4 if isinstance(block, Bottleneck) else 3):
                yield "kernel", f"{pfx}.conv{c}", dst + (f"conv{c}",)
                yield "bn", f"{pfx}.bn{c}", dst + (f"bn{c}",)
            if block.downsample is not None:
                yield "kernel", f"{pfx}.downsample.0", dst + ("downsample_conv",)
                yield "bn", f"{pfx}.downsample.1", dst + ("downsample_bn",)
    for i in range(len(model.deconv_layers) // 3):
        yield "kernel", f"deconv_layers.{3 * i}", (f"deconv{i}",)
        yield "bn", f"deconv_layers.{3 * i + 1}", (f"deconv_bn{i}",)
    yield "conv", "final1", ("final1",)
    yield "conv", "final2", ("final2",)


def _layout(model: nn.Module):
    if isinstance(model, PoseNet):
        return _posenet_layout(model.nstack)
    if isinstance(model, ResNetDeconv):
        return _resnet_layout(model)
    raise TypeError(f"no flax layout for {type(model).__name__}")


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _tensor(x, perm=None):
    """float64 arrays stay float64 (a float64 model loads them exactly);
    anything else becomes float32."""
    a = np.asarray(x)
    a = a.astype(np.float64 if a.dtype == np.float64 else np.float32)
    if perm is not None:
        a = a.transpose(perm)
    return torch.tensor(a)


def _param_tensors(model: nn.Module, params) -> dict:
    """The flax ``params`` tree (or a tree of its shape, e.g. an
    optimizer moment) as the port's parameters, by state-dict key."""
    sd = {}
    for kind, key, path in _layout(model):
        p = _node(params, path)
        if kind in ("conv", "kernel"):
            sd[f"{key}.weight"] = _tensor(p["kernel"], (3, 2, 0, 1))
            if kind == "conv":
                sd[f"{key}.bias"] = _tensor(p["bias"])
        else:
            sd[f"{key}.weight"] = _tensor(p["scale"])
            sd[f"{key}.bias"] = _tensor(p["bias"])
    return sd


def load_flax_variables(model: nn.Module, variables) -> nn.Module:
    """Fill ``model`` (a PoseNet or ResNetDeconv) from the JAX package's
    variables of the same net.  Raises if a weight is missing or has
    another shape."""
    sd = _param_tensors(model, variables["params"])
    stats = variables["batch_stats"]
    for kind, key, path in _layout(model):
        if kind == "bn":
            s = _node(stats, path)
            sd[f"{key}.running_mean"] = _tensor(s["mean"])
            sd[f"{key}.running_var"] = _tensor(s["var"])
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    model.load_state_dict(sd)
    return model


def load_flax_train_state(model: nn.Module, optimizer: torch.optim.Adam,
                          state) -> nn.Module:
    """Carry a JAX package ``TrainState`` (``params``, ``batch_stats``,
    ``opt_state``) into ``model`` and its ``torch.optim.Adam``: optax
    Adam's ``mu``/``nu``/``count`` become each parameter's ``exp_avg``/
    ``exp_avg_sq``/``step``, and the injected learning rate the groups'
    ``lr``.  The two updates are then the same: lr * (m / (1 - b1^t)) /
    (sqrt(v / (1 - b2^t)) + eps)."""
    load_flax_variables(model, {"params": state.params,
                                "batch_stats": state.batch_stats})
    adam = [s for s in state.opt_state.inner_state
            if all(hasattr(s, a) for a in ("mu", "nu", "count"))]
    if len(adam) != 1:
        raise ValueError("the optimizer state holds no optax Adam state")
    mu = _param_tensors(model, adam[0].mu)
    nu = _param_tensors(model, adam[0].nu)
    step = float(np.asarray(adam[0].count))
    lr = float(np.asarray(state.opt_state.hyperparams["learning_rate"]))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    for group in optimizer.param_groups:
        group["lr"] = lr
    return model


def load_flax_quant(model: ResNetDeconv, quant) -> dict:
    """The JAX package's calibrated ``quant`` collection (``{"pre_conv":
    {"act_scale": s}, "layer1_0": {"conv1": {...}}, "deconv0": ...}``)
    as the port's activation scales for ``model``, by module name: what
    :func:`awr_tpu_torch.models.quant.set_int8` and ``Predictor.quant``
    take.  Raises if a quantized layer has no scale."""
    return {key: torch.tensor(float(np.asarray(
                _node(quant, path)["act_scale"])), dtype=torch.float32)
            for kind, key, path in _layout(model) if kind == "kernel"}


def _unused_reference_key(model: nn.Module, key: str) -> bool:
    """BatchNorm batch counters, and the skip conv that the reference
    builds, but never runs, on residuals that keep their width."""
    if key.endswith("num_batches_tracked"):
        return True
    prefix, sep, rest = key.partition(".skip_layer.")
    if not sep or rest not in ("conv.weight", "conv.bias"):
        return False
    try:
        block = model.get_submodule(prefix)
    except AttributeError:
        return False
    return isinstance(block, Residual) and block.skip_layer is None


def load_reference_state_dict(model: nn.Module, sd) -> nn.Module:
    """Load a reference ``state_dict`` (tensors or arrays).  Raises on a
    missing key and on any unexpected key other than the reference's
    unused identity-residual ``skip_layer`` and ``num_batches_tracked``."""
    own = model.state_dict()
    missing = [k for k in own
               if k not in sd and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in sd
                  if k not in own and not _unused_reference_key(model, k)]
    if missing or unexpected:
        raise KeyError(f"state dict does not fit {type(model).__name__}: "
                       f"missing {missing[:5]}, unexpected {unexpected[:5]}")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()
                           if k in own}, strict=False)
    return model
