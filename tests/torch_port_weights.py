"""Seeded JAX-package hourglass and ResNet-deconv weights for the port's
parity tests."""

import jax
import jax.numpy as jnp
import numpy as np

from awr_tpu.models import build_model as jax_build_model

IMG = 32  # F = 16: the depth-4 hourglass needs F % 16 == 0


def flax_variables(nstack, seed=0):
    """Seeded flax init, with BatchNorm affine params and running stats
    randomized (seeded numpy) so eval-mode BN is not the identity."""
    model = jax_build_model(f"hourglass_{nstack}", 14)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 1)),
                   train=False)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, dict(v["params"]))
    stats = jax.tree_util.tree_map(np.asarray, dict(v["batch_stats"]))

    def bn_params(node):
        n = node["scale"].shape
        return {"scale": (1 + 0.2 * rng.randn(*n)).astype(np.float32),
                "bias": (0.1 * rng.randn(*n)).astype(np.float32)}

    def bn_stats(node):
        n = node["mean"].shape
        return {"mean": (0.1 * rng.randn(*n)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}

    def walk(tree, is_bn, fn):
        if is_bn(tree):
            return fn(tree)
        return {k: walk(v, is_bn, fn) if isinstance(v, dict) else v
                for k, v in tree.items()}

    params = walk(params, lambda t: "scale" in t, bn_params)
    stats = walk(stats, lambda t: "mean" in t, bn_stats)
    return model, {"params": params, "batch_stats": stats}


def random_variables(nstack, seed=0):
    """The JAX hourglass and variables with every parameter and running
    mean N(0, 0.05^2) and every running var |N(0, 1)| + 0.5, the
    distribution tests/test_train_dynamics_oracle.py gives the reference's
    weights.  Its gradients stand well above the float noise floor, so
    Adam's normalization does not turn roundoff into lr-sized updates.
    Only the shapes of flax's init are taken (``eval_shape``)."""
    model = jax_build_model(f"hourglass_{nstack}", 14)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 1)), train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (np.abs(rng.randn(*leaf.shape)) + 0.5).astype(np.float32)
        return (0.05 * rng.randn(*leaf.shape)).astype(np.float32)

    return model, {k: jax.tree_util.tree_map_with_path(draw, dict(shapes[k]))
                   for k in ("params", "batch_stats")}


def resnet_variables(layers, downsample, img, seed=0):
    """The JAX ResNet-deconv and seeded variables that give non-degenerate
    maps (the reference's N(0, 0.001) deconvs and heads give near-constant
    ones): every conv and deconv kernel U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    with PyTorch's fan_in (kh * kw * shape[2] in both flax layouts), head
    biases N(0, 0.05^2), BatchNorm as in :func:`flax_variables`.  Only
    the shapes of flax's init are taken (``eval_shape``)."""
    model = jax_build_model(f"resnet_{layers}", 14, downsample)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 1)), train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if name.endswith("['kernel']"):
            bound = 1.0 / np.sqrt(shape[0] * shape[1] * shape[2])
            a = rng.uniform(-bound, bound, shape)
        elif name.endswith("['scale']"):
            a = 1 + 0.2 * rng.randn(*shape)
        elif name.endswith("['var']"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("['mean']"):
            a = 0.1 * rng.randn(*shape)
        else:  # BatchNorm and head biases
            a = (0.1 if "bn" in name else 0.05) * rng.randn(*shape)
        return a.astype(np.float32)

    return model, {k: jax.tree_util.tree_map_with_path(draw, dict(shapes[k]))
                   for k in ("params", "batch_stats")}
