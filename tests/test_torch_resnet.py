"""The port's ResNet-deconv against the JAX package's under the same
weights (carried across by ``load_flax_variables``), its reference key
layout, and the two repairs an unstacked backbone needed: the steps'
``_stacked`` and ``torch_default_init_`` on transposed convs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_weights import resnet_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.models.common import max_pool_torch as jax_max_pool_torch
from awr_tpu.models.torch_import import import_resnet_deconv
from awr_tpu_torch.config import resnet_config
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import max_pool_torch, torch_default_init_
from awr_tpu_torch.models.resnet import RESNET_SPECS
from awr_tpu_torch.models.weights import (load_flax_variables,
                                          load_reference_state_dict)
from awr_tpu_torch.ops.decode import decode_offsets
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.training.steps import (make_eval_step, make_infer_step,
                                          make_train_step)

IMG = 32
# (depth, downsample): the slice's resnet_18 and one Bottleneck net
NETS = [(18, 2), (50, 4)]


@pytest.fixture(scope="module", params=NETS, ids=lambda n: f"resnet_{n[0]}_ds{n[1]}")
def net(request):
    layers, ds = request.param
    jmodel, variables = resnet_variables(layers, ds, IMG, seed=layers)
    model = load_flax_variables(build_model(f"resnet_{layers}", 14, ds),
                                variables).eval()
    return layers, ds, jmodel, variables, model


def test_forward_matches_flax(net):
    layers, ds, jmodel, variables, model = net
    x = np.random.RandomState(2).uniform(-1, 1, (2, IMG, IMG)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x[..., None]),
                                   train=False))  # (B, F, F, 4J)
    with torch.no_grad():
        got = model(torch.from_numpy(x[:, None])).numpy()  # (B, 4J, F, F)
    F = IMG // ds
    assert got.shape == (2, 56, F, F)
    assert want.std() > 0.05  # the maps are not near-constant
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=1e-4,
                               atol=1e-4)


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, path + (k,)))
        return out
    return {path: np.asarray(tree)}


def test_state_dict_is_reference_layout(net):
    """The JAX package's reference-.pth importer reads the port's state
    dict back into exactly the flax tree it was loaded from."""
    layers, ds, _, variables, model = net
    block, sizes = RESNET_SPECS[layers]
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = _flatten(import_resnet_deconv(
        sd, sizes, bottleneck=block == "bottleneck", downsample=ds))
    want = _flatten(variables)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))


def test_load_reference_state_dict_resnet():
    gen = torch.Generator().manual_seed(0)
    src = torch_default_init_(build_model("resnet_18", 14), gen)
    sd = dict(src.state_dict())
    dst = load_reference_state_dict(build_model("resnet_18", 14), sd)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_state_dict(build_model("resnet_18", 14),
                                  {**sd, "layer1.0.conv3.weight": sd["final1.bias"]})
    del sd["deconv_layers.3.weight"]
    with pytest.raises(KeyError, match="deconv_layers.3.weight"):
        load_reference_state_dict(build_model("resnet_18", 14), sd)


@pytest.mark.parametrize("layers,ds,n_deconv", [(18, 1, 4), (18, 4, 2),
                                                (101, 2, 3), (152, 2, 3)])
def test_build_model_depths_and_strides(layers, ds, n_deconv):
    model = build_model(f"resnet_{layers}", 14, ds)
    assert len(model.deconv_layers) == 3 * n_deconv
    assert [len(getattr(model, f"layer{s}")) for s in (1, 2, 3, 4)] == list(
        RESNET_SPECS[layers][1])
    # the reference's inits: He fan-out encoder, N(0, 0.001) decoder/heads
    w = model.layer1[0].conv1.weight.detach()
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) * np.sqrt(fan_out / 2.0) - 1) < 0.1
    assert float(model.deconv_layers[0].weight.detach().std()) < 0.0011
    assert not model.final1.bias.any()


def test_resnet_options():
    with pytest.raises(ValueError, match="depth"):
        build_model("resnet_34", 14)
    with pytest.raises(ValueError, match="downsample"):
        build_model("resnet_18", 14, 8)
    cfg = resnet_config()
    assert (cfg.net, cfg.kernel_size, cfg.nstack, cfg.feature_size,
            cfg.exp_id) == ("resnet_18", 1.0, 1, 64, "nyu_resnet18")


def test_max_pool_torch_pads_with_minus_inf():
    x = -1 - np.random.RandomState(0).rand(2, 7, 9, 3).astype(np.float32)
    want = np.asarray(jax_max_pool_torch(jnp.asarray(x), 3, 2, 1))
    got = max_pool_torch(3, 2, 1)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# --- repair: the steps take an unstacked (B, 4J, F, F) map as one stack

def _resnet_at_img(img=IMG):
    cfg = resnet_config(img_size=img)
    model = torch_default_init_(build_model(cfg.net, cfg.jt_num),
                                torch.Generator().manual_seed(1))
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (3, img, img)).astype(np.float32))
    jt = torch.from_numpy(rng.uniform(-0.8, 0.8, (3, 14, 3)).astype(np.float32))
    return cfg, model, x, jt


def test_steps_take_an_unstacked_map():
    """Each step decodes the whole (B, 4J, F, F) map; indexing it as a
    stack would have decoded the last sample."""
    cfg, model, x, jt = _resnet_at_img()
    model.eval()
    with torch.no_grad():
        want = decode_offsets(model(x[:, None]), x, cfg.kernel_size)
    got = make_infer_step(model, cfg)(x)
    assert got.shape == (3, 14, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    m = make_eval_step(model, cfg)({"img": x, "jt_uvd": jt})
    torch.testing.assert_close(m["jt_uvd_pred"], want, rtol=0, atol=0)

    step = make_train_step(model, make_optimizer(model.parameters(), "adam",
                                                 1e-3), cfg)
    m = step({"img": x, "jt_uvd": jt})
    assert m["jt_uvd_pred"].shape == (3, 14, 3)
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
    assert model.final2.weight.grad is not None


# --- repair: torch_default_init_ re-draws transposed convs too

def test_torch_default_init_covers_transposed_convs():
    a = torch_default_init_(build_model("resnet_18", 14),
                            torch.Generator().manual_seed(3))
    b = torch_default_init_(build_model("resnet_18", 14),
                            torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    for i in range(3):
        w = a.deconv_layers[3 * i].weight.detach()  # (in, out, 4, 4)
        bound = 1.0 / np.sqrt(w[0].numel())  # fan_in = out * 16
        assert float(w.abs().max()) <= bound
        # drawn from the generator, not left at the constructor's N(0, .001)
        assert float(w.abs().max()) > 0.9 * bound
