"""The port's hourglass against the JAX package's, under the same weights
carried across by ``load_flax_variables``; the port's state dict keys
are the reference's layout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_weights import IMG, flax_variables
from torch_port_weights import one_thread  # noqa: F401

from awr_tpu.models.torch_import import import_posenet
from awr_tpu_torch.config import Config, hourglass_config
from awr_tpu_torch.models import build_model
from awr_tpu_torch.models.common import torch_default_init_
from awr_tpu_torch.models.quant import set_quant_mode
from awr_tpu_torch.models.weights import (load_flax_variables,
                                          load_reference_state_dict)
from awr_tpu_torch.serving import Predictor

def port_model(nstack, variables):
    return load_flax_variables(build_model(f"hourglass_{nstack}", 14),
                               variables).eval()


@pytest.mark.parametrize("nstack", [1, 2])
def test_posenet_forward_matches_flax(nstack):
    jmodel, variables = flax_variables(nstack, seed=nstack)
    model = port_model(nstack, variables)
    x = np.random.RandomState(2).uniform(-1, 1, (2, IMG, IMG)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x[..., None]),
                                   train=False))  # (S, B, F, F, 4J)
    with torch.no_grad():
        got = model(torch.from_numpy(x[:, None])).numpy()  # (S, B, 4J, F, F)
    assert got.shape == (nstack, 2, 56, IMG // 2, IMG // 2)
    np.testing.assert_allclose(got, want.transpose(0, 1, 4, 2, 3),
                               rtol=1e-4, atol=1e-4)


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, path + (k,)))
        return out
    return {path: np.asarray(tree)}


@pytest.mark.parametrize("nstack", [1, 2])
def test_state_dict_is_reference_layout(nstack):
    """The JAX package's reference-.pth importer reads the port's state
    dict back into exactly the flax tree it was loaded from."""
    _, variables = flax_variables(nstack)
    sd = {k: v.numpy() for k, v in port_model(nstack, variables)
          .state_dict().items()}
    back = _flatten(import_posenet(sd, nstack=nstack))
    want = _flatten(variables)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))


def test_load_reference_state_dict():
    gen = torch.Generator().manual_seed(0)
    src = torch_default_init_(build_model("hourglass_1", 14), gen)
    sd = dict(src.state_dict())
    # the reference builds (and saves) a skip conv on identity residuals
    sd["pre.4.skip_layer.conv.weight"] = torch.zeros(256, 256, 1, 1)
    sd["pre.4.skip_layer.conv.bias"] = torch.zeros(256)
    dst = load_reference_state_dict(build_model("hourglass_1", 14), sd)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)

    with pytest.raises(KeyError, match="unexpected"):
        load_reference_state_dict(build_model("hourglass_1", 14),
                                  {**sd, "pre.4.conv4.weight": sd["pre.0.conv.bias"]})
    del sd["outs_2.0.bias"]
    with pytest.raises(KeyError, match="outs_2.0.bias"):
        load_reference_state_dict(build_model("hourglass_1", 14), sd)


def test_torch_default_init_is_seeded():
    a = torch_default_init_(build_model("hourglass_1", 14),
                            torch.Generator().manual_seed(3))
    b = torch_default_init_(build_model("hourglass_1", 14),
                            torch.Generator().manual_seed(3))
    w = a.pre[0].conv.weight.detach()
    assert float(w.abs().max()) <= 1 / 5.0  # fan_in 25: bound 1/sqrt(25)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def test_unported_options_raise():
    """bfloat16 and the int8 hourglass are served now
    (tests/test_torch_bf16.py and tests/test_torch_quant.py hold them
    against the JAX package): a bf16 Predictor runs, an int8 hourglass
    Predictor quantizes its 55 convs and runs; an unknown compute dtype
    and an unknown quant mode raise."""
    cfg = hourglass_config(img_size=IMG)
    pred = Predictor(cfg, build_model(cfg.net, cfg.jt_num), device="cpu")
    bf16 = Predictor(cfg.replace(compute_dtype="bfloat16"),
                     pred.model.state_dict(), device="cpu")
    img = np.random.RandomState(0).uniform(-1, 1, (2, IMG, IMG)).astype(
        np.float32)
    assert np.isfinite(bf16.predict_normalized(img)).all()
    pred.quantize(img)
    assert len(pred.quant) == 55
    assert np.isfinite(pred.predict_normalized(img)).all()
    with pytest.raises(ValueError, match="mode"):
        set_quant_mode(pred.model, "int4")
    with pytest.raises(ValueError, match="float16"):
        Config(compute_dtype="float16")
    cfg = hourglass_config(2)
    assert (cfg.net, cfg.nstack, cfg.kernel_size, cfg.feature_size) == \
        ("hourglass_2", 2, 0.4, 64)
