"""The stacked hourglass (``hourglass_<n>``, n > 1) against the
benchmark's plain reference (``portbench/reference/hourglass.py`` and
``steps.py``) at tiny shapes on the CPU: every stack's map, the train
step with every stack supervised and with the last alone (the loss and
every parameter's gradient, the inter-stack merges and the intermediate
heads included), and the ``train.supervise`` span of the train step.

Both sides run in float64 on one seeded random state dict, so the
forward agrees to float64 rounding; the losses cast the map's difference
to float32 (the reference's ``z.float()``, the port's too), which bounds
how closely the losses and gradients can agree.  PyTorch runs on one
thread, as ``tests/torch_port_weights.py`` ``one_thread`` has it.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from awr_tpu_torch.config import hourglass_config
from awr_tpu_torch.models.hourglass import PoseNet
from awr_tpu_torch.training import steps as port_steps
from awr_tpu_torch.training.optim import make_optimizer
from awr_tpu_torch.utils import profiling
from portbench.reference import awr
from portbench.reference import hourglass as ref_hourglass
from portbench.reference import steps as ref_steps

NSTACK, J, IMG, DIM, B = 3, 14, 32, 32, 4
F = IMG // 2
KERNEL, DENSE, COORD = 0.4, 1.0, 0.1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_state(seed=0) -> dict:
    """A seeded state dict in the reference's key layout: conv weights
    N(0, 2 / fan_in), biases N(0, 0.05^2), BatchNorm scales 1 + N(0,
    0.1^2), shifts and running means N(0, 0.1^2), running variances
    U(0.5, 1.5); float64."""
    ref = ref_hourglass.PoseNet(NSTACK, J, DIM, 4)
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in ref.state_dict().items():
        if not v.is_floating_point():
            out[k] = v.clone()
            continue
        r = torch.randn(v.shape, generator=g, dtype=torch.float64)
        if k.endswith("running_var"):
            out[k] = 0.5 + torch.rand(v.shape, generator=g,
                                      dtype=torch.float64)
        elif k.endswith(("running_mean", "bias")) and v.dim() == 1:
            out[k] = r * (0.05 if ".conv." in k or "outs_" in k else 0.1)
        elif v.dim() == 1:  # a BatchNorm scale
            out[k] = 1.0 + 0.1 * r
        else:
            out[k] = r * (2.0 / v[0].numel()) ** 0.5
    return out


def models(state):
    """(port, reference) hourglasses of NSTACK stacks holding ``state``."""
    port = PoseNet(nstack=NSTACK, joint_num=J, inp_dim=DIM).double()
    ref = ref_hourglass.PoseNet(NSTACK, J, DIM, 4).double()
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port, ref


def batch(seed=1):
    """Normalized depth crops (B, IMG, IMG), background 1, with a
    foreground block, and joints (B, J, 3), float64."""
    rng = np.random.RandomState(seed)
    img = np.ones((B, IMG, IMG))
    img[:, IMG // 4:3 * IMG // 4, IMG // 8:] = rng.uniform(
        -1, 0.9, (IMG // 2, IMG - IMG // 8))
    jt = rng.uniform(-0.8, 0.8, (B, J, 3))
    return torch.from_numpy(img), torch.from_numpy(jt)


def config(supervise_all: bool, **kw):
    return hourglass_config(NSTACK, img_size=IMG, kernel_size=KERNEL,
                            dense_weight=DENSE, coord_weight=COORD,
                            supervise_all_stacks=supervise_all, **kw)


REF_CFG = dict(kernel_size=KERNEL, feature_size=F, dense_weight=DENSE,
               coord_weight=COORD)


@pytest.mark.parametrize("train", [True, False])
def test_every_stack_matches_the_reference(train):
    """Every stack's (B, 4J, F, F) map, in train mode (batch statistics)
    and in eval mode (running statistics), to float64 rounding: the two
    compute the same layers in the same order."""
    port, ref = models(random_state())
    img = batch()[0][:, None]
    port.train(train), ref.train(train)
    with torch.no_grad():
        got, want = port(img), ref(img)
    assert got.shape == want.shape == (NSTACK, B, 4 * J, F, F)
    # the stacks differ: each re-injects its map into the next
    assert not torch.allclose(want[0], want[-1])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def last_stack_step(model, opt, img, jt_uvd):
    """The reference's step with the last stack alone supervised: its
    ``train_step`` with the sum over stacks cut to the last term, from
    the reference's own encode, decode and loss."""
    model.train()
    for p in opt.params:
        p.grad = None
    target = awr.encode(jt_uvd, img, KERNEL, F)
    pred = model(img[:, None])[-1]
    jt_pred = awr.decode(pred, img, KERNEL)
    loss = (DENSE * awr.smooth_l1(pred, target)
            + COORD * awr.smooth_l1(jt_pred, jt_uvd))
    loss.backward()
    opt.step()
    return loss.detach(), jt_pred.detach()


@pytest.mark.parametrize("supervise_all", [True, False])
def test_train_step_matches_the_reference(supervise_all):
    """One ``make_train_step`` against ``portbench.reference.steps.
    train_step`` (every stack supervised) or its last-stack form: the
    loss to 1e-6 relative and every gradient to 1e-6 of the larger of
    its leaf's and the median leaf's norm.  The losses are float32: the
    port sums the dense terms and the coordinate terms apart and adds
    the two once, the reference adds both stack by stack, so they part
    by a few float32 ulps (2.1e-7 here with every stack); a stack left
    out of the loss moves it by a third or more.  The gradients are
    float64 from the same float32 loss terms (equal here), so 1e-6 is
    room for another summation order only."""
    state = random_state()
    port, ref = models(state)
    img, jt = batch()
    step = port_steps.make_train_step(
        port, make_optimizer(port.parameters(), "adam", 1e-3),
        config(supervise_all))
    got = step(dict(img=img, jt_uvd=jt))
    opt = ref_steps.Adam(ref.parameters(), 1e-3)
    if supervise_all:
        loss, jt_ref = ref_steps.train_step(ref, opt, img, jt, REF_CFG)
    else:
        loss, jt_ref = last_stack_step(ref, opt, img, jt)
    torch.testing.assert_close(got["loss"], loss, rtol=1e-6, atol=0)
    torch.testing.assert_close(got["jt_uvd_pred"], jt_ref, rtol=1e-9,
                               atol=1e-12)
    want = {n: p.grad for n, p in ref.named_parameters()}
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert grads.keys() == want.keys()
    norms = {n: float(g.norm()) for n, g in want.items()}
    med = float(np.median(list(norms.values())))
    gaps = {n: float((grads[n] - want[n]).norm()) / max(norms[n], med)
            for n in want}
    assert max(gaps.values()) < 1e-6, max(gaps.items(), key=lambda kv: kv[1])
    # the merges and the intermediate heads learn, supervised or not
    for n in ("merge_preds.0.conv.conv.weight",
              "merge_features.1.conv.conv.weight", "outs_1.0.weight",
              "outs_2.1.weight", "hgs.0.0.up1.conv1.conv.weight"):
        assert norms[n] > 1e-3 * med, n


def _events(prof, name):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() == name]


@pytest.mark.parametrize("supervise_all", [True, False])
def test_supervise_span_once_per_microbatch(supervise_all, monkeypatch):
    """``train.supervise`` is one range a microbatch while a profiler
    records, inside ``train.forward`` on its thread, holding the decode
    of every supervised stack (NSTACK, or the last alone); with no
    profiler every call of it is the shared no-op and records nothing."""
    port, _ = models(random_state())
    img, jt = batch()
    accum = 2
    step = port_steps.make_train_step(
        port, make_optimizer(port.parameters(), "adam", 1e-3),
        config(supervise_all, grad_accum=accum))
    made = []

    def spy(name):
        s = profiling.span(name)
        made.append((name, s))
        return s

    monkeypatch.setattr(port_steps, "span", spy)
    step(dict(img=img, jt_uvd=jt))
    off = [s for n, s in made if n == "train.supervise"]
    assert len(off) == accum
    assert all(s is profiling._NO_SPAN for s in off)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(dict(img=img, jt_uvd=jt))
    spans = _events(prof, "awr_tpu_torch.train.supervise")
    forwards = _events(prof, "awr_tpu_torch.train.forward")
    decodes = _events(prof, "awr_tpu_torch::decode")
    assert len(spans) == len(forwards) == accum

    def inside(e, span):
        return (e.start_thread_id() == span.start_thread_id()
                and span.start_ns() <= e.start_ns()
                and e.start_ns() + e.duration_ns()
                <= span.start_ns() + span.duration_ns())

    for s in spans:
        assert sum(inside(s, f) for f in forwards) == 1
        assert sum(inside(d, s) for d in decodes) == (
            NSTACK if supervise_all else 1)
    # every decode of the step is the supervision's
    assert len(decodes) == accum * (NSTACK if supervise_all else 1)
