"""The seam between the port and its hand-written kernels, on the CPU: the
ops' schemas, which a saved program names, and the one launch path,
driven by a ``ctypes`` stand-in for a kernel's launcher."""

import collections
import contextlib
import ctypes
import types

import pytest
import torch

from awr_tpu_torch import kernels
from awr_tpu_torch.ops import library  # noqa: F401  (registers the ops)

# A program that ``torch.export`` saved calls each op by name with these
# arguments; an edited schema would not load it.
SCHEMAS = {
    "decode": "awr_tpu_torch::decode(Tensor offset, Tensor img, "
              "float kernel_size) -> (Tensor, Tensor)",
    "decode_backward": "awr_tpu_torch::decode_backward(Tensor offset, "
                       "Tensor img, Tensor out, Tensor stats, "
                       "Tensor grad_out, float kernel_size) -> Tensor",
    "decode_rows": "awr_tpu_torch::decode_rows(Tensor offset, Tensor img, "
                   "float kernel_size, SymInt row0, SymInt img_row0, "
                   "SymInt img_rows) -> (Tensor, Tensor)",
    "encode": "awr_tpu_torch::encode(Tensor jt_uvd, Tensor img, "
              "float kernel_size, SymInt feature_size) -> Tensor",
    "int8_matmul": "awr_tpu_torch::int8_matmul(Tensor a, Tensor b) "
                   "-> Tensor",
    "deconv4x4s2_int8": "awr_tpu_torch::deconv4x4s2_int8(Tensor xq, "
                        "Tensor wq, Tensor scale, ScalarType out_dtype) "
                        "-> Tensor",
    "bias_relu_": "awr_tpu_torch::bias_relu_(Tensor(a!) y, Tensor bias, "
                  "Tensor? residual) -> ()",
    "head_out": "awr_tpu_torch::head_out(Tensor y, Tensor bias) -> Tensor",
    "stem_pool": "awr_tpu_torch::stem_pool(Tensor x, Tensor weight, "
                 "Tensor bias) -> Tensor",
}


@pytest.mark.parametrize("op", list(SCHEMAS))
def test_op_schema_is_the_saved_programs(op):
    schema = getattr(torch.ops.awr_tpu_torch, op).default._schema
    assert str(schema) == SCHEMAS[op]


@pytest.fixture
def no_cuda(monkeypatch):
    """``torch.cuda.device`` and ``current_stream`` stand-ins that need no
    CUDA: the devices entered, and stream 1234; a fresh launch count."""
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(kernels, "LAUNCHES", collections.Counter())
    return entered


@pytest.mark.parametrize("err", [0, 1, 700])
def test_launch_counts_only_a_launch_that_succeeds(no_cuda, err):
    """The launcher gets the arguments and then the device's current
    stream, under that device; a launch that returns 0 is counted under
    the kernel's name, and any other CUDA error raises naming it and is
    not counted."""
    calls = []

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p)
    def stand_in(n, x, stream):
        calls.append((n, x, stream))
        return err

    dev = torch.device("cuda", 0)
    if err:
        with pytest.raises(RuntimeError,
                           match=f"stand_in kernel launch failed: CUDA "
                                 f"error {err}"):
            kernels.launch("stand_in", stand_in, dev, 7, 0.5)
    else:
        kernels.launch("stand_in", stand_in, dev, 7, 0.5)
    assert calls == [(7, 0.5, 1234)]
    assert no_cuda == [dev]
    assert kernels.LAUNCHES == collections.Counter(
        {} if err else {"stand_in": 1})
