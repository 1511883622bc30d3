"""Spatial (image-H) inference: a request split into row bands over a
mesh (the JAX package's ``Predictor`` on a ``spatial_mesh``).

GSPMD partitions the JAX package's jitted step by image rows and inserts
the halo exchanges itself.  PyTorch has no such partitioner, so here it
is written out:

- **Bands.**  A tensor of H rows (its axis -2) on an n-band mesh is
  split at rows ``floor(b*H/n)``, b = 0..n (:func:`band_bounds`), and
  band b lives on ``mesh.devices[b]`` (:class:`Banded`).  Two tensors of
  equal H are split alike, so pointwise ops, eval-mode BatchNorm, ReLU,
  the skip adds and channel ``cat``s run band by band with no exchange.
  A band may hold 0 rows (hourglass_1's 4-row level on 8 bands); it then
  runs nothing.
- **The band runner** (:class:`BandRunner`) interprets a ``torch.fx``
  trace of the backbone, whose convs, transposed convs, pools,
  BatchNorms, ReLUs and ``upsample_nearest_2x`` are leaves, band by band.
  For output band [o0, o1) of a layer it gathers the input rows the band
  reads from whichever bands hold them (``.to(device,
  non_blocking=True)``; a slice where the device repeats):
  [o0*s - p, (o1 - 1)*s - p + k) for a conv or pool (k, s, p);
  ceil((o0 + p - k + 1)/s) .. floor((o1 - 1 + p)/s) for a transposed
  conv; floor(o0/2) .. floor((o1 - 1)/2) for the nearest 2x upsample.
  Rows outside [0, H) are the layer's own padding: the layer runs on the
  slab with its padding (zeros for a conv, -inf for a max pool, the
  output rows a transposed conv crops) and the rows a band owns are
  cropped from its output, so that each equals the whole-tensor layer's
  row.  A conv or pool of stride s needs its slab to start on a multiple
  of s; up to s - 1 rows of zeros are put above it, and only cropped
  rows read them.  A node the runner does not know raises
  ``NotImplementedError``: nothing falls back to gathering a whole
  tensor.  ``BandRunner.gathered`` counts, for the last run, the rows
  each layer gathered from other bands, band by band (the JAX test's
  ``collective-permute``).
- **The decode** (:func:`infer`) runs on each non-empty band of the map
  (the op ``awr_tpu_torch::decode_rows``: the CUDA kernel on a GPU, on
  the map rows the band holds and the depth rows their nearest resize
  reads), and the bands' softmax statistics are merged on
  ``mesh.devices[0]``
  (:func:`~awr_tpu_torch.ops.functional.merge_softmax_bands`).

Serving only, in eval mode, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import operator
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import fx, nn

from awr_tpu_torch.models.common import upsample_nearest_2x
from awr_tpu_torch.ops import library
from awr_tpu_torch.ops.functional import merge_softmax_bands
from awr_tpu_torch.parallel.mesh import Mesh, spatial_sharding


def band_bounds(H: int, n: int) -> Tuple[int, ...]:
    """Band b of ``n`` holds rows [bounds[b], bounds[b + 1]) of ``H``."""
    return tuple(b * H // n for b in range(n + 1))


def on_device(device: torch.device):
    """``device`` as the current CUDA device (a no-op context off CUDA)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class Banded:
    """A tensor split by rows (its axis -2) over a mesh: ``parts[b]`` on
    the mesh's device b holds rows ``band_bounds(H, n)[b:b + 2]`` of the
    whole tensor's ``H``, or is None where the band holds none."""

    __slots__ = ("parts", "H")

    def __init__(self, parts: Sequence[Optional[torch.Tensor]], H: int):
        self.parts = tuple(parts)
        self.H = H


class _Tracer(fx.Tracer):
    """The backbone's graph with the layers the runner splits as leaves."""

    LEAVES = (nn.Conv2d, nn.ConvTranspose2d, nn.MaxPool2d, nn.BatchNorm2d,
              nn.ReLU)

    def __init__(self):
        super().__init__(autowrap_functions=(upsample_nearest_2x,))

    def is_leaf_module(self, m: nn.Module, qualname: str) -> bool:
        return isinstance(m, self.LEAVES) or super().is_leaf_module(
            m, qualname)


def _pair(v) -> int:
    """The H component of an int or (h, w) layer parameter."""
    return v if isinstance(v, int) else v[0]


# the element-wise functions and tensor methods of the two backbones'
# graphs (the skip adds, the residuals' ReLUs, the compute-dtype casts and
# ``map_out``), which the runner applies band by band
_POINTWISE = {operator.add, torch.relu}
_POINTWISE_METHODS = {"to", "float", "contiguous"}


class BandRunner:
    """``runner(x: Banded) -> Banded``: the backbone ``models[0]`` run band
    by band, band b through ``models[b]`` (its replica on
    ``mesh.devices[b]``: the same weights and mode)."""

    def __init__(self, mesh: Mesh, models: Sequence[nn.Module]):
        if len(models) != mesh.size:
            raise ValueError(f"{len(models)} replicas for a mesh of "
                             f"{mesh.size}")
        self.mesh = mesh
        self.models = tuple(models)
        self.graph = _Tracer().trace(models[0])
        # rows each layer gathered from other bands in the last run, by
        # band
        self.gathered: Dict[str, List[int]] = {}

    @property
    def n(self) -> int:
        return self.mesh.size

    def __call__(self, x: Banded) -> Banded:
        self.gathered = {}
        env = {}

        def load(a):
            return fx.node.map_arg(a, lambda node: env[node])

        for node in self.graph.nodes:
            if node.op == "placeholder":
                if env:
                    raise NotImplementedError("a backbone of more than "
                                              "one input")
                env[node] = x
            elif node.op == "output":
                return load(node.args[0])
            else:
                env[node] = self._node(node, load(node.args),
                                       load(node.kwargs))
        raise AssertionError("a graph without an output")

    # ------------------------------------------------------------ gather
    def gather(self, x: Banded, b: int, lo: int, hi: int,
               name: str) -> torch.Tensor:
        """Rows [lo, hi) of ``x`` (0 <= lo < hi <= x.H) on band b's
        device: band b's own rows sliced, the others' copied; the rows
        from other bands are counted under ``name``."""
        bounds = band_bounds(x.H, self.n)
        dev = self.mesh.devices[b]
        pieces, halo = [], 0
        for c in range(self.n):
            a, e = max(lo, bounds[c]), min(hi, bounds[c + 1])
            if a >= e:
                continue
            piece = x.parts[c].narrow(-2, a - bounds[c], e - a)
            if c != b:
                halo += e - a
                piece = piece.to(dev, non_blocking=True)
            pieces.append(piece)
        self.gathered.setdefault(name, [0] * self.n)[b] += halo
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-2)

    # ------------------------------------------------------------- nodes
    def _node(self, node: fx.Node, args, kwargs):
        if node.op == "call_module":
            return self._module(node.target, args, kwargs)
        if node.op == "call_function":
            if node.target is upsample_nearest_2x:
                return self._upsample(node.name, *args, **kwargs)
            if node.target in (torch.cat, torch.stack):
                return self._join(node.target, *args, **kwargs)
            if node.target in _POINTWISE:
                return self._pointwise(node.target, args, kwargs)
        if node.op == "call_method" and node.target in _POINTWISE_METHODS:
            return self._pointwise(
                lambda t, *a, **k: getattr(t, node.target)(*a, **k), args,
                kwargs)
        raise NotImplementedError(
            f"spatial bands: no rule for {node.op} {node.target!r} "
            f"({node.format_node()})")

    def _pointwise(self, fn, args, kwargs):
        """``fn`` band by band: every banded argument of one H, the rest
        Python scalars or dtypes."""
        flat = list(args) + list(kwargs.values())
        banded = [a for a in flat if isinstance(a, Banded)]
        if not banded or len({a.H for a in banded}) != 1:
            raise NotImplementedError(
                f"spatial bands: {fn} takes tensors of unequal heights")
        if any(isinstance(a, (torch.Tensor, list, tuple)) for a in flat):
            raise NotImplementedError(
                f"spatial bands: {fn} takes a tensor that is not banded")

        def part(a, b):
            return a.parts[b] if isinstance(a, Banded) else a

        parts = []
        for b in range(self.n):
            if banded[0].parts[b] is None:
                parts.append(None)
                continue
            with on_device(self.mesh.devices[b]):
                parts.append(fn(*[part(a, b) for a in args],
                                **{k: part(v, b) for k, v in kwargs.items()}))
        return Banded(parts, banded[0].H)

    def _join(self, fn, tensors, dim=0):
        """``torch.cat`` or ``torch.stack`` band by band, along an axis
        that is not the rows'."""
        if not all(isinstance(t, Banded) for t in tensors) or len(
                {t.H for t in tensors}) != 1:
            raise NotImplementedError(f"spatial bands: {fn.__name__} of "
                                      f"tensors not banded alike")
        # the last band holds rows whenever H > 0
        ndim = tensors[0].parts[-1].dim()
        rows_axis = ndim - 2
        axis = dim % (ndim + (fn is torch.stack))
        if axis == rows_axis or (fn is torch.stack and axis > rows_axis):
            raise NotImplementedError(f"spatial bands: {fn.__name__} along "
                                      f"the rows")
        parts = [None if tensors[0].parts[b] is None else
                 fn([t.parts[b] for t in tensors], dim=dim)
                 for b in range(self.n)]
        return Banded(parts, tensors[0].H)

    def _module(self, target: str, args, kwargs):
        m = self.models[0].get_submodule(target)
        if kwargs or len(args) != 1 or not isinstance(args[0], Banded):
            raise NotImplementedError(f"spatial bands: {target} called "
                                      f"with {len(args)} arguments")
        x = args[0]
        if isinstance(m, (nn.BatchNorm2d, nn.ReLU)):
            if m.training:
                raise NotImplementedError(
                    f"spatial bands: {target} in training mode (batch "
                    f"statistics span the bands)")
            return self._per_band(target, x.H, lambda b, o0, o1: (
                x.parts[b], 0))
        if isinstance(m, nn.ConvTranspose2d):
            return self._transposed(target, m, x)
        if isinstance(m, (nn.Conv2d, nn.MaxPool2d)):
            return self._window(target, m, x)
        raise NotImplementedError(f"spatial bands: no rule for module "
                                  f"{target} ({type(m).__name__})")

    def _per_band(self, target: str, H: int, slab_rows) -> Banded:
        """The layer ``target`` (of H output rows) band by band:
        ``slab_rows(b, o0, o1) -> (slab, q0)``, the slab of its input that
        band b's output rows [o0, o1) read and where o0 lies in the
        layer's output on that slab; band b's replica of the layer runs
        on the slab, and its rows [q0, q0 + o1 - o0) are kept."""
        bounds = band_bounds(H, self.n)
        parts = []
        for b in range(self.n):
            o0, o1 = bounds[b], bounds[b + 1]
            if o0 == o1:
                parts.append(None)
                continue
            dev = self.mesh.devices[b]
            with on_device(dev):
                slab, q0 = slab_rows(b, o0, o1)
                y = self.models[b].get_submodule(target)(slab)
                if q0 < 0 or y.shape[-2] < q0 + o1 - o0:
                    raise NotImplementedError(
                        f"spatial bands: {target}'s slab gives rows "
                        f"[0, {y.shape[-2]}), not [{q0}, {q0 + o1 - o0})")
                parts.append(y.narrow(-2, q0, o1 - o0))
        return Banded(parts, H)

    def _window(self, target: str, m: nn.Module, x: Banded) -> Banded:
        """A conv or max pool (k, s, p) over the rows."""
        k, s = _pair(m.kernel_size), _pair(m.stride)
        p, d = _pair(m.padding), _pair(m.dilation)
        if (not isinstance(p, int) or d != 1
                or getattr(m, "ceil_mode", False)
                or getattr(m, "padding_mode", "zeros") != "zeros"):
            raise NotImplementedError(f"spatial bands: {target}: only "
                                      f"integer padding, no dilation")
        H = x.H

        def slab_rows(b, o0, o1):
            lo, hi = o0 * s - p, (o1 - 1) * s - p + k
            # the layer's windows start every s rows of its padded slab
            r0 = 0 if lo <= 0 else lo - lo % s
            slab = self.gather(x, b, max(lo, 0), min(hi, H), target)
            if lo > r0:
                # read only by the output rows cropped below
                pad = list(slab.shape)
                pad[-2] = lo - r0
                slab = torch.cat([slab.new_zeros(pad), slab], dim=-2)
            return slab, o0 - r0 // s

        return self._per_band(target, (H + 2 * p - k) // s + 1, slab_rows)

    def _transposed(self, target: str, m: nn.ConvTranspose2d,
                    x: Banded) -> Banded:
        """A transposed conv (k, s, p) over the rows: input row i reaches
        output rows i*s - p + [0, k)."""
        k, s, p = (_pair(m.kernel_size), _pair(m.stride), _pair(m.padding))
        if (_pair(m.dilation) != 1 or _pair(m.output_padding) != 0
                or not isinstance(p, int)):
            raise NotImplementedError(f"spatial bands: {target}: no "
                                      f"dilation or output padding")
        H = x.H

        def slab_rows(b, o0, o1):
            i0 = max(0, -((k - 1 - o0 - p) // s))  # ceil((o0 + p - k + 1)/s)
            i1 = min(H - 1, (o1 - 1 + p) // s)
            # with its padding p the layer's output row q on rows from i0
            # is the whole layer's row i0*s + q
            return self.gather(x, b, i0, i1 + 1, target), o0 - i0 * s

        return self._per_band(target, (H - 1) * s - 2 * p + k, slab_rows)

    def _upsample(self, name: str, x: Banded) -> Banded:
        """``upsample_nearest_2x``: output row o reads input row o // 2."""
        if not isinstance(x, Banded):
            raise NotImplementedError("spatial bands: upsample of a tensor "
                                      "that is not banded")
        bounds = band_bounds(2 * x.H, self.n)
        parts = []
        for b in range(self.n):
            o0, o1 = bounds[b], bounds[b + 1]
            if o0 == o1:
                parts.append(None)
                continue
            with on_device(self.mesh.devices[b]):
                i0 = o0 // 2
                slab = self.gather(x, b, i0, (o1 - 1) // 2 + 1, name)
                parts.append(upsample_nearest_2x(slab).narrow(
                    -2, o0 - 2 * i0, o1 - o0))
        return Banded(parts, 2 * x.H)


def split_rows(mesh: Mesh, img: torch.Tensor) -> Banded:
    """(B, H, W) frames on one device -> their bands on the mesh's
    devices (``spatial_sharding``: H must divide by the mesh size)."""
    return Banded([img[:, sl].to(d, non_blocking=True) for sl, d in zip(
        spatial_sharding(mesh).slices(img.shape[1]), mesh.devices)],
        img.shape[1])


def infer(runner: BandRunner, img: torch.Tensor,
          kernel_size: float) -> torch.Tensor:
    """(B, S, S) normalized depth on ``mesh.devices[0]`` -> (B, J, 3)
    normalized uvd joints there, decoded from the last stack: the
    inference step (``training.steps.infer``) run band by band."""
    mesh = runner.mesh
    frames = split_rows(mesh, img)
    maps = runner(Banded([t[:, None] for t in frames.parts], frames.H))
    bounds = band_bounds(maps.H, mesh.size)
    S, F = frames.H, maps.H
    parts = []
    for b, m in enumerate(maps.parts):
        if m is None:
            continue
        # the hourglass stacks its maps: (S, B, 4J, rows, F)
        m = m[-1] if m.dim() == 5 else m
        r0, r1 = bounds[b], bounds[b + 1]
        # the depth rows the band's nearest resize reads
        i0, i1 = (r0 * S) // F, ((r1 - 1) * S) // F + 1
        dev = mesh.devices[b]
        with on_device(dev):
            depth = runner.gather(frames, b, i0, i1, "decode")
            out = library.decode_rows(m, depth, float(kernel_size), r0, i0, S)
        parts.append(tuple(t.to(mesh.devices[0], non_blocking=True)
                           for t in out))
    with on_device(mesh.devices[0]):
        return merge_softmax_bands(parts)[0]


def make_spatial_infer_step(mesh: Mesh, models: Sequence[nn.Module],
                            kernel_size: float):
    """``infer_step((B, S, S) normalized depth on mesh.devices[0]) ->
    (B, J, 3)`` there, without autograd; its :class:`BandRunner` is
    ``infer_step.runner``."""
    runner = BandRunner(mesh, models)

    @torch.inference_mode()
    def infer_step(img: torch.Tensor) -> torch.Tensor:
        return infer(runner, img, kernel_size)

    infer_step.runner = runner
    return infer_step

