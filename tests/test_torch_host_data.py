"""The port's host crop chain and depth-PNG reader, on the CPU: the numpy
emulation of OpenCV's resize, rotation matrix and warps against ``cv2``
on the crops and matrices that ``augment`` produces; the host
``CameraCrop`` against the JAX package's; the decoder against the JAX
package's C++ extension and ``cv2``, and its C++ unfilter against the
plain numpy one."""

import os
import struct
import zlib
from fractions import Fraction

import cv2
import numpy as np
import pytest

from awr_tpu.data import native_decode as jax_decode
from awr_tpu.data.synthetic import render_hand_depth
from awr_tpu.data.transforms import CameraCrop as JaxCrop
from awr_tpu_torch.config import DATASET_FLIP, NYU_PARAS
from awr_tpu_torch.data import cvwarp, native_decode
from awr_tpu_torch.data import transforms as port_transforms
from awr_tpu_torch.data.transforms import AUG_OPS, CameraCrop
from awr_tpu_torch.geometry import xyz2uvd_np
from awr_tpu_torch.utils import png

NYU_FLIP = DATASET_FLIP["nyu"]
CUBE = np.array([300.0, 300.0, 300.0])
# OpenCV's warps against the emulation: every pixel within 2e-3 mm, which
# is 1e-5 of a 300 mm cube's half-width in normalized units (float32
# resolves about 6e-5 mm at 1000 mm)
WARP_ATOL_MM = 2e-3


def sample_scene(seed):
    """tests/test_data.py's hand scene near the frame's middle."""
    g = np.random.RandomState(seed)
    center = np.array([g.uniform(-60, 60), g.uniform(-40, 40),
                       g.uniform(650, 950)])
    jt = center[None] + g.uniform(-60, 60, (14, 3))
    jt[:, 2] = center[2] + g.uniform(-40, 40, 14)
    return render_hand_depth(center, jt, NYU_PARAS), jt, center


def border_scene(seed):
    """tests/test_data.py's hand near the frame's corner: crop bounds
    beyond the frame."""
    g = np.random.RandomState(seed)
    center = np.array([g.uniform(-260, -220), g.uniform(120, 190),
                       g.uniform(650, 800)])
    jt = center[None] + g.uniform(-50, 50, (14, 3))
    jt[:, 2] = center[2] + g.uniform(-30, 30, 14)
    return render_hand_depth(center, jt, NYU_PARAS), jt, center


SCENES = {"middle": sample_scene, "border": border_scene}


def cropped(scene, seed, size=128):
    img, jt, center = SCENES[scene](seed)
    center_uvd = xyz2uvd_np(center, NYU_PARAS, NYU_FLIP).astype(np.float64)
    crop, M = CameraCrop(NYU_PARAS, NYU_FLIP, size).crop(img, center_uvd,
                                                          CUBE, size)
    return img, jt - center, center_uvd, crop, M


def aug_params(seed):
    g = np.random.RandomState(100 + seed)
    return g.randn(3) * 10.0, abs(1.0 + g.randn() * 0.1), g.uniform(-180,
                                                                      180)


# --------------------------------------------------- OpenCV emulation


@pytest.mark.parametrize("shape", [(97, 131), (300, 257), (40, 23),
                                   (128, 128)])
def test_resize_nearest_bit_equal_cv2(shape):
    rng = np.random.RandomState(shape[0])
    img = rng.rand(*shape).astype(np.float32)
    for size in [(128, 95), (61, 128), (128, 128), (7, 300)]:
        np.testing.assert_array_equal(
            cvwarp.resize_nearest(img, size),
            cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))


def test_rotation_matrix_bit_equal_cv2():
    for angle in [-179.3, -90.0, 0.0, 33.25, 90.0, 180.0, 271.7]:
        for center in [(64, 64), (16, 16), (63.5, 12.25)]:
            np.testing.assert_array_equal(
                cvwarp.rotation_matrix_2d(center, angle, 1.0),
                cv2.getRotationMatrix2D(center, angle, 1.0))


def warps_of_augment(monkeypatch, crop, jt, center_uvd, M, op, trans,
                     scale, rot):
    """Run the port's augment and record each cvwarp call's arguments and
    result."""
    calls = []
    for name in ("warp_affine", "warp_perspective", "rotation_matrix_2d"):
        fn = getattr(cvwarp, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            out = _fn(*args, **kw)
            calls.append((_name, [np.copy(a) if isinstance(a, np.ndarray)
                                  else a for a in args], kw, np.copy(out)))
            return out

        monkeypatch.setattr(port_transforms.cvwarp, name, spy)
    CameraCrop(NYU_PARAS, NYU_FLIP, crop.shape[0]).augment(
        crop.copy(), jt.copy(), center_uvd.copy(), CUBE.copy(), M.copy(),
        op, trans, scale, rot)
    monkeypatch.undo()
    return calls


def cv2_call(name, args, kw):
    flags = dict(flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                 borderValue=float(kw.get("border_value", 0.0)))
    if name == "warp_affine":
        return cv2.warpAffine(*args, **flags)
    if name == "warp_perspective":
        return cv2.warpPerspective(*args, **flags)
    return cv2.getRotationMatrix2D(*args)


@pytest.mark.parametrize("size", [128, 32])
@pytest.mark.parametrize("scene", ["middle", "border"])
@pytest.mark.parametrize("op", ["trans", "scale", "rot", "rot90", "rot180"])
def test_warps_of_augment_match_cv2(monkeypatch, op, scene, size):
    """Every resize, rotation matrix and warp that ``augment`` makes, on
    its own crops and matrices, at three seeds: each pixel within
    WARP_ATOL_MM of cv2.  Measured here: bit-equal (the share of pixels
    that differ is asserted and reported as 0)."""
    worst, differ, pixels = 0.0, 0, 0
    for seed in range(3):
        _, jt, center_uvd, crop, M = cropped(scene, seed, size)
        trans, scale, rot = aug_params(seed)
        rot = {"rot90": 90.0, "rot180": 180.0}.get(op, rot)
        calls = warps_of_augment(monkeypatch, crop, jt, center_uvd, M,
                                 op[:3] if op.startswith("rot") else op,
                                 trans, scale, rot)
        assert {c[0] for c in calls} >= (
            {"warp_affine", "rotation_matrix_2d"} if op.startswith("rot")
            else {"warp_perspective"})
        for name, args, kw, got in calls:
            want = cv2_call(name, args, kw)
            assert got.dtype == want.dtype and got.shape == want.shape
            err = np.abs(got.astype(np.float64) - want)
            worst = max(worst, float(err.max()))
            if name != "rotation_matrix_2d":
                differ += int((got != want).sum())
                pixels += got.size
    print(f"{op} {scene} {size}: max |port - cv2| {worst} mm, "
          f"{differ}/{pixels} pixels not bit-equal")
    assert worst <= WARP_ATOL_MM
    assert differ == 0


def test_warps_refuse_other_images():
    with pytest.raises(ValueError, match="float32"):
        cvwarp.warp_affine(np.zeros((8, 8)), np.eye(2, 3), (8, 8))
    with pytest.raises(ValueError, match="singular"):
        cvwarp.warp_perspective(np.zeros((8, 8), np.float32),
                                np.zeros((3, 3)), (8, 8))


def exact_fma32(a, b, c) -> np.float32:
    """float32 a * b + c rounded once, from exact rationals."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = [near, np.nextafter(near, np.float32(np.inf)),
             np.nextafter(near, np.float32(-np.inf))]
    dist = [abs(Fraction(float(x)) - exact) for x in cands]
    best = min(dist)
    ties = [x for x, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda x: int(np.float32(x).view(np.int32)) & 1)


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic, and on a sum whose float64
    rounding lands on a float32 midpoint: -(1 + 2^-23) 2^-12 * (1 - 2^-23)
    2^-12 + (1 + 2^-23) is 1 + 2^-24 + 2^-70, which rounds once to
    1 + 2^-23 but through float64 to 1."""
    rng = np.random.RandomState(0)
    a = rng.rand(3000).astype(np.float32)
    b = (rng.randn(3000) * 1000).astype(np.float32)
    c = (rng.randn(3000) * 1000).astype(np.float32)
    got = cvwarp.fma32(a, b, c)
    want = [exact_fma32(*abc) for abc in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    u = 2.0 ** -23
    a, b, c = (np.float32(-(1 + u) * 2.0 ** -12),
               np.float32((1 - u) * 2.0 ** -12), np.float32(1 + u))
    assert np.float32(np.float64(a) * np.float64(b) + np.float64(c)) == 1.0
    assert cvwarp.fma32(a, b, c) == np.float32(1 + u) == exact_fma32(a, b,
                                                                      c)


# -------------------------------------------------------- CameraCrop


@pytest.mark.parametrize("scene", ["middle", "border"])
def test_crop_transmat_normalize_bit_equal_jax(scene):
    ours = CameraCrop(NYU_PARAS, NYU_FLIP, 128)
    theirs = JaxCrop(NYU_PARAS, NYU_FLIP, 128)
    for seed in range(3):
        img, _, center = SCENES[scene](seed)
        c = xyz2uvd_np(center, NYU_PARAS, NYU_FLIP).astype(np.float64)
        for cube in (CUBE, CUBE * 5 / 6):
            got, got_M = ours.crop(img, c, cube, 128)
            want, want_M = theirs.crop(img, c, cube, 128)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got_M, want_M)
            np.testing.assert_array_equal(
                ours.center2transmat(c, cube, 32),
                theirs.center2transmat(c, cube, 32))
            np.testing.assert_array_equal(
                ours.normalize(got.max(), got, c[2], cube[2]),
                theirs.normalize(want.max(), want, c[2], cube[2]))


def test_random_aug_same_draws_as_jax():
    ours, theirs = np.random.RandomState(23455), np.random.RandomState(23455)
    crop = CameraCrop(NYU_PARAS, NYU_FLIP, 128)
    jcrop = JaxCrop(NYU_PARAS, NYU_FLIP, 128)
    seen = set()
    for _ in range(40):
        got = crop.random_aug(ours, 10.0, 0.1, 180.0)
        want = jcrop.random_aug(theirs, 10.0, 0.1, 180.0)
        assert got[0] == want[0]
        seen.add(got[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
    assert seen == set(AUG_OPS)
    assert ours.randint(1 << 30) == theirs.randint(1 << 30)


@pytest.mark.parametrize("scene", ["middle", "border"])
@pytest.mark.parametrize("op", ["trans", "scale", "rot", None])
def test_augment_matches_jax(op, scene):
    """augment per op at three seeds and at rot 90 and 180, at the bars
    the JAX package holds its own chain to against the reference
    (tests/test_data.py:92-96)."""
    ours = CameraCrop(NYU_PARAS, NYU_FLIP, 128)
    theirs = JaxCrop(NYU_PARAS, NYU_FLIP, 128)
    runs = [aug_params(seed) for seed in range(3)]
    if op == "rot":
        runs += [(runs[0][0], 1.0, 90.0), (runs[0][0], 1.0, 180.0)]
    for seed, (trans, scale, rot) in enumerate(runs):
        _, jt, c, crop, M = cropped(scene, seed % 3)
        args = (jt, c, CUBE, M, op, trans, scale, rot)
        got = ours.augment(crop.copy(), *[np.copy(a) if isinstance(
            a, np.ndarray) else a for a in args])
        want = theirs.augment(crop.copy(), *[np.copy(a) if isinstance(
            a, np.ndarray) else a for a in args])
        g_img, g_jt, g_cube, g_center, g_M = got
        w_img, w_jt, w_cube, w_center, w_M = want
        assert g_img.dtype == w_img.dtype == np.float32
        np.testing.assert_allclose(g_img, w_img, rtol=0, atol=1e-5)
        np.testing.assert_allclose(g_jt, w_jt, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g_cube, w_cube, rtol=1e-6)
        np.testing.assert_allclose(g_center, w_center, rtol=1e-5)
        np.testing.assert_allclose(g_M, w_M, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------- decoder


def nyu_cv2(path):
    """The JAX package's cv2 spelling of the NYU fold."""
    img = cv2.imread(path)
    return (img[:, :, 0].astype(np.float32)
            + img[:, :, 1].astype(np.float32) * 256.0)


def gray16_cv2(path):
    return cv2.imread(path, cv2.IMREAD_ANYDEPTH).astype(np.float32)


def smooth_depth(h=240, w=320):
    yy, xx = np.mgrid[0:h, 0:w]
    return (700 + 80 * np.sin(xx / 40.0) + 60 * np.cos(yy / 30.0)).astype(
        np.int64)


def nyu_rgb(depth):
    """(H, W, 3) RGB with blue = depth % 256, green = depth // 256."""
    img = np.zeros((*depth.shape, 3), np.uint8)
    img[..., 1] = depth // 256
    img[..., 2] = depth % 256
    return img


def write_case(path, case, rng):
    """Write one decoder case; returns (cv2 reader, depth or None)."""
    if case == "rgb_cv2":
        cv2.imwrite(path, rng.randint(0, 256, (120, 160, 3), np.uint8))
        return nyu_cv2, None
    if case == "rgba_cv2":
        cv2.imwrite(path, rng.randint(0, 256, (90, 110, 4), np.uint8))
        return nyu_cv2, None
    if case == "smooth_cv2":
        d = smooth_depth()
        bgr = nyu_rgb(d)[..., ::-1]
        cv2.imwrite(path, np.ascontiguousarray(bgr))
        return nyu_cv2, d
    if case == "gray16_cv2":
        cv2.imwrite(path, rng.randint(0, 65536, (100, 140)).astype(
            np.uint16))
        return gray16_cv2, None
    if case == "gray16_cycle":
        d = rng.randint(0, 65536, (64, 96)).astype(np.uint16)
        png.write_png(path, d, filters=png.FILTERS)
        return gray16_cv2, d
    f = int(case[-1])  # rgb_filter<f>: one forced filter type
    d = smooth_depth(60, 80) + rng.randint(0, 40, (60, 80))
    png.write_png(path, nyu_rgb(d), filters=(f,))
    return nyu_cv2, d


CASES = ["rgb_cv2", "rgba_cv2", "smooth_cv2", "gray16_cv2", "gray16_cycle",
         *(f"rgb_filter{f}" for f in png.FILTERS)]


@pytest.mark.parametrize("case", CASES)
def test_decode_bit_equal_jax_native_cv2_and_plain(tmp_path, case):
    path = str(tmp_path / f"{case}.png")
    read_cv2, depth = write_case(path, case, np.random.RandomState(7))
    got = native_decode.decode_depth_png(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, read_cv2(path))
    np.testing.assert_array_equal(got, jax_decode.decode_depth_png(path))
    if depth is not None:
        np.testing.assert_array_equal(got, depth.astype(np.float32))
    # the C++ unfilter against the plain one, bytes and fold
    rows, width, bpp = png.inflate_depth_png(path)
    pixels, folded = native_decode.unfilter_depth(rows, width, bpp)
    plain = png.unfilter_plain(rows, bpp)
    np.testing.assert_array_equal(pixels, plain)
    np.testing.assert_array_equal(folded, png.fold_depth(plain, bpp))
    np.testing.assert_array_equal(folded, got)


def test_decode_kinds_and_batches(tmp_path):
    rng = np.random.RandomState(3)
    rgb = [str(tmp_path / f"c{i}.png") for i in range(3)]
    for p in rgb:
        write_case(p, "rgb_cv2", rng)
    g16 = str(tmp_path / "g.png")
    write_case(g16, "gray16_cv2", rng)
    stack = native_decode.decode_depth_pngs(rgb, "nyu")
    assert stack.shape == (3, 120, 160) and stack.flags.c_contiguous
    for i, p in enumerate(rgb):
        np.testing.assert_array_equal(stack[i], native_decode.decode_depth_png(
            p, "nyu"))
    np.testing.assert_array_equal(
        native_decode.decode_depth_pngs(rgb, "any"),
        jax_decode.decode_depth_pngs(rgb, "any"))
    np.testing.assert_array_equal(native_decode.decode_depth_png(g16,
                                                                 "gray16"),
                                  gray16_cv2(g16))
    with pytest.raises(ValueError, match="expected encoding"):
        native_decode.decode_depth_png(g16, "nyu")
    with pytest.raises(ValueError, match="expected encoding"):
        native_decode.decode_depth_png(rgb[0], "gray16")
    with pytest.raises(ValueError, match="expected 120x160"):
        native_decode.decode_depth_pngs(rgb + [g16], "any")
    with pytest.raises(ValueError, match="unknown kind"):
        native_decode.decode_depth_png(g16, "rgb")


def handmade_png(path, width, height, bit_depth, color, interlace=0,
                 extra=b""):
    raw = b"".join(b"\x00" + bytes(width * 3) for _ in range(height))
    chunk = png._chunk
    with open(path, "wb") as fh:
        fh.write(png.SIGNATURE)
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", width, height,
                                            bit_depth, color, 0, 0,
                                            interlace)))
        fh.write(extra)
        fh.write(chunk(b"IDAT", zlib.compress(raw)))
        fh.write(chunk(b"IEND", b""))


def test_decode_refuses_what_it_cannot_read(tmp_path):
    """A palette, an interlaced, a 16-bit RGB, a truncated file, a bad
    filter byte and a non-PNG each raise ValueError naming the file; no
    other decoder takes over."""
    cases = {}
    p = str(tmp_path / "palette.png")
    handmade_png(p, 8, 4, 8, 3, extra=png._chunk(b"PLTE", bytes(768)))
    cases[p] = "color_type=3"
    p = str(tmp_path / "interlaced.png")
    handmade_png(p, 8, 4, 8, 2, interlace=1)
    cases[p] = "interlace=1"
    p = str(tmp_path / "rgb16.png")
    handmade_png(p, 8, 4, 16, 2)
    cases[p] = "bit_depth=16 color_type=2"
    good = str(tmp_path / "good.png")
    png.write_png(good, nyu_rgb(smooth_depth(20, 30)), filters=(4,))
    data = open(good, "rb").read()
    p = str(tmp_path / "truncated.png")
    open(p, "wb").write(data[:len(data) // 2])
    cases[p] = "truncated"
    p = str(tmp_path / "badfilter.png")
    raw = b"".join(b"\x07" + bytes(9) for _ in range(2))
    with open(p, "wb") as fh:
        fh.write(png.SIGNATURE)
        fh.write(png._chunk(b"IHDR", struct.pack(">IIBBBBB", 3, 2, 8, 2, 0,
                                                 0, 0)))
        fh.write(png._chunk(b"IDAT", zlib.compress(raw)))
        fh.write(png._chunk(b"IEND", b""))
    cases[p] = "bad filter byte 7 on row 0"
    p = str(tmp_path / "not.png")
    open(p, "wb").write(b"GIF89a" + bytes(40))
    cases[p] = "not a PNG"
    for path, what in cases.items():
        with pytest.raises(ValueError, match=what) as e:
            native_decode.decode_depth_png(path)
        assert os.path.basename(path) in str(e.value)
    with pytest.raises(ValueError, match="bad filter byte 7"):
        png.unfilter_plain(png.inflate_depth_png(
            str(tmp_path / "badfilter.png"))[0], 3)


def test_device_crop_equals_host_crop_at_every_width():
    """The raw path's device crop against the host crop (OpenCV's nearest
    index) at crop widths 100-260 px, resized to 128: equal to the
    normalization's float32 rounding.  Among them w = 186, where the
    float32 quotient 64 * 186 / 128 = 93 that the JAX package's device
    crop takes picks another source column than OpenCV's 92.99999999999999
    (ROADMAP queue 3): its crop differs from the host crop there."""
    import jax.numpy as jnp
    import torch

    from awr_tpu.data.device import crop_normalize_batch as jax_crop
    from awr_tpu_torch.data.device import crop_normalize_batch

    rng = np.random.RandomState(5)
    img = rng.uniform(600, 1000, (480, 640)).astype(np.float32)
    img[rng.rand(480, 640) < 0.2] = 0
    z = 800.0
    widths = np.arange(100, 262, 2)
    centers = np.tile([320.0, 240.0, z], (len(widths), 1))
    cubes = np.stack([widths * z / NYU_PARAS[0], widths * z / NYU_PARAS[1],
                      np.full(len(widths), 300.0)], 1)
    got, _ = crop_normalize_batch(torch.from_numpy(np.stack([img] * len(
        widths))), centers, cubes, NYU_PARAS, 128)
    crop = CameraCrop(NYU_PARAS, NYU_FLIP, 128)
    want = []
    for c, cube in zip(centers, cubes):
        assert crop.center2bounds(c, cube)[1] - crop.center2bounds(
            c, cube)[0] in widths
        m, _ = crop.crop(img, c, cube, 128)
        want.append(crop.normalize(m.max(), m, c[2], cube[2]))
    want = np.stack(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    theirs, _ = jax_crop(jnp.asarray(np.stack([img] * len(widths))),
                         jnp.asarray(centers, jnp.float32),
                         jnp.asarray(cubes, jnp.float32),
                         jnp.asarray(NYU_PARAS), 128)
    off = np.abs(np.asarray(theirs) - want).max(axis=(1, 2)) > 1e-6
    assert 186 in widths[off]


def test_host_build_hashes_its_source_and_raises(tmp_path, monkeypatch):
    """The PNG unfilter builds like the CUDA kernels: a library named by
    the hash of its source and flags, rebuilt when the source changes;
    no compiler, or a source that does not compile, raises (nothing falls
    back to the plain unfilter)."""
    from awr_tpu_torch import kernels

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = (kernels.CSRC / "png_unfilter.cpp").read_text()
    (csrc / "png_unfilter.cpp").write_text(src)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    first = kernels.library_path("png_unfilter")
    assert first.name.startswith("libpng_unfilter-")
    (csrc / "png_unfilter.cpp").write_text(src + "\n// edited\n")
    assert kernels.library_path("png_unfilter") != first
    (csrc / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="build failed for broken"):
        kernels.build(["broken"])
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        kernels.build(["png_unfilter"])
