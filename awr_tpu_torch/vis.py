"""Skeleton overlay rendering for qualitative inspection (the JAX
package's ``vis.py``, drawn with numpy instead of OpenCV).

Reference parity: util/vis_tool.py: depth mapped to gray via
``(img + 1) * 100`` (ref :20), the prediction skeleton in reds and the
GT in blues (BGR tuples, ref :11-14), per-dataset joint groups and bones
(ref :43-78).  Joints are filled radius-2 disks and bones one-pixel
8-connected lines: the pixels ``cv2.circle`` and ``cv2.line`` draw.
"""

from __future__ import annotations

import numpy as np

from awr_tpu_torch.utils.png import write_png

# RED shades, BGR (reference vis_tool.py:11)
COLOR_PRED = [(0, 0, 102), (0, 0, 179), (0, 0, 255), (77, 77, 255),
              (153, 153, 255)]
# BLUE shades, BGR (reference vis_tool.py:14)
COLOR_GT = [(102, 0, 0), (179, 0, 0), (255, 0, 0), (255, 77, 77),
            (255, 153, 153)]

# per-dataset (joint groups, bones) (reference vis_tool.py:43-78)
SKELETONS = {
    "nyu": (
        [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9, 10, 11, 12, 13]],
        [[(0, 1), (1, 13)],
         [(2, 3), (3, 13)],
         [(4, 5), (5, 13)],
         [(6, 7), (7, 13)],
         [(8, 9), (9, 10), (10, 13), (11, 13), (12, 13)]],
    ),
    "hands17": (
        [[1, 6, 7, 8], [2, 9, 10, 11], [3, 12, 13, 14], [4, 15, 16, 17],
         [5, 18, 19, 20, 0]],
        [[(0, 1), (1, 6), (6, 7), (7, 8)],
         [(0, 2), (2, 9), (9, 10), (10, 11)],
         [(0, 3), (3, 12), (12, 13), (13, 14)],
         [(0, 4), (4, 15), (15, 16), (16, 17)],
         [(0, 5), (5, 18), (18, 19), (19, 20)]],
    ),
    "icvl": (
        [[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12], [13, 14, 15, 0]],
        [[(0, 1), (1, 2), (2, 3)],
         [(0, 4), (4, 5), (5, 6)],
         [(0, 7), (7, 8), (8, 9)],
         [(0, 10), (10, 11), (11, 12)],
         [(0, 13), (13, 14), (14, 15)]],
    ),
    "msra": (
        [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16],
         [17, 18, 19, 20, 0]],
        [[(0, 1), (1, 2), (2, 3), (3, 4)],
         [(0, 5), (5, 6), (6, 7), (7, 8)],
         [(0, 9), (9, 10), (10, 11), (11, 12)],
         [(0, 13), (13, 14), (14, 15), (15, 16)],
         [(0, 17), (17, 18), (18, 19), (19, 20)]],
    ),
}

# the pixels of cv2.circle(..., radius=2, thickness=-1): |dx| + |dy| <= 2
_DISK = [(dx, dy) for dy in range(-2, 3) for dx in range(-2, 3)
         if abs(dx) + abs(dy) <= 2]


def _put(image, xs, ys, color) -> None:
    """Set the in-bounds pixels (xs, ys) of ``image`` to ``color``."""
    h, w = image.shape[:2]
    xs, ys = np.asarray(xs), np.asarray(ys)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    image[ys[keep], xs[keep]] = color


def draw_disk(image, center, color) -> None:
    x, y = center
    _put(image, [x + dx for dx, _ in _DISK], [y + dy for _, dy in _DISK],
         color)


def _clip_line(w: int, h: int, p0, p1):
    """OpenCV's ``clipLine``: the end points moved onto the image's
    border (truncating toward zero), and whether any of the line is
    left."""
    (x1, y1), (x2, y2) = p0, p1
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def draw_line(image, p0, p1, color) -> None:
    """One-pixel 8-connected line from p0 to p1 (integer (x, y)) as
    ``cv2.line`` draws it: clipped to the image, then Bresenham run left
    to right, which after k steps along the major axis of length D has
    moved floor((2 d k + D - 1) / (2 D)) along the minor one of length
    d."""
    h, w = image.shape[:2]
    visible, (x0, y0), (x1, y1) = _clip_line(w, h, p0, p1)
    if not visible:
        return
    if x1 < x0:
        (x0, y0), (x1, y1) = (x1, y1), (x0, y0)
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    D, d = max(dx, dy), min(dx, dy)
    k = np.arange(D + 1)
    minor = (2 * d * k + D - 1) // (2 * D) if D else k
    if dx >= dy:
        _put(image, x0 + k, y0 + sy * minor, color)
    else:
        _put(image, x0 + minor, y0 + sy * k, color)


def _draw_skeleton(image, jt_uvd, colors, dataset):
    jt_idx, sketch = SKELETONS[dataset]
    pt = lambda j: (int(jt_uvd[j][0]), int(jt_uvd[j][1]))  # noqa: E731
    for i, color in enumerate(colors):
        for idx in jt_idx[i]:
            draw_disk(image, pt(idx), color)
        for s, e in sketch[i]:
            draw_line(image, pt(s), pt(e), color)


def render_pose(img, jt_uvd_pred, jt_uvd_gt=None, dataset="nyu"):
    """Render overlay; returns an HxWx3 BGR image in the uint8 range
    (floats).

    Args:
      img: (H, W) or (1, H, W) normalized depth in [-1, 1].
      jt_uvd_pred / jt_uvd_gt: (J, 3) in crop *pixel* coordinates.
    """
    image = np.squeeze(np.asarray(img)).copy()
    image = (image + 1) * 100.0
    image = np.repeat(image[:, :, None], 3, axis=-1)
    _draw_skeleton(image, np.asarray(jt_uvd_pred).reshape(-1, 3),
                   COLOR_PRED, dataset)
    if jt_uvd_gt is not None:
        _draw_skeleton(image, np.asarray(jt_uvd_gt).reshape(-1, 3),
                       COLOR_GT, dataset)
    return image


def plot_pose(img, path, jt_uvd_pred, jt_uvd_gt=None, dataset="nyu"):
    """Render and write a PNG (reference vis_tool.py:17-28)."""
    write_png(path, render_pose(img, jt_uvd_pred, jt_uvd_gt,
                                dataset)[..., ::-1])
