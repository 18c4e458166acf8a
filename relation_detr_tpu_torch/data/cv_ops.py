"""numpy counterparts of the OpenCV calls the JAX package's data path makes.

The card's machine has no cv2, so each function here computes what the named
cv2 call computes on uint8 input, with OpenCV's integer tables, fixed-point
rounding and fused multiply-adds, and gives its bytes:

- ``rgb2hsv`` / ``hsv2rgb``: ``cvtColor(COLOR_RGB2HSV / COLOR_HSV2RGB)``,
  8-bit, H in [0, 180);
- ``rgb2gray``: ``cvtColor(COLOR_RGB2GRAY)``;
- ``blur3`` / ``median3``: ``cv2.blur(img, (3, 3))`` (BORDER_REFLECT_101) and
  ``cv2.medianBlur(img, 3)`` (BORDER_REPLICATE);
- ``gaussian_blur5``: ``cv2.GaussianBlur(float32, (5, 5), 2.0)``; bit-equal on
  the 0/1 alpha maps the copy-paste blends with, within 2 float32 ulps of
  cv2's value on other float input;
- ``shift``: ``warpAffine`` by an integer translation, constant-0 border
  (INTER_LINEAR on images, INTER_NEAREST on masks: both copy pixels);
- ``resize_nearest``: ``cv2.resize(INTER_NEAREST)`` (source index
  ``floor(x * in / out)``); ``data/transforms.py::resize_linear`` is the
  INTER_LINEAR one;
- ``fill_poly``: ``cv2.fillPoly(mask, polys, value)`` on int32 vertices;
- ``jpeg_roundtrip``: ``cv2.imdecode(cv2.imencode(".jpg", img, quality),
  IMREAD_UNCHANGED)``, libjpeg's baseline 4:2:0 encode and decode in pixels
  (the entropy coding is lossless and left out).

``tests/data/torch_port/make_fixtures.py`` writes cv2's outputs of each as
``cv_ops_golden.npz``; ``tests/test_torch_data_presets.py`` and
``chip_smoke.py`` phase 14 (a) hold these functions to them.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from relation_detr_tpu_torch.data.image_io import ycc_to_rgb_reference

# --------------------------------------------------------------------------
# colour conversions (OpenCV's color_hsv / color_rgb, 8-bit)

_HSV_SHIFT = 12
# OpenCV's HSV2RGB_b converts blocks of 32 pixels of a row with vector code
# that truncates to uint8; the pixels past the last whole block take its
# scalar code, which rounds to nearest
_HSV2RGB_BLOCK = 32
# which of (v, v(1-s), v(1-sf), v(1-s(1-f))) is (b, g, r) in each sector
_HSV_SECTORS = np.asarray([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)  # saturate_cast<int>: round half to even
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` of an (..., 3) uint8 RGB array:
    OpenCV's division tables in 12-bit fixed point, H in [0, 180)."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _one_minus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 ``1 - a * b`` with one rounding, as the fused multiply-add
    OpenCV's build computes it (the product of two float32 is exact in
    float64)."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)


def hsv2rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_HSV2RGB)`` of an (H, W, 3) uint8 HSV image
    (H in [0, 180)): OpenCV's float32 sector arithmetic with its fused
    multiply-adds; per row, the first ``W // 32 * 32`` pixels truncate to
    uint8 (its vector code), the rest round to nearest (its scalar code)."""
    one = np.float32(1.0)
    h = img[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = img[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = img[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    sector = np.floor(h)
    f = (h - sector).astype(np.float32)
    sector = sector.astype(np.int64) % 6
    tab = np.stack([v, v * (one - s), v * _one_minus(s, f), v * _one_minus(s, one - f)],
                   axis=-1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr) * np.float32(255.0)
    out = np.rint(bgr)
    block = img.shape[1] // _HSV2RGB_BLOCK * _HSV2RGB_BLOCK
    out[:, :block] = np.trunc(bgr[:, :block])
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1]


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2GRAY)`` of an (..., 3) uint8 array:
    OpenCV's 15-bit fixed-point weights, rounded."""
    x = img.astype(np.int64)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14)) >> 15
            ).astype(np.uint8)


# --------------------------------------------------------------------------
# filters


def _windows(img: np.ndarray, k: int, mode: str):
    """The k*k shifted views of ``img`` padded by k // 2 (numpy ``mode``)."""
    r = k // 2
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    p = np.pad(img, pad, mode=mode)
    h, w = img.shape[:2]
    return [p[i:i + h, j:j + w] for i in range(k) for j in range(k)]


def blur3(img: np.ndarray) -> np.ndarray:
    """``cv2.blur(img, (3, 3))`` on uint8: the 3x3 box mean rounded
    (BORDER_REFLECT_101, numpy's "reflect")."""
    s = sum(w.astype(np.int32) for w in _windows(img, 3, "reflect"))
    return ((s + 4) // 9).astype(np.uint8)


# a median-of-9 network (Devillard's opt_med9): compare-exchange pairs
_MEDIAN9 = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 3),
            (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4), (4, 2))


def median3(img: np.ndarray) -> np.ndarray:
    """``cv2.medianBlur(img, 3)`` on uint8 (BORDER_REPLICATE)."""
    p = _windows(img, 3, "edge")
    for i, j in _MEDIAN9:
        p[i], p[j] = np.minimum(p[i], p[j]), np.maximum(p[i], p[j])
    return p[4]


_GAUSS5_SIGMA2 = np.exp(-((np.arange(5) - 2.0) ** 2) / (2.0 * 2.0 ** 2))
_GAUSS5_SIGMA2 = (_GAUSS5_SIGMA2 / _GAUSS5_SIGMA2.sum()).astype(np.float32)
# OpenCV's float filters take vectors of 8 floats with fused multiply-adds
# and the columns past the last whole vector with plain multiply and add
_FILTER_BLOCK = 8


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


def _symmetric5(p: np.ndarray, n: int, axis: int, fused: bool) -> np.ndarray:
    """One pass of the symmetric 5-tap kernel along ``axis`` of ``p``
    (padded by 2 there): OpenCV's SymmRowSmall / SymmColumn order,
    ``k0 x0 + k1 (x-1 + x1) + k2 (x-2 + x2)``."""
    take = lambda o: np.take(p, np.arange(2 + o, 2 + o + n), axis=axis)  # noqa: E731
    k2, k1, k0 = (np.float32(v) for v in _GAUSS5_SIGMA2[:3])
    a1 = take(-1) + take(1)
    a2 = take(-2) + take(2)
    s = take(0) * k0
    if fused:
        return _fma(a2, k2, _fma(a1, k1, s))
    return (s + a1 * k1) + a2 * k2


def gaussian_blur5(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (5, 5), 2.0)`` of a 2-D float32 array:
    OpenCV's float32 kernel, rows then columns, BORDER_REFLECT_101, fused
    multiply-adds on the columns of whole 8-float vectors (numpy's "reflect"
    padding). Bit-equal to cv2's on 0/1 maps (``cv_ops_golden.npz``)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    block = w // _FILTER_BLOCK * _FILTER_BLOCK
    p = np.pad(img, ((0, 0), (2, 2)), mode="reflect")
    rows = np.concatenate([_symmetric5(p[:, :block + 4], block, 1, True),
                           _symmetric5(p[:, block:], w - block, 1, False)], axis=1)
    p = np.pad(rows, ((2, 2), (0, 0)), mode="reflect")
    return np.concatenate([_symmetric5(p[:, :block], h, 0, True),
                           _symmetric5(p[:, block:], h, 0, False)], axis=1)


# --------------------------------------------------------------------------
# geometry


def shift(img: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """``cv2.warpAffine(img, [[1, 0, dx], [0, 1, dy]], (w, h),
    borderValue=0)`` for integer ``dx``, ``dy``: pixel (y, x) takes source
    pixel (y - dy, x - dx), 0 where that is outside (INTER_LINEAR and
    INTER_NEAREST both copy at integer offsets)."""
    h, w = img.shape[:2]
    out = np.zeros_like(img)
    if abs(dx) >= w or abs(dy) >= h:
        return out
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        img[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out


def resize_nearest(img: np.ndarray, out_h: int, out_w: int, axis: int = 0) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_NEAREST)`` of
    axes ``axis`` and ``axis + 1`` (1 for an (N, H, W) stack of masks):
    source index ``min(floor(x * (1 / (out / in))), in - 1)`` in float64, as
    OpenCV's."""
    h, w = img.shape[axis:axis + 2]
    iy = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))).astype(np.int64), h - 1)
    ix = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))).astype(np.int64), w - 1)
    return np.ascontiguousarray(np.take(np.take(img, iy, axis=axis), ix, axis=axis + 1))


# --------------------------------------------------------------------------
# polygon fill (OpenCV's drawing.cpp: the outline drawn with 8-connected
# Bresenham lines, edges in fixed point, even-odd scanlines)

_FILL_SHIFT = 32  # fraction bits of the edges' x (16 does not give cv2 5.0's bytes)
_FILL_HALF = 1 << (_FILL_SHIFT - 1)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to [0, w-1] x [0, h-1]: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """(xs, ys) of OpenCV's 8-connected ``LineIterator`` from (x1, y1) to
    (x2, y2), clipped to the image, drawn left to right; None when the line
    misses the image."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return None
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, sy = -dy, -1
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1)
    # Bresenham's minor steps: the least n with 2 major n + major >= 2 minor k
    n = np.maximum(0, -((major - 2 * minor * k) // (2 * major))) if major else k
    if dy > dx:
        return x1 + n, y1 + sy * k
    return x1 + k, y1 + sy * n


def _edges(polys, w: int, h: int, mask: np.ndarray, value):
    """Draws each polygon's outline; returns its non-horizontal edges as
    (top row, bottom row, x at the top row, x step a row), x in fixed point
    measured to pixel centres (+0.5), and for each edge two row ranges
    (start, stop, side) where it runs outside the image's columns. An edge
    that leaves the image takes the end points ``clipLine`` gives it
    (extrapolated over its whole rows); in the rows between an end point
    left or right of the image and its clip point, its x is held outside
    the image (side -1: at most 0; side 1: at least the right border)."""
    edges, outside = [], []
    for poly in polys:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        x0, y0 = pts[-1]
        for x1, y1 in pts:
            line = _line(w, h, x0, y0, x1, y1)
            if line is not None:
                mask[line[1], line[0]] = value
            cx0, cy0, cx1, cy1 = x0, y0, x1, y1
            parts = []
            if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
                inside, cx0, ty0, cx1, ty1 = _clip_line(w, h, x0, y0, x1, y1)
                if ty0 != ty1:
                    cy0, cy1 = ty0, ty1
                    for vx, vy, cx, ty in ((x0, y0, cx0, ty0), (x1, y1, cx1, ty1)):
                        side = 1 if vx > w - 1 and cx == w - 1 else -1 if vx < 0 and cx == 0 else 0
                        if inside and side and ty != vy:
                            parts.append((vy, ty, side) if vy < ty else (ty + 1, vy + 1, side))
            if y0 != y1:
                fx0 = (cx0 << _FILL_SHIFT) + _FILL_HALF
                fx1 = (cx1 << _FILL_SHIFT) + _FILL_HALF
                step = (fx1 - fx0) // (cy1 - cy0)
                if y0 < y1:
                    edges.append((y0, y1, fx0 + (y0 - cy0) * step, step))
                else:
                    edges.append((y1, y0, fx1 + (y1 - cy1) * step, step))
                outside.append((parts + [(0, 0, 0)] * 2)[:2])
            x0, y0 = x1, y1
    return edges, outside


def fill_poly(mask: np.ndarray, polys: Sequence[np.ndarray], value=1) -> np.ndarray:
    """``cv2.fillPoly(mask, polys, value)`` on a 2-D mask, in place, for int32
    (N, 2) vertex arrays: each outline drawn with 8-connected lines, then
    every row filled between pairs of its edges taken in x order (even-odd,
    all polygons' edges together), from the pixel under the left edge's x
    to the last pixel before the right edge's.

    Bit-equal to cv2 (5.0): the 400 golden masks of ``cv_ops_golden.npz``
    (polygons inside the image, leaving it, with vertices on its border),
    and ``tests/data/torch_port/make_fixtures.py --fill-poly-report`` (also
    far outside it, and on a 480x640 image). The 32 fraction bits and the
    held outside rows are what cv2 5.0's output fixes: 16 bits differ on
    long edges, and without the held rows a polygon with a vertex right of
    the image fills pixels cv2 leaves empty."""
    h, w = mask.shape[:2]
    edges, outside = _edges(polys, w, h, mask, value)
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, np.int64)
    o = np.asarray(outside, np.int64)
    y_lo, y_hi = max(int(e[:, 0].min()), 0), min(int(e[:, 1].max()), h)
    if y_hi <= y_lo:
        return mask
    ys = np.arange(y_lo, y_hi)[:, None]
    active = (e[None, :, 0] <= ys) & (ys < e[None, :, 1])
    xs = e[None, :, 2] + (ys - e[None, :, 0]) * e[None, :, 3]
    for k in range(2):
        held = (o[None, :, k, 0] <= ys) & (ys < o[None, :, k, 1])
        xs = np.where(held & (o[None, :, k, 2] > 0), np.maximum(xs, w << _FILL_SHIFT), xs)
        xs = np.where(held & (o[None, :, k, 2] < 0), np.minimum(xs, 0), xs)
    xs = np.sort(np.where(active, xs, np.iinfo(np.int64).max), axis=1)
    pairs = xs.shape[1] // 2
    valid = 2 * np.arange(pairs)[None] + 1 < active.sum(1)[:, None]
    x1 = xs[:, 0:2 * pairs:2] >> _FILL_SHIFT
    x2 = (np.where(valid, xs[:, 1:2 * pairs:2], 0) - 1) >> _FILL_SHIFT
    valid &= (x1 < w) & (x2 >= 0)
    rows, cols = np.nonzero(valid)
    marks = np.zeros((len(ys), w + 1), np.int32)
    np.add.at(marks, (rows, np.maximum(x1[rows, cols], 0)), 1)
    np.add.at(marks, (rows, np.minimum(x2[rows, cols], w - 1) + 1), -1)
    fill_rows, fill_cols = np.nonzero(np.cumsum(marks[:, :w], axis=1) > 0)
    mask[ys[fill_rows, 0], fill_cols] = value
    return mask


# --------------------------------------------------------------------------
# JPEG round trip (libjpeg-turbo: jccolor, jcsample h2v2, jfdctint,
# jcdctmgr's reciprocal quantisation, jidctint; jdsample / jdcolor through
# image_io.ycc_to_rgb_reference)

_STD_LUMA = np.asarray([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA = np.full(64, 99, np.int64)
_STD_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = \
    [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961, _F2053, _F2562,
 _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819, 20995, 25172)


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_set_quality(quality, force_baseline=TRUE)`` table
    from a standard one (8x8, natural order)."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255).reshape(8, 8)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, axis, final):
    """One pass of libjpeg's islow forward DCT along ``axis`` (8 long)."""
    x = [np.take(d, i, axis=axis) for i in range(8)]
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = _CONST_BITS + _PASS1_BITS if final else _CONST_BITS - _PASS1_BITS
    out = [None] * 8
    if final:
        out[0], out[4] = _descale(tmp10 + tmp11, _PASS1_BITS), _descale(tmp10 - tmp11, _PASS1_BITS)
    else:
        out[0], out[4] = (tmp10 + tmp11) << _PASS1_BITS, (tmp10 - tmp11) << _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, shift)
    out[6] = _descale(z1 - tmp12 * _F1847, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2, z3, z4 = -z1 * _F0899, -z2 * _F2562, -z3 * _F1961 + z5, -z4 * _F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return np.stack(out, axis=axis)


def _idct_1d(x, axis, final):
    """One pass of libjpeg's islow inverse DCT along ``axis``."""
    c = [np.take(x, i, axis=axis) for i in range(8)]
    z1 = (c[2] + c[6]) * _F0541
    tmp2, tmp3 = z1 - c[6] * _F1847, z1 + c[2] * _F0765
    tmp0, tmp1 = (c[0] + c[4]) << _CONST_BITS, (c[0] - c[4]) << _CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _F1175
    tmp0, tmp1, tmp2, tmp3 = tmp0 * _F0298, tmp1 * _F2053, tmp2 * _F3072, tmp3 * _F1501
    z1, z2, z3, z4 = -z1 * _F0899, -z2 * _F2562, -z3 * _F1961 + z5, -z4 * _F0390 + z5
    tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
    n = _CONST_BITS + _PASS1_BITS + 3 if final else _CONST_BITS - _PASS1_BITS
    out = [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
           tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]
    return np.stack([_descale(v, n) for v in out], axis=axis)


def _range_limit(v):
    """jdmaster's post-IDCT table: the 10-bit wrapped value, +128, clamped."""
    v = v & 1023
    return np.where(v < 128, v + 128, np.where(v < 512, 255, np.where(v < 896, 0, v - 896)))


def _quantize(coef, qt):
    """jcdctmgr's quantisation of islow coefficients (scaled by 8) through
    the 16-bit reciprocal, correction and shift of ``compute_reciprocal``."""
    d = qt.astype(np.int64) << 3
    b = np.floor(np.log2(d)).astype(np.int64)
    r = 16 + b
    fq, fr = (np.int64(1) << r) // d, (np.int64(1) << r) % d
    c = d // 2
    exact = fr == 0
    fq = np.where(exact, fq >> 1, np.where(fr <= d // 2, fq, fq + 1))
    r = np.where(exact, r - 1, r)
    c = np.where(~exact & (fr <= d // 2), c + 1, c)
    q = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -q, q)


def _codec_plane(plane: np.ndarray, qt: np.ndarray, h: int, w: int) -> np.ndarray:
    """One component through islow FDCT, quantisation, dequantisation and
    islow IDCT: its 8x8 blocks (the last row and column replicated to
    whole blocks), cropped to (h, w)."""
    p = np.pad(plane.astype(np.int64), ((0, -plane.shape[0] % 8), (0, -plane.shape[1] % 8)),
               mode="edge") - 128
    blocks = p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8).transpose(0, 2, 1, 3)
    coef = _fdct_1d(_fdct_1d(blocks, 3, False), 2, True)
    coef = _quantize(coef, qt) * qt
    pixels = _range_limit(_idct_1d(_idct_1d(coef, 2, False), 3, True))
    return pixels.transpose(0, 2, 1, 3).reshape(p.shape)[:h, :w].astype(np.uint8)


def jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY,
    quality])[1], IMREAD_UNCHANGED)`` of an (H, W, 3) uint8 array, which cv2
    reads as BGR and returns in the same channel order: libjpeg-turbo's
    baseline 4:2:0 encode (fixed-point YCbCr, h2v2 downsampling with its
    alternating bias, edge replication to whole blocks, islow FDCT,
    reciprocal quantisation at the scaled standard tables) and its decode
    (islow IDCT with the range limit, fancy upsampling and fixed-point RGB,
    ``image_io.ycc_to_rgb_reference``)."""
    x = img.astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    half, offset = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + offset + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + offset + half - 1) >> 16
    h, w = y.shape

    def down(c):
        # h2v2 of the rows padded to even and the columns to whole chroma
        # blocks (16 pixels), both by replication; bias 1, 2, 1, 2, ...
        c = np.pad(c, ((0, h % 2), (0, -w % 16)), mode="edge")
        s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
        bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
        return (s + bias) >> 2

    luma_q = _quant_table(_STD_LUMA, quality)
    chroma_q = _quant_table(_STD_CHROMA, quality)
    ch, cw = -(-h // 2), -(-w // 2)
    planes = [_codec_plane(y, luma_q, h, w), _codec_plane(down(cb), chroma_q, ch, cw),
              _codec_plane(down(cr), chroma_q, ch, cw)]
    rgb = ycc_to_rgb_reference(*(torch.from_numpy(p) for p in planes), 2, 2).numpy()
    return np.ascontiguousarray(rgb[..., ::-1])
