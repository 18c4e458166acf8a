"""Host-side resize, augmentation and normalisation, numpy only.

The port's own copy of ``relation_detr_tpu/data/transforms.py``'s
``hflip``, ``_bilinear_taps``, ``resize_bilinear``, ``resize_shortest``
(both branches), ``random_size_crop``, ``normalize``, ``DetrPreset`` /
``detr()`` (the default train preset) and ``EvalPreset`` with
``normalize_host``. No cv2: the train resize, ``cv2.resize(INTER_LINEAR)``
there, is ``resize_linear`` here, which computes OpenCV's 8-bit fixed-point
arithmetic and gives its bytes on uint8 images; the eval resize is torch's
antialiased bilinear (``align_corners=False``), which the reference applies
at eval time.

The train preset draws from a ``random.Random`` that its caller passes in
(the loader seeds one per sample from the seed, the epoch and the dataset
index); given the same generator state its draws are the JAX preset's.
"""
from __future__ import annotations

import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

DETR_SCALES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)

# OpenCV's INTER_LINEAR coefficients for 8-bit images: weights in 11-bit
# fixed point (INTER_RESIZE_COEF_BITS)
_COEF_SCALE = 2048


def hflip(sample: Dict) -> Dict:
    image = sample["image"][:, ::-1]
    boxes = sample["boxes"].copy()
    w = sample["image"].shape[1]
    boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return {**sample, "image": np.ascontiguousarray(image), "boxes": boxes}


def _bilinear_taps(in_size: int, out_size: int, antialias: bool):
    """Per-output-pixel source indices and weights for 1D (antialiased)
    bilinear resampling: triangle filter, support widened by the downscale
    factor when antialias is on, weights renormalised over the in-bounds
    taps. Returns (js (out, K) int, w (out, K) float32)."""
    scale = in_size / out_size
    if antialias and scale > 1.0:
        support, inv = scale, 1.0 / scale
    else:
        support, inv = 1.0, 1.0
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    lo = np.floor(centers - support + 0.5).astype(np.int64)
    k = int(np.ceil(2.0 * support)) + 1
    js = lo[:, None] + np.arange(k)[None]
    w = np.maximum(1.0 - np.abs((js + 0.5 - centers[:, None]) * inv), 0.0)
    w = np.where((js >= 0) & (js < in_size), w, 0.0)
    w = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    return np.clip(js, 0, in_size - 1), w


def resize_bilinear(image: np.ndarray, out_h: int, out_w: int,
                    antialias: bool = True) -> np.ndarray:
    """torch's bilinear resize (align_corners=False), optionally
    antialiased, computed in float32; integer inputs round half away from
    zero."""
    in_dtype = image.dtype
    x = image.astype(np.float32, copy=False)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    js_h, w_h = _bilinear_taps(x.shape[0], out_h, antialias)
    js_w, w_w = _bilinear_taps(x.shape[1], out_w, antialias)
    x = (x[js_h] * w_h[..., None, None]).sum(axis=1)  # rows
    x = (x[:, js_w] * w_w[None, ..., None]).sum(axis=2)  # columns
    if squeeze:
        x = x[..., 0]
    if np.issubdtype(in_dtype, np.integer):
        info = np.iinfo(in_dtype)
        return np.clip(np.floor(x + 0.5), info.min, info.max).astype(in_dtype)
    return x.astype(in_dtype, copy=False)


def _linear_coefficients(in_size: int, out_size: int):
    """OpenCV's INTER_LINEAR taps along one axis: the source index of the
    first tap (float32 source coordinate, as OpenCV computes it), the second
    tap's (clamped), and both weights in 11-bit fixed point."""
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    first = np.floor(f).astype(np.int64)
    f = f - first.astype(np.float32)
    return (np.clip(first, 0, in_size - 1), np.clip(first + 1, 0, in_size - 1),
            np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int32),
            np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32))


def resize_linear(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(image, (out_w, out_h), interpolation=INTER_LINEAR)``.

    uint8 images take OpenCV's fixed-point path, bit for bit: the rows are
    combined exactly in integers (weights x 2048), then the columns with its
    vectorised rounding, ``(((s0 >> 4) * b0 >> 16) + ((s1 >> 4) * b1 >> 16)
    + 2) >> 2``. Past the borders the source coordinate clamps to the edge
    pixel. Other dtypes take the float bilinear ``resize_bilinear(...,
    antialias=False)``, the same filter without the fixed point."""
    if image.dtype != np.uint8:
        return resize_bilinear(image, out_h, out_w, antialias=False)
    h, w = image.shape[:2]
    x0, x1, a0, a1 = _linear_coefficients(w, out_w)
    y0, y1, b0, b1 = _linear_coefficients(h, out_h)
    x = image.astype(np.int32)
    shape = (1, out_w) + (1,) * (image.ndim - 2)
    rows = x[:, x0] * a0.reshape(shape) + x[:, x1] * a1.reshape(shape)  # x 2048
    shape = (out_h,) + (1,) * (image.ndim - 1)
    out = (((rows[y0] >> 4) * b0.reshape(shape)) >> 16) \
        + (((rows[y1] >> 4) * b1.reshape(shape)) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def shortest_side_size(h: int, w: int, size: int, max_size: int = 1333) -> Tuple[int, int]:
    """(h, w) with the shorter side scaled to ``size``, the longer one
    capped at ``max_size``: what ``resize_shortest`` resizes to."""
    r = size / min(h, w)
    if max_size is not None:
        r = min(r, max_size / max(h, w))
    return int(round(h * r)), int(round(w * r))


def resize_shortest(sample: Dict, size: int, max_size: Optional[int] = 1333,
                    antialias: bool = False) -> Dict:
    """Resize of the shorter side to ``size``, the longer one capped at
    ``max_size``; boxes scale with the image. ``antialias`` (eval): torch's
    antialiased bilinear; else (train) ``resize_linear``, cv2's."""
    h, w = sample["image"].shape[:2]
    new_h, new_w = shortest_side_size(h, w, size, max_size)
    if antialias:
        image = resize_bilinear(sample["image"], new_h, new_w, antialias=True)
    else:
        image = resize_linear(sample["image"], new_h, new_w)
    boxes = sample["boxes"] * np.asarray(
        [new_w / w, new_h / h, new_w / w, new_h / h], np.float32
    )
    return {**sample, "image": image, "boxes": boxes}


def random_size_crop(sample: Dict, min_size: int, max_size: int, rng: random.Random) -> Dict:
    h, w = sample["image"].shape[:2]
    cw = rng.randint(min(min_size, w), min(max_size, w))
    ch = rng.randint(min(min_size, h), min(max_size, h))
    x0 = rng.randint(0, max(w - cw, 0))
    y0 = rng.randint(0, max(h - ch, 0))
    image = sample["image"][y0 : y0 + ch, x0 : x0 + cw]
    boxes = sample["boxes"] - np.asarray([x0, y0, x0, y0], np.float32)
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, cw)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, ch)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    return {
        **sample,
        "image": np.ascontiguousarray(image),
        "boxes": boxes[keep],
        "labels": sample["labels"][keep],
    }


def normalize(sample: Dict) -> Dict:
    image = sample["image"].astype(np.float32) / 255.0
    image = (image - IMAGENET_MEAN) / IMAGENET_STD
    return {**sample, "image": image}


class DetrPreset:
    """The ``detr`` train preset (the reference's presets.py:60-74):
    horizontal flip with p=0.5, then with p=0.5 a shortest-side resize to a
    scale of ``scales`` (longer side at most ``max_size``), else a resize to
    one of ``crop_scales``, a random crop of ``crop_range`` and that
    multi-scale resize; then ImageNet normalisation.

    ``rng`` of a call is the generator it draws from (the JAX preset's
    shared ``self.rng``, seeded once, when None). ``normalize_host=False``
    keeps uint8 pixels, normalised on the card (``data/loader.py::
    device_prefetch``) with the same math."""

    def __init__(
        self,
        scales: Sequence[int] = DETR_SCALES,
        max_size: int = 1333,
        crop_scales: Sequence[int] = (400, 500, 600),
        crop_range=(384, 600),
        seed: int = 0,
        normalize_host: bool = True,
    ):
        self.scales = list(scales)
        self.max_size = max_size
        self.crop_scales = list(crop_scales)
        self.crop_range = crop_range
        self.rng = random.Random(seed)
        self.normalize_host = normalize_host

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        rng = self.rng if rng is None else rng
        if rng.random() < 0.5:
            sample = hflip(sample)
        if rng.random() < 0.5:
            sample = resize_shortest(sample, rng.choice(self.scales), self.max_size)
        else:
            sample = resize_shortest(sample, rng.choice(self.crop_scales), None)
            sample = random_size_crop(sample, *self.crop_range, rng)
            sample = resize_shortest(sample, rng.choice(self.scales), self.max_size)
        return normalize(sample) if self.normalize_host else sample


def detr(seed: int = 0, normalize_host: bool = True) -> DetrPreset:
    return DetrPreset(seed=seed, normalize_host=normalize_host)


class EvalPreset:
    """Eval resize + normalise on the host, as the reference's in-model
    transform.

    ``normalize_host=False`` keeps uint8 pixels; the detections function
    normalises on the card (``utils/evaluation.py::make_detections_fn``),
    with the same math, and the host-to-card copy is 4x smaller."""

    def __init__(self, min_size: int = 800, max_size: int = 1333,
                 normalize_host: bool = True):
        self.min_size = min_size
        self.max_size = max_size
        self.normalize_host = normalize_host

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        """``rng`` is accepted for the loader's sake: nothing here is random."""
        sample = resize_shortest(sample, self.min_size, self.max_size, antialias=True)
        return normalize(sample) if self.normalize_host else sample
