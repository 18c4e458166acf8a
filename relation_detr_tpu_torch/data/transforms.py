"""Eval resize and normalisation on the host, numpy only.

The port's own copy of the eval half of
``relation_detr_tpu/data/transforms.py`` (``_bilinear_taps``,
``resize_bilinear``, the antialiased branch of ``resize_shortest``,
``normalize`` and ``EvalPreset`` with ``normalize_host``): torch's
antialiased bilinear resize (``align_corners=False``), which the reference
applies at eval time, then ImageNet normalisation. No cv2.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


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


def shortest_side_size(h: int, w: int, size: int, max_size: int = 1333) -> Tuple[int, int]:
    """(h, w) with the shorter side scaled to ``size``, the longer one
    capped at ``max_size``: what ``resize_shortest`` resizes to."""
    r = size / min(h, w)
    if max_size is not None:
        r = min(r, max_size / max(h, w))
    return int(round(h * r)), int(round(w * r))


def resize_shortest(sample: Dict, size: int, max_size: int = 1333) -> Dict:
    """Antialiased resize of the shorter side to ``size``, the longer one
    capped at ``max_size``; boxes scale with the image."""
    h, w = sample["image"].shape[:2]
    new_h, new_w = shortest_side_size(h, w, size, max_size)
    image = resize_bilinear(sample["image"], new_h, new_w, antialias=True)
    boxes = sample["boxes"] * np.asarray(
        [new_w / w, new_h / h, new_w / w, new_h / h], np.float32
    )
    return {**sample, "image": image, "boxes": boxes}


def normalize(sample: Dict) -> Dict:
    image = sample["image"].astype(np.float32) / 255.0
    image = (image - IMAGENET_MEAN) / IMAGENET_STD
    return {**sample, "image": image}


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

    def __call__(self, sample: Dict) -> Dict:
        sample = resize_shortest(sample, self.min_size, self.max_size)
        return normalize(sample) if self.normalize_host else sample
