"""Host-side resize, augmentation and normalisation, numpy only.

The port's own copy of ``relation_detr_tpu/data/transforms.py``: the
geometric ops (``hflip``, ``vflip``, ``resize_shortest``, ``resize_fixed``,
``random_size_crop``, ``scale_jitter``, ``fixed_size_crop``,
``shift_image``, ``random_zoom_out``, ``random_iou_crop``, ``_sanitize``),
the colour ops (``ColorAugmentations``, ``photometric_distort``),
``normalize``, ``Compose``, every preset (``DetrPreset``, ``LSJPreset``,
``StrongAlbumPreset``, ``MultiscalePreset``, ``SSDPreset``,
``RTDetrPreset``, ``EvalPreset``) and the registry (``detr``, ``lsj``,
``lsj_1536``, ``strong_album``, ``strong_album_1200_2000``, ``multiscale``,
``ssd``, ``ssdlite``, ``rtdetr_transform``, ``mosaic_detr``). No cv2:
``cv2.resize(INTER_LINEAR)`` is ``resize_linear`` here (OpenCV's 8-bit
fixed point, its bytes on uint8), the eval resize is torch's antialiased
bilinear, and the colour ops go through ``data/cv_ops.py``, which gives
cv2's bytes.

Each preset takes ``normalize_host``: False keeps uint8 pixels, normalised
on the card (``data/loader.py::Normalizer``) with the same math. A preset
draws from the ``random.Random`` its caller passes (the loader seeds one
per sample from the seed, the epoch and the dataset index), or from its own
generator seeded as the JAX preset's. A preset whose JAX counterpart seeds
several generators (``StrongAlbumPreset``: its own and its
``ColorAugmentations``'; ``Compose``: one a stage) takes one child
generator a stage from the passed one, in stage order (``children``); given
those states its draws are the JAX preset's.

Differences from the JAX package, kept on purpose:
- ``ColorAugmentations``' JPEG step returns cv2's round trip in the input's
  channel order, as the reference's albumentations ``ImageCompression``
  does; the JAX step swaps R and B (it decodes as BGR and converts).
- ``StrongAlbumPreset(normalize_host=True)`` normalises, as the reference
  does; the JAX preset never normalises.
- Where a sample carries ``masks`` (``CocoDetection(return_masks=True)``),
  ``hflip``, ``resize_shortest``, ``random_size_crop`` and Mosaic move them
  with the image (nearest-neighbour resize, as cv2's INTER_NEAREST), as
  the reference's mask transforms do, so that ``mosaic_detr`` can feed the
  mask-based ``SimpleCopyPaste``; the JAX ops leave them as they were.
  Without masks the outputs are the JAX ones.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from relation_detr_tpu_torch.data import cv_ops

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

DETR_SCALES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)

# OpenCV's INTER_LINEAR coefficients for 8-bit images: weights in 11-bit
# fixed point (INTER_RESIZE_COEF_BITS)
_COEF_SCALE = 2048


def children(rng: random.Random, n: int) -> List[random.Random]:
    """``n`` generators seeded from ``rng``'s next 64-bit draws, in order:
    one for each stage of a preset whose JAX form seeds several."""
    return [random.Random(rng.getrandbits(64)) for _ in range(n)]


def _with_masks(result: Dict, sample: Dict, fn, keep=None) -> Dict:
    """``result`` with ``sample``'s masks moved by ``fn`` (an (N, H, W)
    stack in, one out) and filtered by ``keep``, where it has masks."""
    masks = sample.get("masks")
    if masks is not None:
        masks = fn(masks)
        result["masks"] = masks if keep is None else masks[keep]
    return result


def hflip(sample: Dict) -> Dict:
    image = sample["image"][:, ::-1]
    boxes = sample["boxes"].copy()
    w = sample["image"].shape[1]
    boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    result = {**sample, "image": np.ascontiguousarray(image), "boxes": boxes}
    return _with_masks(result, sample, lambda m: np.ascontiguousarray(m[:, :, ::-1]))


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
    return _with_masks({**sample, "image": image, "boxes": boxes}, sample,
                       lambda m: cv_ops.resize_nearest(m, new_h, new_w, axis=1))


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
    result = {
        **sample,
        "image": np.ascontiguousarray(image),
        "boxes": boxes[keep],
        "labels": sample["labels"][keep],
    }
    return _with_masks(result, sample,
                       lambda m: np.ascontiguousarray(m[:, y0:y0 + ch, x0:x0 + cw]), keep)


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


def scale_jitter(sample: Dict, target_size, scale_range, rng: random.Random) -> Dict:
    """LSJ's ScaleJitter: a scale drawn from ``scale_range`` relative to the
    fit of ``target_size`` (the reference's presets.py:30-48)."""
    h, w = sample["image"].shape[:2]
    th, tw = target_size
    scale = rng.uniform(*scale_range) * min(th / h, tw / w)
    new_h, new_w = max(int(h * scale), 1), max(int(w * scale), 1)
    image = resize_linear(sample["image"], new_h, new_w)
    boxes = sample["boxes"] * np.asarray(
        [new_w / w, new_h / h, new_w / w, new_h / h], np.float32
    )
    return {**sample, "image": image, "boxes": boxes}


def fixed_size_crop(sample: Dict, size, rng: random.Random, fill: int = 114) -> Dict:
    """Crop (or pad with ``fill``) to a fixed canvas at a random position
    (LSJ's FixedSizeCrop)."""
    th, tw = size
    h, w = sample["image"].shape[:2]
    y0 = rng.randint(0, max(h - th, 0))
    x0 = rng.randint(0, max(w - tw, 0))
    crop = sample["image"][y0 : y0 + th, x0 : x0 + tw]
    canvas = np.full((th, tw, *crop.shape[2:]), fill, crop.dtype)
    canvas[: crop.shape[0], : crop.shape[1]] = crop
    boxes = sample["boxes"] - np.asarray([x0, y0, x0, y0], np.float32)
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, tw)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, th)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    return {
        **sample,
        "image": canvas,
        "boxes": boxes[keep],
        "labels": sample["labels"][keep],
    }


class LSJPreset:
    """Large-scale jitter (presets.py:30-48): hflip, ScaleJitter(0.1, 2),
    FixedSizeCrop, normalisation."""

    def __init__(self, size: int = 1024, scale_range=(0.1, 2.0), seed: int = 0,
                 normalize_host: bool = True):
        self.size = (size, size)
        self.scale_range = scale_range
        self.rng = random.Random(seed)
        self.normalize_host = normalize_host

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        rng = self.rng if rng is None else rng
        if rng.random() < 0.5:
            sample = hflip(sample)
        sample = scale_jitter(sample, self.size, self.scale_range, rng)
        sample = fixed_size_crop(sample, self.size, rng)
        return normalize(sample) if self.normalize_host else sample


class Compose:
    """Stages applied in order. With a generator, each stage draws from its
    own child of it (``children``), as each JAX stage has its own."""

    def __init__(self, *transforms):
        self.transforms = transforms

    def update_dataset(self, dataset) -> None:
        for t in self.transforms:
            if hasattr(t, "update_dataset"):
                t.update_dataset(dataset)

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        rngs = [None] * len(self.transforms) if rng is None else children(rng, len(self.transforms))
        for t, r in zip(self.transforms, rngs):
            sample = t(sample) if r is None else t(sample, r)
        return sample


def shift_image(sample: Dict, dx_frac: float, dy_frac: float) -> Dict:
    """A.ShiftScaleRotate with shift only: translate the image with a
    constant-0 border and the boxes with it, dropping those fully off the
    canvas (min_visibility 0; presets.py:109-117, 150)."""
    img = sample["image"]
    h, w = img.shape[:2]
    dx, dy = round(w * dx_frac), round(h * dy_frac)
    out = cv_ops.shift(img, dx, dy)
    boxes = sample["boxes"] + np.asarray([dx, dy, dx, dy], np.float32)
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    result = {**sample, "image": out, "boxes": boxes[keep],
              "labels": sample["labels"][keep]}
    if "masks" in sample and len(sample["masks"]):
        result["masks"] = np.stack([cv_ops.shift(m, dx, dy) for m in sample["masks"]])[keep]
    return result


def vflip(sample: Dict) -> Dict:
    image = sample["image"][::-1]
    boxes = sample["boxes"].copy()
    h = sample["image"].shape[0]
    boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    result = {**sample, "image": np.ascontiguousarray(image), "boxes": boxes}
    if "masks" in sample and len(sample["masks"]):
        result["masks"] = np.ascontiguousarray(sample["masks"][:, ::-1])
    return result


class ColorAugmentations:
    """The ``strong_album`` albumentations block, parameter for parameter
    (presets.py:106-151): ShiftScaleRotate(shift <= 6.25%, p=.5) ->
    RandomBrightnessContrast(brightness (0.1, 0.3), contrast (0.1, 0.3),
    p=.2) -> OneOf[RGBShift(+-10) | HueSaturationValue(20/30/20)](p=1) ->
    ImageCompression(85-95, p=.2) -> ChannelShuffle(p=.1) -> OneOf[Blur(3) |
    MedianBlur(3)](p=.1), on uint8 RGB before normalisation. The JPEG step
    is ``cv_ops.jpeg_roundtrip`` in the input's channel order (the
    reference's; the JAX step's output reversed)."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        r = self.rng if rng is None else rng
        if r.random() < 0.5:  # ShiftScaleRotate, shift_limit=0.0625
            sample = shift_image(
                sample, r.uniform(-0.0625, 0.0625), r.uniform(-0.0625, 0.0625)
            )
        img = sample["image"]
        if img.dtype != np.uint8:
            raise ValueError("apply the colour augmentations before normalize()")
        if r.random() < 0.2:  # RandomBrightnessContrast((0.1,0.3), (0.1,0.3))
            alpha = 1.0 + r.uniform(0.1, 0.3)
            beta = r.uniform(0.1, 0.3) * 255.0  # brightness_by_max=True
            img = np.clip(img.astype(np.float32) * alpha + beta, 0, 255
                          ).astype(np.uint8)
        if r.random() < 0.5:  # OneOf(p=1): RGBShift
            shifts = np.asarray([r.randint(-10, 10) for _ in range(3)])
            img = np.clip(img.astype(np.int32) + shifts, 0, 255).astype(np.uint8)
        else:  # OneOf(p=1): HueSaturationValue
            hsv = cv_ops.rgb2hsv(img).astype(np.int32)
            hsv[..., 0] = (hsv[..., 0] + r.randint(-20, 20)) % 180
            hsv[..., 1] = np.clip(hsv[..., 1] + r.randint(-30, 30), 0, 255)
            hsv[..., 2] = np.clip(hsv[..., 2] + r.randint(-20, 20), 0, 255)
            img = cv_ops.hsv2rgb(hsv.astype(np.uint8))
        if r.random() < 0.2:  # ImageCompression(quality 85-95)
            img = cv_ops.jpeg_roundtrip(img, r.randint(85, 95))
        if r.random() < 0.1:  # ChannelShuffle
            perm = [0, 1, 2]
            r.shuffle(perm)
            img = img[..., perm]
        if r.random() < 0.1:  # OneOf: Blur(3) | MedianBlur(3)
            img = cv_ops.blur3(img) if r.random() < 0.5 else cv_ops.median3(img)
        return {**sample, "image": img}


class StrongAlbumPreset:
    """``strong_album``, op for op (presets.py:96-159): hflip ->
    RandomChoice(resize | resize + crop + resize) -> the albumentations
    block -> hflip -> vertical flip -> normalisation (``normalize_host``;
    the JAX preset stops before it). The 1200x2000 variant
    (presets.py:165-230) is the same pipeline at larger scales. With a
    generator of the caller, the geometry draws from its first child and
    the albumentations block from its second."""

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
        self.color = ColorAugmentations(seed=seed + 1)
        self.normalize_host = normalize_host

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        rng, color_rng = (self.rng, None) if rng is None else children(rng, 2)
        if rng.random() < 0.5:
            sample = hflip(sample)
        if rng.random() < 0.5:
            sample = resize_shortest(
                sample, rng.choice(self.scales), self.max_size, antialias=True
            )
        else:
            sample = resize_shortest(
                sample, rng.choice(self.crop_scales), None, antialias=True
            )
            sample = random_size_crop(sample, *self.crop_range, rng)
            sample = resize_shortest(
                sample, rng.choice(self.scales), self.max_size, antialias=True
            )
        sample = self.color(sample, color_rng)
        if rng.random() < 0.5:
            sample = hflip(sample)
        if rng.random() < 0.5:
            sample = vflip(sample)
        return normalize(sample) if self.normalize_host else sample


def photometric_distort(sample: Dict, rng: random.Random, p: float = 0.5) -> Dict:
    """SSD's RandomPhotometricDistort (torchvision v2, presets.py:76-94,
    231-241): brightness, contrast, saturation and hue jitters each gated by
    ``p``, the contrast before or after the colour ops at random. The
    expressions are the JAX ones, including ``f.astype(np.uint8)`` of
    brightened floats above 255 before the grey mean."""
    img = sample["image"]
    if img.dtype != np.uint8:
        raise ValueError("apply the photometric distortion before normalize()")
    f = img.astype(np.float32)

    def brightness(f):
        return f * rng.uniform(0.875, 1.125)

    def contrast(f):
        mean = cv_ops.rgb2gray(f.astype(np.uint8)).mean()
        return (f - mean) * rng.uniform(0.5, 1.5) + mean

    def saturation_hue(f):
        hsv = cv_ops.rgb2hsv(np.clip(f, 0, 255).astype(np.uint8))
        hsv = hsv.astype(np.float32)
        if rng.random() < p:
            hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(0.5, 1.5), 0, 255)
        if rng.random() < p:
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-0.05, 0.05) * 180) % 180
        return cv_ops.hsv2rgb(hsv.astype(np.uint8)).astype(np.float32)

    if rng.random() < p:
        f = brightness(f)
    contrast_first = rng.random() < 0.5
    if contrast_first and rng.random() < p:
        f = contrast(f)
    f = saturation_hue(f)
    if not contrast_first and rng.random() < p:
        f = contrast(f)
    return {**sample, "image": np.clip(f, 0, 255).astype(np.uint8)}


def random_zoom_out(sample: Dict, rng: random.Random, fill=(123, 117, 104),
                    side_range=(1.0, 4.0), p: float = 0.5) -> Dict:
    """torchvision's RandomZoomOut: the image pasted at a random place of a
    canvas up to ``side_range`` times larger, filled with ``fill``."""
    if rng.random() >= p:
        return sample
    h, w = sample["image"].shape[:2]
    r = rng.uniform(*side_range)
    ch, cw = int(h * r), int(w * r)
    y0 = rng.randint(0, ch - h)
    x0 = rng.randint(0, cw - w)
    canvas = np.empty((ch, cw, 3), np.uint8)
    canvas[...] = np.asarray(fill, np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = sample["image"]
    boxes = sample["boxes"] + np.asarray([x0, y0, x0, y0], np.float32)
    return {**sample, "image": canvas, "boxes": boxes}


def random_iou_crop(sample: Dict, rng: random.Random, trials: int = 40) -> Dict:
    """torchvision's RandomIoUCrop (SSD's crop): a minimum IoU drawn from
    {skip, 0, .1, .3, .5, .7, .9}, then random crops (scale 0.3-1, aspect
    0.5-2) until every kept box's centre is inside and its IoU reaches it."""
    h, w = sample["image"].shape[:2]
    boxes = sample["boxes"]
    if len(boxes) == 0:
        return sample
    options = (None, 0.0, 0.1, 0.3, 0.5, 0.7, 0.9)
    min_iou = rng.choice(options)
    if min_iou is None:
        return sample
    for _ in range(trials):
        cw = int(w * rng.uniform(0.3, 1.0))
        ch = int(h * rng.uniform(0.3, 1.0))
        if not 0.5 <= cw / max(ch, 1) <= 2.0:
            continue
        x0 = rng.randint(0, w - cw)
        y0 = rng.randint(0, h - ch)
        crop = np.asarray([x0, y0, x0 + cw, y0 + ch], np.float32)
        cx = (boxes[:, 0] + boxes[:, 2]) / 2
        cy = (boxes[:, 1] + boxes[:, 3]) / 2
        inside = (cx >= crop[0]) & (cx < crop[2]) & (cy >= crop[1]) & (cy < crop[3])
        if not inside.any():
            continue
        ix0 = np.maximum(boxes[:, 0], crop[0])
        iy0 = np.maximum(boxes[:, 1], crop[1])
        ix1 = np.minimum(boxes[:, 2], crop[2])
        iy1 = np.minimum(boxes[:, 3], crop[3])
        inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        iou = inter / np.maximum(area + cw * ch - inter, 1e-9)
        if iou[inside].min() < min_iou:
            continue
        image = sample["image"][y0:y0 + ch, x0:x0 + cw]
        nb = boxes[inside] - np.asarray([x0, y0, x0, y0], np.float32)
        nb[:, [0, 2]] = nb[:, [0, 2]].clip(0, cw)
        nb[:, [1, 3]] = nb[:, [1, 3]].clip(0, ch)
        return {
            **sample,
            "image": np.ascontiguousarray(image),
            "boxes": nb,
            "labels": sample["labels"][inside],
        }
    return sample


def resize_fixed(sample: Dict, size) -> Dict:
    th, tw = size
    h, w = sample["image"].shape[:2]
    image = resize_linear(sample["image"], th, tw)
    boxes = sample["boxes"] * np.asarray(
        [tw / w, th / h, tw / w, th / h], np.float32
    )
    return {**sample, "image": image, "boxes": boxes}


def _sanitize(sample: Dict) -> Dict:
    boxes = sample["boxes"]
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    return {**sample, "boxes": boxes[keep], "labels": sample["labels"][keep]}


class MultiscalePreset:
    """``multiscale`` (presets.py:50-58): multi-scale shortest-side resize,
    hflip, normalisation; no crop branch."""

    def __init__(self, scales: Sequence[int] = DETR_SCALES, max_size: int = 1333,
                 seed: int = 0, normalize_host: bool = True):
        self.scales = list(scales)
        self.max_size = max_size
        self.rng = random.Random(seed)
        self.normalize_host = normalize_host

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        rng = self.rng if rng is None else rng
        sample = resize_shortest(sample, rng.choice(self.scales), self.max_size)
        if rng.random() < 0.5:
            sample = hflip(sample)
        return normalize(sample) if self.normalize_host else sample


class SSDPreset:
    """``ssd`` (presets.py:76-86): photometric distortion, zoom-out, IoU
    crop, hflip, normalisation, box sanitisation."""

    def __init__(self, seed: int = 0, with_distort: bool = True,
                 with_zoom_out: bool = True, normalize_host: bool = True):
        self.rng = random.Random(seed)
        self.with_distort = with_distort
        self.with_zoom_out = with_zoom_out
        self.normalize_host = normalize_host

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        rng = self.rng if rng is None else rng
        if self.with_distort:
            sample = photometric_distort(sample, rng)
        if self.with_zoom_out:
            sample = random_zoom_out(sample, rng)
        sample = random_iou_crop(sample, rng)
        if rng.random() < 0.5:
            sample = hflip(sample)
        sample = _sanitize(sample)
        return normalize(sample) if self.normalize_host else sample


class RTDetrPreset:
    """``rtdetr_transform`` (presets.py:231-241): distortion with p=0.8,
    zoom-out (fill 0), IoU crop, hflip, a fixed 640x640 resize,
    normalisation."""

    def __init__(self, size: int = 640, seed: int = 0, normalize_host: bool = True):
        self.size = (size, size)
        self.rng = random.Random(seed)
        self.normalize_host = normalize_host

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        rng = self.rng if rng is None else rng
        sample = photometric_distort(sample, rng, p=0.8)
        sample = random_zoom_out(sample, rng, fill=(0, 0, 0))
        sample = random_iou_crop(sample, rng)
        if rng.random() < 0.5:
            sample = hflip(sample)
        sample = _sanitize(resize_fixed(sample, self.size))
        return normalize(sample) if self.normalize_host else sample


# the registry, as the JAX package's (its configs' `transforms.<name>()`)
def lsj(seed: int = 0, normalize_host: bool = True) -> LSJPreset:
    return LSJPreset(1024, seed=seed, normalize_host=normalize_host)


def lsj_1536(seed: int = 0, normalize_host: bool = True) -> LSJPreset:
    return LSJPreset(1536, seed=seed, normalize_host=normalize_host)


def strong_album(seed: int = 0, normalize_host: bool = True) -> StrongAlbumPreset:
    return StrongAlbumPreset(seed=seed, normalize_host=normalize_host)


def strong_album_1200_2000(seed: int = 0, normalize_host: bool = True) -> StrongAlbumPreset:
    """The 1200x2000 variant (presets.py:165-229, the FocalNet-L config's)."""
    return StrongAlbumPreset(seed=seed, scales=tuple(range(720, 1201, 48)), max_size=2000,
                             crop_scales=(600, 750, 900), crop_range=(576, 900),
                             normalize_host=normalize_host)


def multiscale(seed: int = 0, normalize_host: bool = True) -> MultiscalePreset:
    return MultiscalePreset(seed=seed, normalize_host=normalize_host)


def ssd(seed: int = 0, normalize_host: bool = True) -> SSDPreset:
    return SSDPreset(seed=seed, normalize_host=normalize_host)


def ssdlite(seed: int = 0, normalize_host: bool = True) -> SSDPreset:
    """``ssdlite`` (presets.py:88-94): ``ssd`` without distortion or zoom-out."""
    return SSDPreset(seed=seed, with_distort=False, with_zoom_out=False,
                     normalize_host=normalize_host)


def rtdetr_transform(seed: int = 0, normalize_host: bool = True) -> RTDetrPreset:
    return RTDetrPreset(seed=seed, normalize_host=normalize_host)


def mosaic_detr(dataset=None, seed: int = 0, normalize_host: bool = True) -> Compose:
    """Mosaic followed by the detr preset (presets.py:245-316)."""
    from relation_detr_tpu_torch.data.mix_transforms import Mosaic

    return Compose(Mosaic(dataset, seed=seed), DetrPreset(seed=seed, normalize_host=normalize_host))


PRESETS = {"detr": detr, "lsj": lsj, "lsj_1536": lsj_1536, "strong_album": strong_album,
           "strong_album_1200_2000": strong_album_1200_2000, "multiscale": multiscale,
           "ssd": ssd, "ssdlite": ssdlite, "rtdetr_transform": rtdetr_transform,
           "mosaic_detr": mosaic_detr}
