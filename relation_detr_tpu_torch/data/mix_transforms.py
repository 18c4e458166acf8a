"""Multi-image augmentations: Mosaic, MixUp, their cached forms and
SimpleCopyPaste, numpy only.

The port's copy of ``relation_detr_tpu/data/mix_transforms.py:18-259``
(the reference's Mosaic 2x2 canvas, MixUp 0.5 blend and mask-based
copy-paste). They pull extra samples from the dataset they are given
through ``update_dataset`` (``data/coco.py::CocoDetection`` hands itself to
its transforms): untransformed ones, through the dataset's thread-safe
``get_raw``. Each call draws from the generator its caller passes (the
loader's per-sample one), else from its own, seeded as the JAX transform's;
given the same generator state the draws and outputs are the JAX
transform's. cv2's resizes are ``transforms.resize_linear`` (INTER_LINEAR)
and ``cv_ops.resize_nearest`` (INTER_NEAREST), its Gaussian blur
``cv_ops.gaussian_blur5``.

The cached forms keep raw samples in a ``_RawCache`` shared by the loader's
threads under a lock; a hit returns the bytes a fresh read returns, so the
outputs depend neither on the cache's state nor on how the threads
interleave. Where samples carry ``masks``, Mosaic moves them with the
image (the JAX form leaves them as they were), so that ``mosaic_detr`` can
feed the copy-paste, which reads them as the JAX one does.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, Optional

import numpy as np

from relation_detr_tpu_torch.data import cv_ops
from relation_detr_tpu_torch.data.transforms import resize_linear


def _raw(dataset, idx: int) -> Dict:
    return dataset.get_raw(idx) if hasattr(dataset, "get_raw") else dataset[idx]


class BaseMixTransform:
    """A per-sample transform with access to its source dataset."""

    def __init__(self, dataset=None, p: float = 0.5, seed: int = 0):
        self.dataset = dataset
        self.p = p
        self.rng = random.Random(seed)

    def update_dataset(self, dataset) -> None:
        self.dataset = dataset

    def _random_sample(self, rng: random.Random) -> Dict:
        return _raw(self.dataset, rng.randrange(len(self.dataset)))


class MixUp(BaseMixTransform):
    """0.5-blend of two images on the larger canvas; boxes and labels
    concatenate (mix_transform.py:71-116)."""

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        rng = self.rng if rng is None else rng
        if self.dataset is None or rng.random() > self.p:
            return sample
        other = self._random_sample(rng)
        h = max(sample["image"].shape[0], other["image"].shape[0])
        w = max(sample["image"].shape[1], other["image"].shape[1])
        canvas = np.zeros((h, w, 3), np.float32)
        canvas[: sample["image"].shape[0], : sample["image"].shape[1]] = (
            sample["image"].astype(np.float32) * 0.5
        )
        canvas[: other["image"].shape[0], : other["image"].shape[1]] += (
            other["image"].astype(np.float32) * 0.5
        )
        return {
            **sample,
            "image": canvas.astype(sample["image"].dtype),
            "boxes": np.concatenate([sample["boxes"], other["boxes"]], 0),
            "labels": np.concatenate([sample["labels"], other["labels"]], 0),
        }


class Mosaic(BaseMixTransform):
    """2x2 mosaic around a jittered centre (mix_transform.py:170-270)."""

    def __init__(self, dataset=None, p: float = 1.0, target_size: int = 640, seed: int = 0):
        super().__init__(dataset, p, seed)
        self.target_size = target_size

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        rng = self.rng if rng is None else rng
        if self.dataset is None or rng.random() > self.p:
            return sample
        s = self.target_size
        canvas = np.full((2 * s, 2 * s, 3), 114, sample["image"].dtype)
        cx = int(rng.uniform(s * 0.5, s * 1.5))
        cy = int(rng.uniform(s * 0.5, s * 1.5))
        samples = [sample] + [self._random_sample(rng) for _ in range(3)]
        with_masks = all("masks" in spl for spl in samples)
        all_boxes, all_labels, all_masks = [], [], []
        corners = [
            (slice(0, cy), slice(0, cx)),  # top-left
            (slice(0, cy), slice(cx, 2 * s)),  # top-right
            (slice(cy, 2 * s), slice(0, cx)),  # bottom-left
            (slice(cy, 2 * s), slice(cx, 2 * s)),  # bottom-right
        ]
        for spl, (ys, xs) in zip(samples, corners):
            th, tw = ys.stop - ys.start, xs.stop - xs.start
            if th <= 0 or tw <= 0:
                continue
            img = spl["image"]
            r = min(th / img.shape[0], tw / img.shape[1])
            nh, nw = max(int(img.shape[0] * r), 1), max(int(img.shape[1] * r), 1)
            y0, x0 = ys.start, xs.start
            canvas[y0 : y0 + nh, x0 : x0 + nw] = resize_linear(img, nh, nw)
            if len(spl["boxes"]):
                boxes = spl["boxes"] * r + np.asarray([x0, y0, x0, y0], np.float32)
                boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
                boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
                keep = (boxes[:, 2] > boxes[:, 0] + 1) & (boxes[:, 3] > boxes[:, 1] + 1)
                all_boxes.append(boxes[keep])
                all_labels.append(spl["labels"][keep])
                if with_masks:
                    masks = np.zeros((int(keep.sum()), 2 * s, 2 * s), np.uint8)
                    masks[:, y0 : y0 + nh, x0 : x0 + nw] = cv_ops.resize_nearest(
                        spl["masks"][keep], nh, nw, axis=1)
                    all_masks.append(masks)
        boxes = (
            np.concatenate(all_boxes, 0)
            if all_boxes
            else np.zeros((0, 4), np.float32)
        )
        labels = (
            np.concatenate(all_labels, 0) if all_labels else np.zeros((0,), np.int64)
        )
        result = {**sample, "image": canvas, "boxes": boxes, "labels": labels}
        if with_masks:
            result["masks"] = (np.concatenate(all_masks, 0) if all_masks
                               else np.zeros((0, 2 * s, 2 * s), np.uint8))
        return result


class _RawCache:
    """A bounded cache of raw samples for the Cached* forms
    (mix_transform.py:119-168, 272-326): the oldest entry leaves first. The
    store is guarded by a lock; a miss reads outside it."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self.store: Dict[int, Dict] = {}
        self._lock = threading.Lock()

    def get(self, dataset, idx: int) -> Dict:
        with self._lock:
            s = self.store.get(idx)
        if s is None:
            s = _raw(dataset, idx)
            with self._lock:
                if idx not in self.store:
                    if len(self.store) >= self.capacity:
                        self.store.pop(next(iter(self.store)))
                    self.store[idx] = s
        out = {**s, "boxes": s["boxes"].copy(), "labels": s["labels"].copy()}
        if "masks" in s:
            out["masks"] = s["masks"].copy()
        return out


class CachedMosaic(Mosaic):
    def __init__(self, *args, cache_capacity: int = 256, **kwargs):
        super().__init__(*args, **kwargs)
        self.cache = _RawCache(cache_capacity)

    def _random_sample(self, rng: random.Random) -> Dict:
        return self.cache.get(self.dataset, rng.randrange(len(self.dataset)))


class CachedMixUp(MixUp):
    def __init__(self, *args, cache_capacity: int = 256, **kwargs):
        super().__init__(*args, **kwargs)
        self.cache = _RawCache(cache_capacity)

    def _random_sample(self, rng: random.Random) -> Dict:
        return self.cache.get(self.dataset, rng.randrange(len(self.dataset)))


class SimpleCopyPaste:
    """Mask-based copy-paste (arXiv:2012.07177), as the reference's
    batch-level transform (simple_copy_paste.py): objects drawn from another
    sample, their union alpha (Gaussian-blurred when ``blending``) composited
    over this image, this sample's masks occluded, its boxes recomputed
    from the surviving masks, the pasted objects appended. Pastes box
    rectangles instead when either sample has no ``masks``."""

    def __init__(self, dataset=None, p: float = 0.5, blending: bool = True,
                 max_paste: int = 10, seed: int = 0):
        self.dataset = dataset
        self.p = p
        self.blending = blending
        self.max_paste = max_paste
        self.rng = random.Random(seed)

    def update_dataset(self, dataset) -> None:
        self.dataset = dataset

    def __call__(self, sample: Dict, rng: Optional[random.Random] = None) -> Dict:
        rng = self.rng if rng is None else rng
        if self.dataset is None or rng.random() > self.p:
            return sample
        other = _raw(self.dataset, rng.randrange(len(self.dataset)))
        if "masks" in sample and "masks" in other and len(other["masks"]):
            return self._paste_masks(sample, other, rng)
        return self._paste_boxes(sample, other, rng)

    def _paste_masks(self, sample: Dict, other: Dict, rng: random.Random) -> Dict:
        h, w = sample["image"].shape[:2]
        oh, ow = other["image"].shape[:2]
        # random selection with replacement, deduplicated (reference :26-30)
        n = len(other["masks"])
        sel = sorted({rng.randrange(n) for _ in range(n)})[: self.max_paste]
        paste_img = other["image"]
        paste_masks = other["masks"][sel].astype(np.uint8)
        paste_boxes = other["boxes"][sel].copy()
        paste_labels = other["labels"][sel]
        if (oh, ow) != (h, w):  # the reference resizes the paste data to match (:40-52)
            paste_img = resize_linear(paste_img, h, w)
            paste_masks = cv_ops.resize_nearest(paste_masks, h, w, axis=1)
            paste_boxes *= np.asarray([w / ow, h / oh, w / ow, h / oh], np.float32)

        alpha = (paste_masks.sum(0) > 0).astype(np.float32)
        if self.blending:  # Gaussian-blurred alpha (reference :55-62)
            alpha = cv_ops.gaussian_blur5(alpha)
        image = (
            sample["image"].astype(np.float32) * (1.0 - alpha[..., None])
            + paste_img.astype(np.float32) * alpha[..., None]
        ).astype(sample["image"].dtype)

        hard = (alpha > 0.5) if self.blending else (alpha > 0)
        masks = sample["masks"].astype(np.uint8) * (~hard)
        keep = masks.sum((-1, -2)) > 0  # drop fully occluded objects (:68-70)
        masks = masks[keep]
        boxes = _masks_to_boxes(masks)
        return {
            **sample,
            "image": image,
            "masks": np.concatenate([masks, paste_masks], 0),
            "boxes": np.concatenate([boxes, paste_boxes], 0).astype(np.float32),
            "labels": np.concatenate([sample["labels"][keep], paste_labels], 0),
        }

    def _paste_boxes(self, sample: Dict, other: Dict, rng: random.Random) -> Dict:
        img = sample["image"].copy()
        h, w = img.shape[:2]
        new_boxes, new_labels = [], []
        for box, label in list(zip(other["boxes"], other["labels"]))[: self.max_paste]:
            x0, y0, x1, y1 = [int(v) for v in box]
            patch = other["image"][y0:y1, x0:x1]
            if patch.size == 0:
                continue
            ph, pw = patch.shape[:2]
            if ph >= h or pw >= w:
                continue
            ty = rng.randrange(0, h - ph)
            tx = rng.randrange(0, w - pw)
            img[ty : ty + ph, tx : tx + pw] = patch
            new_boxes.append([tx, ty, tx + pw, ty + ph])
            new_labels.append(label)
        if not new_boxes:
            return sample
        return {
            **sample,
            "image": img,
            "boxes": np.concatenate(
                [sample["boxes"], np.asarray(new_boxes, np.float32)], 0
            ),
            "labels": np.concatenate(
                [sample["labels"], np.asarray(new_labels, np.int64)], 0
            ),
        }


def _masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """torchvision's ``ops.masks_to_boxes`` (reference :79), xyxy with the
    right and bottom edges one past the last pixel."""
    if len(masks) == 0:
        return np.zeros((0, 4), np.float32)
    boxes = []
    for m in masks:
        ys, xs = np.nonzero(m)
        boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
    return np.asarray(boxes, np.float32)
