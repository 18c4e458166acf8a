"""COCO and Objects365 detection datasets, numpy only.

The port's counterpart of ``relation_detr_tpu/data/coco.py``: a
self-contained index of the annotation JSON; ``_prepare`` (xywh -> xyxy
clamped to the decoded image, crowd and degenerate boxes dropped);
``class_agnostic`` (every category becomes 1); the train filter (images
without a valid box dropped); ``return_masks`` (``_rasterize_segmentation``:
polygons through ``cv_ops.fill_poly``, cv2's ``fillPoly``, uncompressed RLE,
the box where there is no segmentation); the multi-image transforms'
``update_dataset`` hook; ``get_raw``, ``__getitem__`` and
``Object365Detection``, which skips unreadable images. Images decode
through ``data/image_io.py``: JPEG with nvJPEG on ``device`` (EXIF
orientation applied, as cv2 applies it) or the caller's ``decode`` (the CPU
has no JPEG decoder), PNG on the host. ``read(index, rng, transform)`` is
``__getitem__`` with the transform's random draws taken from ``rng``
(``data/loader.py`` passes each sample its own generator); with
``transform=False`` it is ``get_raw``, which the mix transforms call from
the loader's threads, so it changes no state of the dataset.
"""
from __future__ import annotations

import json
import os
import threading
import random
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from relation_detr_tpu_torch.data.cv_ops import fill_poly
from relation_detr_tpu_torch.data.image_io import Decode, UnreadableImage, read_image


def _rasterize_segmentation(seg, box, height: int, width: int) -> np.ndarray:
    """Polygons / uncompressed RLE -> (H, W) uint8 mask; the box rectangle
    when there is no segmentation (``relation_detr_tpu/data/coco.py:23-49``).
    Compressed RLE takes the box too, as there."""
    mask = np.zeros((height, width), np.uint8)
    if isinstance(seg, list) and seg:
        polys = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
                 for p in seg if len(p) >= 6]
        if polys:
            fill_poly(mask, polys, 1)
            return mask
    if isinstance(seg, dict) and isinstance(seg.get("counts"), list):
        # uncompressed RLE: column-major runs of 0s and 1s alternating
        h, w = seg.get("size", (height, width))
        flat = np.zeros(h * w, np.uint8)
        pos, val = 0, 0
        for run in seg["counts"]:
            if val:
                flat[pos:pos + run] = 1
            pos += run
            val ^= 1
        m = flat.reshape(w, h).T  # COCO RLE is column-major
        mask[:h, :w] = m[:height, :width]
        return mask
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    mask[y0:y1, x0:x1] = 1
    return mask


class CocoDetection:
    def __init__(
        self,
        img_folder: str,
        ann_file: str,
        transforms=None,
        train: bool = False,
        class_agnostic: bool = False,
        return_masks: bool = False,
        device="cuda",
        decode: Optional[Decode] = None,
    ):
        """``class_agnostic`` collapses every category to id 1 (the SA-Det-100k
        evaluation protocol). ``return_masks`` adds each kept box's (H, W)
        uint8 mask as ``masks`` (N, H, W), for the mask-based
        SimpleCopyPaste. JPEG images decode with nvJPEG on ``device`` unless
        ``decode`` (a function of the file's bytes returning RGB (H, W, 3)
        uint8) is given. ``seconds`` sums the time spent decoding and
        transforming, over every thread that reads the dataset."""
        self.return_masks = return_masks
        self.img_folder = img_folder
        self.transforms = transforms
        self.train = train
        self.class_agnostic = class_agnostic
        self.device = device
        self.decode = decode
        self.seconds = {"decode": 0.0, "transform": 0.0}
        self._lock = threading.Lock()
        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {img["id"]: img for img in coco["images"]}
        self.anns_by_image: Dict[int, List[dict]] = defaultdict(list)
        for ann in coco.get("annotations", []):
            self.anns_by_image[ann["image_id"]].append(ann)
        self.categories = sorted(c["id"] for c in coco.get("categories", []))
        self.ids = sorted(self.images.keys())
        if train:
            self.ids = [i for i in self.ids if self._has_valid_anns(i)]

    def _prepare(self, img_id: int, height: int, width: int, with_masks: Optional[bool] = None):
        """xywh -> clamped xyxy, drop crowd + degenerate boxes. Returns
        (boxes, labels, masks); masks is None unless ``with_masks``
        (``return_masks`` when None)."""
        with_masks = self.return_masks if with_masks is None else with_masks
        boxes, labels, masks = [], [], []
        for ann in self.anns_by_image.get(img_id, []):
            if ann.get("iscrowd", 0):
                continue
            x, y, w, h = ann["bbox"]
            x0 = min(max(x, 0), width)
            y0 = min(max(y, 0), height)
            x1 = min(max(x + w, 0), width)
            y1 = min(max(y + h, 0), height)
            if x1 <= x0 or y1 <= y0:
                continue
            boxes.append([x0, y0, x1, y1])
            labels.append(1 if self.class_agnostic else ann["category_id"])
            if with_masks:
                masks.append(_rasterize_segmentation(
                    ann.get("segmentation"), (x0, y0, x1, y1), height, width
                ))
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        labels = np.asarray(labels, np.int64)
        if with_masks:
            masks = (np.stack(masks) if masks
                     else np.zeros((0, height, width), np.uint8))
            return boxes, labels, masks
        return boxes, labels, None

    def _has_valid_anns(self, img_id: int) -> bool:
        info = self.images[img_id]
        boxes = self._prepare(img_id, info["height"], info["width"], with_masks=False)[0]
        return len(boxes) > 0

    def __len__(self):
        return len(self.ids)

    def get_raw(self, index: int):
        """Untransformed sample; safe to call from any thread while others
        read transformed ones."""
        return self.read(index, transform=False)

    def _add_seconds(self, key: str, seconds: float) -> None:
        with self._lock:
            self.seconds[key] += seconds

    def __getitem__(self, index: int):
        return self.read(index)

    def read(self, index: int, rng: Optional[random.Random] = None, transform: bool = True):
        """Sample ``index``, transformed unless ``transform`` is False; a
        transform that draws at random draws from ``rng`` (its own generator
        when None). Before it runs, a transform with ``update_dataset``
        (the mix transforms, a ``Compose`` of them) is handed this dataset."""
        img_id = self.ids[index]
        info = self.images[img_id]
        path = os.path.join(self.img_folder, info["file_name"])
        t0 = time.perf_counter()
        image = read_image(path, self.device, self.decode)  # RGB HWC
        self._add_seconds("decode", time.perf_counter() - t0)
        boxes, labels, masks = self._prepare(img_id, image.shape[0], image.shape[1])
        sample = {
            "image": image,
            "boxes": boxes,
            "labels": labels,
            "image_id": img_id,
            "orig_size": np.asarray(image.shape[:2], np.int64),  # (h, w)
        }
        if masks is not None:
            sample["masks"] = masks
        transforms = self.transforms
        if transform and transforms is not None:
            if hasattr(transforms, "update_dataset"):
                transforms.update_dataset(self)
            t0 = time.perf_counter()
            sample = transforms(sample) if rng is None else transforms(sample, rng)
            self._add_seconds("transform", time.perf_counter() - t0)
        return sample


class Object365Detection(CocoDetection):
    """Objects365, with the reference's skip of images that do not read
    (``relation_detr_tpu/data/coco.py:159-169``): an unreadable file
    (``image_io.UnreadableImage``) or one the system cannot open
    (``OSError``) passes the read on to the next index, wrapping around.
    Every other error, a CUDA one among them, propagates."""

    def read(self, index: int, rng: Optional[random.Random] = None, transform: bool = True):
        for offset in range(len(self)):
            try:
                return super().read((index + offset) % len(self), rng, transform)
            except (UnreadableImage, OSError):
                continue
        raise RuntimeError("no readable images in dataset")
