"""COCO detection dataset, the annotation half, numpy only.

The port's counterpart of ``relation_detr_tpu/data/coco.py::CocoDetection``
(``:51-156``): a self-contained index of the annotation JSON; ``_prepare``
(xywh -> xyxy clamped to the decoded image, crowd and degenerate boxes
dropped); ``class_agnostic`` (every category becomes 1); the train filter
(images without a valid box dropped); ``get_raw`` and ``__getitem__``.
Images decode through ``data/image_io.py``: nvJPEG on ``device`` (EXIF
orientation applied, as cv2 applies it), or the caller's ``decode`` (the CPU
has no decoder).

Not ported: ``return_masks`` (``_rasterize_segmentation``, which needs
``cv2.fillPoly``; train only) raises, and ``Object365Detection`` waits for
the training slice.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from relation_detr_tpu_torch.data.image_io import Decode, read_image


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
        evaluation protocol). Images decode with nvJPEG on ``device`` unless
        ``decode`` (a function of the file's bytes returning RGB (H, W, 3)
        uint8) is given. ``seconds`` sums the time spent decoding and
        transforming, over every thread that reads the dataset."""
        if return_masks:
            raise NotImplementedError("CocoDetection(return_masks=True) is not ported "
                                      "(segmentation masks are train only)")
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

    def _prepare(self, img_id: int, height: int, width: int):
        """xywh -> clamped xyxy, drop crowd + degenerate boxes. Returns
        (boxes, labels, None): the third slot is the masks, not ported."""
        boxes, labels = [], []
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
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        labels = np.asarray(labels, np.int64)
        return boxes, labels, None

    def _has_valid_anns(self, img_id: int) -> bool:
        info = self.images[img_id]
        boxes = self._prepare(img_id, info["height"], info["width"])[0]
        return len(boxes) > 0

    def __len__(self):
        return len(self.ids)

    def get_raw(self, index: int):
        """Untransformed sample."""
        transforms, self.transforms = self.transforms, None
        try:
            return self[index]
        finally:
            self.transforms = transforms

    def _add_seconds(self, key: str, seconds: float) -> None:
        with self._lock:
            self.seconds[key] += seconds

    def __getitem__(self, index: int):
        img_id = self.ids[index]
        info = self.images[img_id]
        path = os.path.join(self.img_folder, info["file_name"])
        t0 = time.perf_counter()
        image = read_image(path, self.device, self.decode)  # RGB HWC
        self._add_seconds("decode", time.perf_counter() - t0)
        boxes, labels, _ = self._prepare(img_id, image.shape[0], image.shape[1])
        sample = {
            "image": image,
            "boxes": boxes,
            "labels": labels,
            "image_id": img_id,
            "orig_size": np.asarray(image.shape[:2], np.int64),  # (h, w)
        }
        if self.transforms is not None:
            t0 = time.perf_counter()
            sample = self.transforms(sample)
            self._add_seconds("transform", time.perf_counter() - t0)
        return sample
