"""Macroscopic-correlation statistic over a detection dataset. The port's
counterpart of the root ``tools/mc_distribution.py``:

    python -m relation_detr_tpu_torch.tools.mc_distribution --coco-path data/coco \\
        [--split val2017] [--output mc_distribution.png] [--max-images 5000]

For each image with at least two ground-truth boxes, the mean absolute
pairwise position relation between its boxes (``box_pair_relation``, the
relation embedding's input, off the diagonal); then the dataset's mean,
median, 10th and 90th percentiles, printed as the JAX tool prints them, and
a 60-bin histogram drawn with ``data/cv_ops.py`` and written as a PNG
(``data/image_io.py::encode_png``; the JAX tool plots with matplotlib).
Reads the annotations only: no image is decoded and no card is needed.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from relation_detr_tpu_torch.data import cv_ops
from relation_detr_tpu_torch.data.coco import CocoDetection
from relation_detr_tpu_torch.data.image_io import write_image

BAR_BGR = (0xAA, 0x77, 0x44)  # matplotlib's "#4477aa"


def parse_args(argv=None):
    p = argparse.ArgumentParser("relation_detr_tpu_torch mc_distribution")
    p.add_argument("--coco-path", default="data/coco")
    p.add_argument("--split", default="val2017")
    p.add_argument("--output", default="mc_distribution.png")
    p.add_argument("--max-images", type=int, default=5000)
    return p.parse_args(argv)


def box_pair_relation(boxes_cxcywh: np.ndarray) -> np.ndarray:
    """The pairwise (N, N, 4) box relation of ``models/relation.py::
    box_rel_encoding`` in numpy."""
    xy, wh = boxes_cxcywh[:, :2], boxes_cxcywh[:, 2:]
    delta_xy = np.abs(xy[:, None] - xy[None, :])
    delta_xy = np.log(delta_xy / (wh[:, None] + 1e-5) + 1.0)
    delta_wh = np.log((wh[:, None] + 1e-5) / (wh[None, :] + 1e-5))
    return np.concatenate([delta_xy, delta_wh], -1)


def mc_values(dataset: CocoDetection, max_images: int) -> np.ndarray:
    """Each image's mean |relation| over its box pairs, for the first
    ``max_images`` images with two boxes or more."""
    values = []
    for img_id in dataset.ids[:max_images]:
        info = dataset.images[img_id]
        boxes = dataset._prepare(img_id, info["height"], info["width"], with_masks=False)[0]
        if len(boxes) < 2:
            continue
        cxcywh = np.stack(
            [
                (boxes[:, 0] + boxes[:, 2]) / 2 / info["width"],
                (boxes[:, 1] + boxes[:, 3]) / 2 / info["height"],
                (boxes[:, 2] - boxes[:, 0]) / info["width"],
                (boxes[:, 3] - boxes[:, 1]) / info["height"],
            ],
            -1,
        )
        rel = box_pair_relation(cxcywh)
        off_diag = ~np.eye(len(boxes), dtype=bool)
        values.append(float(np.abs(rel[off_diag]).mean()))
    return np.asarray(values)


def summary(values: np.ndarray) -> str:
    return (f"{len(values)} images with >=2 boxes; "
            f"MC mean {values.mean():.4f}  median {np.median(values):.4f}  "
            f"p10 {np.percentile(values, 10):.4f}  p90 {np.percentile(values, 90):.4f}")


def histogram_image(values: np.ndarray, bins: int = 60, size=(480, 720)) -> np.ndarray:
    """A BGR uint8 plot of the values' histogram: bars, axes, ticks at the
    ends of each axis, labels and a title."""
    h, w = size
    left, right, top, bottom = 60, 20, 40, 50
    img = np.full((h, w, 3), 255, np.uint8)
    counts, edges = np.histogram(values, bins=bins)
    x0, x1, y0, y1 = left, w - right, top, h - bottom
    peak = max(int(counts.max()), 1) if len(counts) else 1
    for i, count in enumerate(counts):
        if count:
            bx0 = x0 + (x1 - x0) * i // bins
            bx1 = x0 + (x1 - x0) * (i + 1) // bins - 1
            cv_ops.rectangle(img, (bx0, y1 - (y1 - y0) * int(count) // peak), (bx1, y1), BAR_BGR, -1)
    black = (0, 0, 0)
    cv_ops.rectangle(img, (x0, y1), (x1, y1), black, -1)  # x axis
    cv_ops.rectangle(img, (x0, y0), (x0, y1), black, -1)  # y axis
    for x, value in ((x0, edges[0]), (x1, edges[-1])):
        cv_ops.rectangle(img, (x, y1), (x, y1 + 5), black, -1)
        text = f"{value:.2f}"
        cv_ops.put_text(img, text, (x - cv_ops.get_text_size(text)[0][0] // 2, y1 + 20),
                        color=black)
    for y, count in ((y1, 0), (y0, peak)):
        cv_ops.rectangle(img, (x0 - 5, y), (x0, y), black, -1)
        text = str(count)
        cv_ops.put_text(img, text, (x0 - 8 - cv_ops.get_text_size(text)[0][0], y + 5),
                        color=black)
    for text, org in (("mean |pairwise box relation|", ((x0 + x1) // 2, h - 12)),
                      ("Macroscopic correlation distribution", (w // 2, 25))):
        cv_ops.put_text(img, text, (org[0] - cv_ops.get_text_size(text)[0][0] // 2, org[1]),
                        color=black)
    cv_ops.put_text(img, "images", (8, y0 - 8), color=black)
    return img


def main(argv=None) -> np.ndarray:
    """Prints the summary, writes the histogram; returns the values."""
    args = parse_args(argv)
    dataset = CocoDetection(
        img_folder=os.path.join(args.coco_path, args.split),
        ann_file=os.path.join(args.coco_path, "annotations", f"instances_{args.split}.json"),
    )
    values = mc_values(dataset, args.max_images)
    print(summary(values))
    write_image(args.output, histogram_image(values))
    print(f"wrote {args.output}")
    return values


if __name__ == "__main__":
    main()
