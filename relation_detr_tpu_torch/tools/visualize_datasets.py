"""Dump augmented dataset samples with their boxes drawn. The port's
counterpart of the root ``tools/visualize_datasets.py``:

    python -m relation_detr_tpu_torch.tools.visualize_datasets --coco-path data/coco \\
        --show-dir out/ [--num-images 20] [--preset detr|none] [--seed 0] [--device cuda]

Samples ``0 .. num_images - 1`` of the split, read as the train CLI reads
them (JPEGs decoded with nvJPEG on the card; a caller of ``main`` on the CPU
passes ``decode=``), through the ``detr`` train preset (one generator
seeded with ``--seed``, as the JAX tool's) or none, de-normalised to uint8,
drawn with ``utils/visualize.py`` (score 1, the label ids) and written as
``<image_id:012d>.jpg`` (``data/image_io.py::write_image``, cv2's bytes).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from relation_detr_tpu_torch.data import transforms
from relation_detr_tpu_torch.data.coco import CocoDetection
from relation_detr_tpu_torch.data.image_io import Decode, write_image
from relation_detr_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from relation_detr_tpu_torch.utils.visualize import plot_bounding_boxes_on_image


def parse_args(argv=None):
    p = argparse.ArgumentParser("relation_detr_tpu_torch visualize_datasets")
    p.add_argument("--coco-path", default="data/coco")
    p.add_argument("--split", default="train2017")
    p.add_argument("--show-dir", required=True)
    p.add_argument("--num-images", type=int, default=20)
    p.add_argument("--preset", default="detr", choices=["detr", "none"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None, decode: Optional[Decode] = None) -> List[str]:
    """Writes the samples; returns their paths."""
    args = parse_args(argv)
    tf = transforms.detr(seed=args.seed) if args.preset == "detr" else None
    dataset = CocoDetection(
        img_folder=os.path.join(args.coco_path, args.split),
        ann_file=os.path.join(args.coco_path, "annotations", f"instances_{args.split}.json"),
        transforms=tf,
        train=True,
        device=args.device,
        decode=decode,
    )
    os.makedirs(args.show_dir, exist_ok=True)
    written = []
    for i in range(min(args.num_images, len(dataset))):
        s = dataset[i]
        img = s["image"]
        if img.dtype != np.uint8:  # de-normalise for display
            img = ((img * IMAGENET_STD + IMAGENET_MEAN) * 255).clip(0, 255).astype(np.uint8)
        vis = plot_bounding_boxes_on_image(np.ascontiguousarray(img[..., ::-1]), s["boxes"],
                                           np.ones(len(s["boxes"])), s["labels"])
        written.append(os.path.join(args.show_dir, f"{s['image_id']:012d}.jpg"))
        write_image(written[-1], vis)
    print(f"wrote {len(written)} samples to {args.show_dir}")
    return written


if __name__ == "__main__":
    main()
