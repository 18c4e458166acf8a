"""Generate a val2017-scale synthetic COCO split (default 5000 images) for
eval wall-time measurement. The port's counterpart of the root
``tools/make_synth_coco_scale.py``, with the same files byte for byte:

    python -m relation_detr_tpu_torch.tools.make_synth_coco_scale /tmp/synth5k \\
        [--n-val 5000] [--height 480 --width 640]

Every image has one size, so the whole run takes one canvas. The images are
``RandomState(0)`` noise with one to five filled boxes of three categories
(``data/cv_ops.py::rectangle``), written as quality-70 JPEGs
(``data/image_io.py::encode_jpeg``, cv2's bytes); the annotations go to
``annotations/instances_val2017.json``. Host code only: no card is needed.
"""
import argparse
import json
import os

import numpy as np

from relation_detr_tpu_torch.data.cv_ops import rectangle
from relation_detr_tpu_torch.data.image_io import encode_jpeg


def parse_args(argv=None):
    p = argparse.ArgumentParser("relation_detr_tpu_torch make_synth_coco_scale")
    p.add_argument("root")
    p.add_argument("--n-val", type=int, default=5000)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    rng = np.random.RandomState(0)
    split = "val2017"
    os.makedirs(f"{args.root}/{split}", exist_ok=True)
    images, annotations = [], []
    aid = 1
    h, w = args.height, args.width
    for i in range(args.n_val):
        img = rng.randint(0, 80, (h, w, 3), np.uint8)
        img_id = i + 1
        for _ in range(int(rng.randint(1, 6))):
            bw, bh = int(rng.randint(40, w // 2)), int(rng.randint(40, h // 2))
            x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            cat = int(rng.randint(1, 4))
            color = [(255, 60, 60), (60, 255, 60), (60, 60, 255)][cat - 1]
            rectangle(img, (x, y), (x + bw, y + bh), color, -1)
            annotations.append({"id": aid, "image_id": img_id,
                                "category_id": cat, "bbox": [x, y, bw, bh],
                                "area": bw * bh, "iscrowd": 0})
            aid += 1
        fname = f"{img_id:012d}.jpg"
        with open(f"{args.root}/{split}/{fname}", "wb") as f:
            f.write(encode_jpeg(img, 70))
        images.append({"id": img_id, "height": h, "width": w,
                       "file_name": fname})
    os.makedirs(f"{args.root}/annotations", exist_ok=True)
    with open(f"{args.root}/annotations/instances_{split}.json", "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": f"c{c}"}
                                  for c in (1, 2, 3)]}, f)
    print(f"synthetic {args.n_val}-image val set at {args.root}")


if __name__ == "__main__":
    main()
