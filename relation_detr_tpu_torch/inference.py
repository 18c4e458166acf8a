"""Detection on preprocessed canvases, and a folder-inference CLI.

Port of the root ``inference.py``:

    python -m relation_detr_tpu_torch.inference --image-dir imgs/ \\
        [--model-config relation_detr_tpu_torch/configs/relation_detr/...py] \\
        [--checkpoint weights.npz] [--show-dir out/] [--device cuda]

Images decode through ``data/image_io.py`` (JPEG with nvJPEG on the card,
EXIF orientation applied; PNG on the host; a file of another format, a
.bmp or .webp, raises ``UnreadableImage`` with its name) and resize on the
host by the port's ``data.transforms.EvalPreset`` onto the
fixed 800x1344 canvas; each keeps the config's
``select_box_nums_for_evaluation`` top-scored boxes before the
``--score-threshold``, as ``test.py`` does. ``--device cpu`` has no JPEG
decoder: a caller of ``main`` passes ``decode=`` (PNG files need none). ``--checkpoint`` takes the JAX package's
``.npz`` weight files (``params/...`` and ``batch_stats/...`` arrays),
loaded leniently as the root CLI loads them (``utils.weights.load_weights``:
missing and shape-mismatched tensors keep their values and are reported);
the class names it carries (``_classes_``, ``utils/class_names.py``) label
the detections. ``--show-dir`` draws the kept detections over each original
image (``utils/visualize.py``) and writes it there under the file's name
(``data/image_io.py::write_image``: .jpg / .jpeg with cv2's bytes, .png).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from relation_detr_tpu_torch.data.image_io import Decode, read_image, write_image
from relation_detr_tpu_torch.data.transforms import EvalPreset
from relation_detr_tpu_torch.models.post_process import post_process
from relation_detr_tpu_torch.utils.class_names import load_class_names
from relation_detr_tpu_torch.utils.config import Config
from relation_detr_tpu_torch.utils.visualize import plot_bounding_boxes_on_image
from relation_detr_tpu_torch.utils.weights import load_weights

CANVAS = (800, 1344)
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "configs", "relation_detr", "relation_detr_resnet50_800_1333.py",
)


def detect(model: torch.nn.Module, images, masks, orig_sizes,
           select_box_nums: int = 100) -> Dict[str, torch.Tensor]:
    """Eval forward + ``post_process`` on preprocessed inputs.

    images (B, H, W, 3) normalised float, masks (B, H, W) bool (True =
    padding), orig_sizes (B, 2) original (h, w); arrays or tensors, moved to
    the model's device. Returns the ``post_process`` dict.
    """
    device = next(model.parameters()).device
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    masks = torch.as_tensor(masks, dtype=torch.bool, device=device)
    sizes = torch.as_tensor(orig_sizes, dtype=torch.float32, device=device)
    with torch.inference_mode():
        out = model(images, masks)
        return post_process(out["pred_logits"], out["pred_boxes"], sizes, select_box_nums)


def parse_args(argv=None):
    p = argparse.ArgumentParser("relation_detr_tpu_torch inference")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--model-config", default=DEFAULT_CONFIG)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--score-threshold", type=float, default=0.5)
    p.add_argument("--show-dir", default=None,
                   help="draw the kept detections over each image and write it here")
    return p.parse_args(argv)


def main(argv=None, decode: Optional[Decode] = None) -> Dict:
    """Runs the folder inference; returns each file's kept detections
    (``scores``, ``labels``, ``boxes`` arrays) by name, and ``written``, the
    files ``--show-dir`` wrote."""
    args = parse_args(argv)
    cfg = Config(args.model_config)
    model = cfg.build_model(device=args.device)
    class_names = None
    if args.checkpoint:
        load_weights(model, args.checkpoint)
        class_names = load_class_names(args.checkpoint)
    if args.show_dir:
        os.makedirs(args.show_dir, exist_ok=True)
    preset = EvalPreset(cfg.get("min_size", 800), cfg.get("max_size", 1333))
    select_box_nums = cfg.get("select_box_nums_for_evaluation", 300)
    files = sorted(f for f in os.listdir(args.image_dir) if f.lower().endswith(IMAGE_EXTS))
    result = {"detections": {}, "written": []}
    for fname in files:
        rgb = read_image(os.path.join(args.image_dir, fname), args.device, decode)
        sample = preset({
            "image": rgb,
            "boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int64),
            "image_id": 0,
            "orig_size": np.asarray(rgb.shape[:2], np.int64),
        })
        h, w = sample["image"].shape[:2]
        images = np.zeros((1, *CANVAS, 3), np.float32)
        mask = np.ones((1, *CANVAS), bool)
        images[0, :h, :w] = sample["image"]
        mask[0, :h, :w] = False
        det = detect(model, images, mask, [rgb.shape[:2]], select_box_nums)
        keep = det["scores"][0] > args.score_threshold
        kept = {k: det[k][0][keep].cpu().numpy() for k in ("scores", "labels", "boxes")}
        result["detections"][fname] = kept
        print(f"{fname}: {int(keep.sum())} detections")
        for s, l, b in zip(kept["scores"].tolist(), kept["labels"].tolist(),
                           kept["boxes"].tolist()):
            name = (f" ({class_names[l]})" if class_names and 0 <= l < len(class_names)
                    else "")
            print(f"  label {l}{name} score {s:.3f} box {[round(v, 1) for v in b]}")
        if args.show_dir:
            vis = plot_bounding_boxes_on_image(np.ascontiguousarray(rgb[..., ::-1]),
                                               kept["boxes"], kept["scores"], kept["labels"],
                                               class_names=class_names)
            result["written"].append(os.path.join(args.show_dir, fname))
            write_image(result["written"][-1], vis)
    return result


if __name__ == "__main__":
    main()
