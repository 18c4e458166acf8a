"""The tiny config's overfit check (the JAX package's
``tests/test_overfit_learns.py`` case), on any device.

4 numpy-drawn 192x256 images (one saturated rectangle each on noise), a
tiny RelationDETR (ResNet-18, 1 + 2 layers, 60 queries), ``STEPS`` steps of
``make_train_step`` (CDN, hybrid branch, matcher, criterion, clip, AdamW) at
lr ``LR`` from a random init, then the eval forward, ``post_process`` top-30
and ``CocoEvaluator`` on the training images. It passes when the mean of the
last 5 losses is at most ``LOSS_RATIO`` times the first 5's and AP50 is at
least ``MIN_AP50``. ``tests/test_torch_overfit_learns.py`` runs it on the
CPU, ``chip_smoke.py`` on the card.
"""
import json
import math

import numpy as np
import torch

from relation_detr_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from relation_detr_tpu_torch.losses.criterion import CriterionConfig
from relation_detr_tpu_torch.models.detector import RelationDETR
from relation_detr_tpu_torch.models.post_process import post_process
from relation_detr_tpu_torch.parallel.train_step import make_train_step
from relation_detr_tpu_torch.utils.coco_eval import CocoEvaluator
from relation_detr_tpu_torch.utils.param_groups import build_optimizer

B, H, W, G = 4, 192, 256, 5
SPECS = [  # (cat, x, y, w, h): one big saturated rectangle per image
    (1, 30, 25, 130, 100),
    (2, 140, 80, 100, 85),
    (3, 50, 60, 160, 100),
    (1, 80, 15, 120, 150),
]
COLORS = {1: (1.0, 0.15, 0.15), 2: (0.15, 1.0, 0.15), 3: (0.15, 0.15, 1.0)}
STEPS = 50
LR = 2e-4
LOSS_RATIO = 0.55
MIN_AP50 = 0.5


def make_batch(device):
    rng = np.random.RandomState(3)
    images = rng.randint(0, 60, (B, H, W, 3)).astype(np.float32) / 255.0
    gt_labels = np.zeros((B, G), np.int64)
    gt_boxes = np.full((B, G, 4), 0.5, np.float32)
    gt_valid = np.zeros((B, G), bool)
    for i, (cat, x, y, bw, bh) in enumerate(SPECS):
        images[i, y:y + bh, x:x + bw] = COLORS[cat]
        gt_labels[i, 0] = cat
        gt_boxes[i, 0] = [(x + bw / 2) / W, (y + bh / 2) / H, bw / W, bh / H]
        gt_valid[i, 0] = True
    images = (images - IMAGENET_MEAN) / IMAGENET_STD
    batch = {"images": images.astype(np.float32), "mask": np.zeros((B, H, W), bool),
             "gt_labels": gt_labels, "gt_boxes": gt_boxes, "gt_valid": gt_valid}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def write_annotations(path):
    images, annotations = [], []
    for i, (cat, x, y, bw, bh) in enumerate(SPECS):
        images.append({"id": i, "height": H, "width": W, "file_name": f"{i}.jpg"})
        annotations.append({"id": i + 1, "image_id": i, "category_id": cat,
                            "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": f"c{c}"} for c in (1, 2, 3)]}, f)


def run(device, ann_path):
    """Train and evaluate the tiny config on ``device``; the annotation file
    is written to ``ann_path``. Returns the losses, the means of the first and
    last 5, the evaluator's stats and whether both thresholds hold."""
    model = RelationDETR(num_classes=4, num_queries=60, hybrid_num_proposals=90,
                         denoising_nums=5, transformer_enc_layers=1, transformer_dec_layers=2,
                         backbone_arch="resnet18",
                         generator=torch.Generator().manual_seed(0)).to(device).train()
    step = make_train_step(model, CriterionConfig(num_classes=4), build_optimizer(model, LR),
                           hybrid_assign=6, seed=1)
    batch = make_batch(device)
    losses = [step(batch)["total_loss"] for _ in range(STEPS)]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))

    with torch.inference_mode():
        out = model(batch["images"], batch["mask"])
        det = post_process(out["pred_logits"], out["pred_boxes"],
                           torch.tensor([[H, W]] * B, dtype=torch.float32, device=device), 30)
    write_annotations(ann_path)
    evaluator = CocoEvaluator(str(ann_path))
    for i in range(B):
        evaluator.update_from_arrays(i, det["boxes"][i].cpu().numpy(),
                                     det["scores"][i].cpu().numpy(),
                                     det["labels"][i].cpu().numpy())
    stats = evaluator.accumulate_and_summarize(verbose=False)
    ok = (all(math.isfinite(v) for v in losses) and last <= LOSS_RATIO * first
          and stats["AP50"] >= MIN_AP50)
    return dict(losses=losses, first_loss=first, last_loss=last, stats=stats, ok=ok)
