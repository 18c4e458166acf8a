"""Detection post-processing: flat top-k over (queries x classes), with
the optional confidence and NMS masks, and the segmentation decode.
Counterpart of ``relation_detr_tpu/models/post_process.py``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from relation_detr_tpu_torch.ops.boxes import box_cxcywh_to_xyxy
from relation_detr_tpu_torch.ops.nms import nms_mask


def post_process(
    pred_logits: torch.Tensor,  # (B, Q, K)
    pred_boxes: torch.Tensor,  # (B, Q, 4) normalized cxcywh
    target_sizes: torch.Tensor,  # (B, 2) original (h, w)
    select_box_nums_for_evaluation: int = 300,
    confidence_score: float = -1.0,
    nms_iou_threshold: float = -1.0,
) -> Dict[str, torch.Tensor]:
    """Returns (B, N) scores/labels, (B, N, 4) xyxy boxes in pixels, (B, N)
    valid: above ``confidence_score`` and, with ``nms_iou_threshold`` > 0,
    kept by ``ops.nms.nms_mask`` (per image, on the pixel boxes)."""
    bs, num_queries, num_classes = pred_logits.shape
    prob = torch.sigmoid(pred_logits).reshape(bs, -1)
    k = min(select_box_nums_for_evaluation, num_queries * num_classes)
    scores, topk_indexes = torch.topk(prob, k, dim=1)
    topk_boxes = topk_indexes // num_classes
    labels = topk_indexes % num_classes
    boxes = box_cxcywh_to_xyxy(pred_boxes)
    boxes = torch.gather(boxes, 1, topk_boxes[..., None].expand(-1, -1, 4))
    img_h, img_w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)[:, None, :]
    boxes = boxes * scale
    valid = torch.ones_like(scores, dtype=torch.bool)
    if confidence_score > 0:
        valid = valid & (scores > confidence_score)
    if nms_iou_threshold > 0:
        valid = valid & nms_mask(boxes, scores, nms_iou_threshold)
    return {"scores": scores, "labels": labels, "boxes": boxes, "valid": valid}


def segmentation_post_process(
    pred_logits: torch.Tensor,  # (B, Q, K)
    pred_masks: torch.Tensor,  # (B, Q, h, w) low-res mask logits
    target_hw: Tuple[int, int],  # output (H, W)
) -> torch.Tensor:
    """Per-class averaged mask decode -> (B, H, W) class map: each query
    joins its argmax class, each class's map is the mean of its queries'
    sigmoid masks (0 with none), resized bilinearly (half-pixel centres) and
    argmaxed over the classes. The resize is ``jax.image.resize``'s: a
    triangle kernel that widens where the map shrinks (``antialias``;
    where it grows, the plain bilinear's weights)."""
    num_classes = pred_logits.shape[-1]
    member = F.one_hot(pred_logits.argmax(-1), num_classes).to(pred_masks.dtype)  # (B, Q, K)
    sums = torch.einsum("bqk,bqhw->bkhw", member, torch.sigmoid(pred_masks))
    per_class = sums / member.sum(1).clamp(min=1.0)[..., None, None]
    per_class = F.interpolate(per_class, size=tuple(target_hw), mode="bilinear",
                              align_corners=False, antialias=True)
    return per_class.argmax(1)
