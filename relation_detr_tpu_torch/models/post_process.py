"""Detection post-processing: flat top-k over (queries x classes).
Counterpart of ``relation_detr_tpu/models/post_process.py::post_process``
without NMS (``ops/nms.py`` is ROADMAP Queue 1 item 12)."""
from __future__ import annotations

from typing import Dict

import torch

from relation_detr_tpu_torch.ops.boxes import box_cxcywh_to_xyxy


def post_process(
    pred_logits: torch.Tensor,  # (B, Q, K)
    pred_boxes: torch.Tensor,  # (B, Q, 4) normalized cxcywh
    target_sizes: torch.Tensor,  # (B, 2) original (h, w)
    select_box_nums_for_evaluation: int = 300,
    confidence_score: float = -1.0,
    nms_iou_threshold: float = -1.0,
) -> Dict[str, torch.Tensor]:
    """Returns (B, N) scores/labels, (B, N, 4) xyxy boxes in pixels, (B, N) valid."""
    if nms_iou_threshold > 0:
        raise NotImplementedError("NMS is not ported yet (ROADMAP Queue 1 item 12)")
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
    return {"scores": scores, "labels": labels, "boxes": boxes, "valid": valid}
