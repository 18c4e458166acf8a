"""Box coordinate ops. Counterpart of ``relation_detr_tpu/ops/boxes.py``."""
from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x0, y0, x1, y1), any leading dims."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x0, y0, x1, y1) -> (cx, cy, w, h), any leading dims."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, shape (..., N)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _hull_area(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Area of the smallest box enclosing both (aligned shapes)."""
    wh = (torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
          - torch.minimum(boxes1[..., :2], boxes2[..., :2])).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def elementwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of aligned xyxy boxes: (..., 4) x (..., 4) -> (...)."""
    wh = (torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
          - torch.maximum(boxes1[..., :2], boxes2[..., :2])).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter / union.clamp(min=1e-12)


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    return elementwise_box_iou(boxes1[..., :, None, :], boxes2[..., None, :, :])


def elementwise_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor
                                    ) -> torch.Tensor:
    """Elementwise GIoU of aligned xyxy boxes: IoU - (hull - union) / hull."""
    wh = (torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
          - torch.maximum(boxes1[..., :2], boxes2[..., :2])).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    iou = inter / union.clamp(min=1e-12)
    hull = _hull_area(boxes1, boxes2)
    return iou - (hull - union) / hull.clamp(min=1e-12)


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    return elementwise_generalized_box_iou(boxes1[..., :, None, :], boxes2[..., None, :, :])


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Clamped logit, as ``relation_detr_tpu.ops.boxes.inverse_sigmoid``."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))
