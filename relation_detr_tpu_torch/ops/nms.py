"""Greedy NMS as a keep mask. Counterpart of
``relation_detr_tpu/ops/nms.py::nms_mask`` (vmapped over the batch by its
caller, ``models/post_process.py``; here the batch is a leading dim).

The greedy rule keeps box j (in score order) unless a kept box i < j has
IoU > threshold with it. JAX runs it as a ``fori_loop`` over i. Here it runs
on the device as the same rule's fixed point: from all-kept, each pass
recomputes every box's keep from the pass before, ``keep[j] = not any(i < j
and keep[i] and iou[i, j] > thr)``. Box j's value is final once those of
boxes 0..j-1 are, so the passes reach the greedy mask after at most as many
passes as the longest chain of suppressions, and a pass that changes
nothing has reached it (the rule has one solution). Each pass ends with one
scalar read to the host; no (N, N) tensor leaves the device.
"""
from __future__ import annotations

import torch

from relation_detr_tpu_torch.ops.boxes import box_iou


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over (..., N, 4) xyxy boxes and (..., N) scores -> (..., N)
    bool keep mask in the input order. The order is a stable sort by
    descending score (``jnp.argsort`` is stable, and ties are common)."""
    n = boxes.shape[-2]
    order = torch.argsort(-scores, dim=-1, stable=True)
    ordered = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    ious = box_iou(ordered, ordered)  # (..., N, N)
    upper = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    over = (ious > iou_threshold) & upper  # over[i, j]: i < j and IoU above
    keep = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
    for _ in range(n):
        new = ~(over & keep[..., :, None]).any(-2)
        if torch.equal(new, keep):
            break
        keep = new
    return torch.zeros_like(keep).scatter(-1, order, keep)
