"""Classification losses (focal family), padded-batch form. Counterpart of
``relation_detr_tpu/losses/losses.py``.

Both reduce as ``(loss.sum(queries) / num_queries).sum() / num_boxes`` and
are multiplied by ``num_queries`` at the call site; the optional per-query
mask makes padding slots contribute exactly zero.
"""
from __future__ import annotations

from typing import Optional

import torch


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy on logits (the JAX form)."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _reduce(loss, num_boxes, query_mask):
    if query_mask is not None:
        loss = loss * query_mask[..., None]
    return (loss.sum(1) / max(loss.shape[1], 1)).sum() / num_boxes


def sigmoid_focal_loss(logits: torch.Tensor, targets_onehot: torch.Tensor, num_boxes,
                       alpha: float = 0.25, gamma: float = 2.0,
                       query_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Focal loss; the weight keeps its gradient (losses.py:4-12)."""
    prob = torch.sigmoid(logits)
    t = targets_onehot.to(logits.dtype)
    weight = (1 - alpha) * prob ** gamma * (1 - t) + t * alpha * (1 - prob) ** gamma
    return _reduce(_bce_with_logits(logits, t) * weight, num_boxes, query_mask)


def vari_sigmoid_focal_loss(logits: torch.Tensor, targets_onehot: torch.Tensor,
                            gt_score: torch.Tensor, num_boxes, alpha: float = 0.25,
                            gamma: float = 2.0,
                            query_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """IoU-aware varifocal loss with a detached probability (losses.py:15-21);
    ``gt_score`` (B, Q) is the detached IoU of the matched pair."""
    prob = torch.sigmoid(logits).detach()
    t = targets_onehot.to(logits.dtype)
    target_score = t * gt_score[..., None]
    weight = (1 - alpha) * prob ** gamma * (1 - t) + target_score
    return _reduce(_bce_with_logits(logits, target_score) * weight, num_boxes, query_mask)
