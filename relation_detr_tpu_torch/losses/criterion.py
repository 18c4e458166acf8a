"""Set criterion: Hungarian matching + focal/varifocal + L1 + GIoU losses.
Counterpart of ``relation_detr_tpu/losses/criterion.py``.

Targets have a fixed capacity: labels (B, G), boxes (B, G, 4) normalised
cxcywh, valid (B, G). Matching costs are computed on the device for every
output set at once and cross to the host in one copy, where
``ops.hungarian.hungarian_assignment`` (scipy) solves each image and set,
as the reference matcher does; that copy is the train step's one host
sync. The losses stay on the device.

``CriterionConfig`` holds the fields the Relation-DETR configs set; the
JAX config's Align-DETR ``mixed_match`` and ``two_stage_binary_cls``
belong to other model families (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from relation_detr_tpu_torch.losses.losses import sigmoid_focal_loss, vari_sigmoid_focal_loss
from relation_detr_tpu_torch.ops.boxes import (
    box_cxcywh_to_xyxy,
    elementwise_box_iou,
    elementwise_generalized_box_iou,
    generalized_box_iou,
)
from relation_detr_tpu_torch.ops.hungarian import hungarian_assignment


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int
    # matcher cost weights
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    # loss weights
    weight_class: float = 1.0
    weight_bbox: float = 5.0
    weight_giou: float = 2.0
    class_loss_type: str = "vari_focal"  # "focal" | "vari_focal"
    aux_loss: bool = True


def matching_cost(cfg: CriterionConfig, pred_logits, pred_boxes, gt_labels, gt_boxes):
    """(..., Q, K) logits, (..., Q, 4) boxes, (..., G) labels, (..., G, 4)
    boxes -> (..., Q, G) cost (``compute_matching``'s ``one_image``)."""
    out_prob = torch.sigmoid(pred_logits)
    labels = gt_labels.clamp(0, cfg.num_classes - 1)
    prob_at = torch.gather(out_prob, -1, labels[..., None, :].expand(
        *out_prob.shape[:-1], labels.shape[-1]))  # (..., Q, G)
    alpha, gamma = cfg.focal_alpha, cfg.focal_gamma
    neg_cost = -(1 - alpha) * prob_at ** gamma * torch.log(1 - prob_at + 1e-6)
    pos_cost = -alpha * (1 - prob_at) ** gamma * torch.log(prob_at + 1e-6)
    cost_bbox = (pred_boxes[..., :, None, :] - gt_boxes[..., None, :, :]).abs().sum(-1)
    cost_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(gt_boxes))
    return (cfg.cost_bbox * cost_bbox + cfg.cost_class * (pos_cost - neg_cost)
            + cfg.cost_giou * cost_giou)


def compute_matching(cfg: CriterionConfig, pred_logits, pred_boxes, gt_labels, gt_boxes,
                     gt_valid) -> torch.Tensor:
    """Hungarian match of (..., B, Q, K) logits and (..., B, Q, 4) boxes
    (any leading set dims) against (B, G) targets -> (..., B, G) int64 query
    index per GT, -1 for invalid GT. Only the valid GT columns of the cost
    cross to the host. ``compute_matching.host_seconds`` adds up the host
    time of the solves."""
    device = pred_logits.device
    lead = tuple(pred_logits.shape[:-3])
    bs, num_gt = gt_valid.shape
    valid = gt_valid.cpu().numpy()
    n_valid = valid.sum(1)
    n_max = max(int(n_valid.max(initial=0)), 1)
    # each image's valid GT slots first, in slot order
    order = np.argsort(~valid, axis=1, kind="stable")[:, :n_max]
    idx = torch.from_numpy(order).to(device)
    with torch.no_grad():
        labels = torch.gather(gt_labels, 1, idx)
        boxes = torch.gather(gt_boxes, 1, idx[..., None].expand(bs, n_max, 4))
        cost = matching_cost(cfg, pred_logits, pred_boxes, labels, boxes)
        cost = cost.transpose(-1, -2).cpu().numpy()  # (..., B, n_max, Q)
    t0 = time.perf_counter()
    match = np.full(lead + (bs, num_gt), -1, np.int64)
    rows = np.arange(n_max)
    for s in np.ndindex(*lead):
        for b in range(bs):
            n = int(n_valid[b])
            if n:
                match[s + (b, order[b, :n])] = hungarian_assignment(
                    cost[s + (b,)], rows < n)[:n]
    compute_matching.host_seconds += time.perf_counter() - t0
    return torch.from_numpy(match).to(device)


compute_matching.host_seconds = 0.0


def _scatter_targets(cfg, match, gt_labels, pair_valid, iou_score, num_queries):
    """(B, Q) target class map (num_classes = background) and IoU map."""
    bs = match.shape[0]
    match_safe = torch.where(pair_valid, match, num_queries)  # column Q is dropped
    target_classes = torch.full((bs, num_queries + 1), cfg.num_classes,
                                dtype=torch.int64, device=match.device)
    target_classes.scatter_(1, match_safe, gt_labels.clamp(0, cfg.num_classes - 1).long())
    target_iou = None
    if iou_score is not None:
        target_iou = iou_score.new_zeros(bs, num_queries + 1)
        target_iou.scatter_(1, match_safe, iou_score)
        target_iou = target_iou[:, :num_queries]
    return target_classes[:, :num_queries], target_iou


def _class_loss(cfg, pred_logits, target_classes, target_iou, num_boxes, query_mask):
    num_queries = pred_logits.shape[1]
    onehot = F.one_hot(target_classes, cfg.num_classes + 1)[..., :-1].to(pred_logits.dtype)
    if cfg.class_loss_type == "vari_focal":
        loss = vari_sigmoid_focal_loss(pred_logits, onehot, target_iou, num_boxes,
                                       cfg.focal_alpha, cfg.focal_gamma, query_mask)
    else:
        loss = sigmoid_focal_loss(pred_logits, onehot, num_boxes, cfg.focal_alpha,
                                  cfg.focal_gamma, query_mask)
    return loss * num_queries  # set_criterion.py:72-80


def _box_losses(src_boxes, tgt_boxes, pair_valid, num_boxes):
    m = pair_valid[..., None].to(src_boxes.dtype)
    loss_bbox = ((src_boxes - tgt_boxes).abs() * m).sum() / num_boxes
    giou = elementwise_generalized_box_iou(box_cxcywh_to_xyxy(src_boxes),
                                           box_cxcywh_to_xyxy(tgt_boxes))
    loss_giou = ((1.0 - giou) * pair_valid).sum() / num_boxes
    return loss_bbox, loss_giou


def calculate_loss(cfg: CriterionConfig, pred_logits, pred_boxes, gt_labels, gt_boxes,
                   gt_valid, num_boxes, match) -> Dict[str, torch.Tensor]:
    """Class and box losses of one output set under a (B, G) match."""
    num_queries = pred_logits.shape[1]
    match_gather = match.clamp(0, num_queries - 1)
    src_boxes = torch.gather(pred_boxes, 1, match_gather[..., None].expand(*match.shape, 4))
    pair_valid = gt_valid & (match >= 0)
    iou_score = None
    if cfg.class_loss_type == "vari_focal":
        iou_score = elementwise_box_iou(box_cxcywh_to_xyxy(src_boxes),
                                        box_cxcywh_to_xyxy(gt_boxes)).detach()
        iou_score = torch.where(pair_valid, iou_score, 0.0)
    target_classes, target_iou = _scatter_targets(
        cfg, match, gt_labels, pair_valid, iou_score, num_queries
    )
    loss_class = _class_loss(cfg, pred_logits, target_classes, target_iou, num_boxes, None)
    loss_bbox, loss_giou = _box_losses(src_boxes, gt_boxes, pair_valid, num_boxes)
    return {"loss_class": loss_class, "loss_bbox": loss_bbox, "loss_giou": loss_giou}


def criterion_forward(cfg: CriterionConfig, outputs: Dict, gt_labels, gt_boxes, gt_valid,
                      num_boxes) -> Dict[str, torch.Tensor]:
    """Losses of the last layer, every aux layer (suffix ``_{i}``) and the
    encoder top-k (``_enc``), each matched on its own; all sets are matched
    in one ``compute_matching`` call."""
    names, logits, boxes = [""], [outputs["pred_logits"]], [outputs["pred_boxes"]]
    if cfg.aux_loss and "aux_outputs" in outputs:
        aux = outputs["aux_outputs"]
        for i in range(aux["pred_logits"].shape[0]):
            names.append(f"_{i}")
            logits.append(aux["pred_logits"][i])
            boxes.append(aux["pred_boxes"][i])
    if "enc_outputs" in outputs:
        names.append("_enc")
        logits.append(outputs["enc_outputs"]["pred_logits"])
        boxes.append(outputs["enc_outputs"]["pred_boxes"])
    match_all = compute_matching(cfg, torch.stack(logits).detach(), torch.stack(boxes).detach(),
                                 gt_labels, gt_boxes, gt_valid)
    losses: Dict[str, torch.Tensor] = {}
    for i, suffix in enumerate(names):
        set_loss = calculate_loss(cfg, logits[i], boxes[i], gt_labels, gt_boxes, gt_valid,
                                  num_boxes, match_all[i])
        losses.update({f"{k}{suffix}": v for k, v in set_loss.items()})
    return losses


def denoising_loss(cfg: CriterionConfig, dn_outputs: Dict, dn_meta, gt_labels, gt_boxes,
                   gt_valid, num_boxes) -> Dict[str, torch.Tensor]:
    """CDN losses with fixed indices: positives against their own GT,
    negatives and padding as background, ``num_boxes`` scaled by the group
    count; slots past the used groups are masked out."""
    num_layers, bs, dn_cap, _ = dn_outputs["pred_logits"].shape
    dn_num_boxes = num_boxes * dn_meta.groups
    gt_idx = dn_meta.dn_gt_index.clamp(0, gt_labels.shape[1] - 1)
    slot_labels = torch.gather(gt_labels, 1, gt_idx)
    slot_boxes = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(bs, dn_cap, 4))
    positive = dn_meta.dn_positive
    target_classes = torch.where(positive, slot_labels.clamp(0, cfg.num_classes - 1).long(),
                                 cfg.num_classes)
    query_mask = dn_meta.dn_slot_used[None].expand(bs, dn_cap).float()
    losses = {}
    for layer in range(num_layers):
        logits = dn_outputs["pred_logits"][layer]
        boxes = dn_outputs["pred_boxes"][layer]
        target_iou = None
        if cfg.class_loss_type == "vari_focal":
            iou = elementwise_box_iou(box_cxcywh_to_xyxy(boxes),
                                      box_cxcywh_to_xyxy(slot_boxes)).detach()
            target_iou = torch.where(positive, iou, 0.0)
        loss_class = _class_loss(cfg, logits, target_classes, target_iou, dn_num_boxes,
                                 query_mask)
        loss_bbox, loss_giou = _box_losses(boxes, slot_boxes, positive, dn_num_boxes)
        suffix = "_dn" if layer == num_layers - 1 else f"_dn_{layer}"
        losses[f"loss_class{suffix}"] = loss_class
        losses[f"loss_bbox{suffix}"] = loss_bbox
        losses[f"loss_giou{suffix}"] = loss_giou
    return losses


def build_weight_dict(cfg: CriterionConfig, num_decoder_layers: int, with_dn: bool,
                      with_hybrid: bool) -> Dict[str, float]:
    """Loss-term weights, as the reference config assembles them."""
    base = {"loss_class": cfg.weight_class, "loss_bbox": cfg.weight_bbox,
            "loss_giou": cfg.weight_giou}
    weights = dict(base)
    if with_dn:
        weights.update({f"{k}_dn": v for k, v in base.items()})
    aux = {}
    for i in range(num_decoder_layers - 1):
        aux.update({f"{k}_{i}": v for k, v in weights.items()})
    weights.update(aux)
    weights.update({f"{k}_enc": v for k, v in base.items()})
    if with_hybrid:
        weights.update({f"{k}_hybrid": v for k, v in weights.items()})
    return weights


def relation_detr_loss(cfg: CriterionConfig, outputs: Dict, gt_labels, gt_boxes, gt_valid,
                       hybrid_assign: int = 6) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted total and the dict of every loss term. ``num_boxes`` is
    the valid-GT count, at least 1; the hybrid set matches against the
    targets tiled ``hybrid_assign`` times, with their own count."""
    num_boxes = gt_valid.sum().float().clamp(min=1.0)
    losses = criterion_forward(cfg, outputs, gt_labels, gt_boxes, gt_valid, num_boxes)
    if "dn_outputs" in outputs:
        losses.update(denoising_loss(cfg, outputs["dn_outputs"], outputs["dn_meta"],
                                     gt_labels, gt_boxes, gt_valid, num_boxes))
    if "hybrid_outputs" in outputs:
        tiled_labels = gt_labels.repeat(1, hybrid_assign)
        tiled_boxes = gt_boxes.repeat(1, hybrid_assign, 1)
        tiled_valid = gt_valid.repeat(1, hybrid_assign)
        hybrid_num_boxes = tiled_valid.sum().float().clamp(min=1.0)
        hybrid = criterion_forward(cfg, outputs["hybrid_outputs"], tiled_labels, tiled_boxes,
                                   tiled_valid, hybrid_num_boxes)
        losses.update({f"{k}_hybrid": v for k, v in hybrid.items()})
    num_dec_layers = outputs["aux_outputs"]["pred_logits"].shape[0] + 1
    weight_dict = build_weight_dict(cfg, num_dec_layers, with_dn="dn_outputs" in outputs,
                                    with_hybrid="hybrid_outputs" in outputs)
    total = sum(losses[k] * w for k, w in weight_dict.items() if k in losses)
    return total, losses

