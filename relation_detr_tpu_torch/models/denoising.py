"""Contrastive denoising (CDN) queries with a static capacity. Counterpart of
``relation_detr_tpu/models/denoising.py`` (``GenerateCDNQueries``).

The buffer holds ``dn_cap = 2 * denoising_nums`` slots whatever the batch;
``max_gt`` and the group count are tensors computed on the device (no host
sync). Slot ``s`` decodes as::

    rep = s // max_gt; k = s % max_gt; group = rep // 2
    positive = rep % 2 == 0

the reference layout [g0_pos | g0_neg | g1_pos | ...]. Slots with
``group >= groups`` or ``k >= n_gt[b]`` are padding: zero queries, excluded
from the loss through ``DenoisingMeta``.

Random draws come from a ``torch.Generator`` (the JAX module's come from
``jax.random``, so the two never draw the same numbers); ``noise_draws``
injects them instead, so tests can give both the same noise.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from relation_detr_tpu_torch.ops.boxes import (
    box_cxcywh_to_xyxy,
    box_xyxy_to_cxcywh,
    inverse_sigmoid,
)

NEG_INF = -1e9  # the JAX package's finite -inf for blocked attention pairs


class DenoisingMeta(NamedTuple):
    groups: torch.Tensor  # () int64, the effective group count
    max_gt: torch.Tensor  # () int64
    dn_valid: torch.Tensor  # (B, dn_cap) bool: slot holds a real noised query
    dn_positive: torch.Tensor  # (B, dn_cap) bool: reconstruction slot
    dn_gt_index: torch.Tensor  # (B, dn_cap) int64: matched gt slot, -1 otherwise
    dn_slot_used: torch.Tensor  # (dn_cap,) bool: slot inside the used dn region


class GenerateCDNQueries(nn.Module):
    """CDN generator (state_dict: label_encoder.weight)."""

    def __init__(self, num_classes: int, embed_dim: int = 256, denoising_nums: int = 100,
                 label_noise_prob: float = 0.5, box_noise_scale: float = 1.0):
        super().__init__()
        self.num_classes = num_classes
        self.denoising_nums = denoising_nums
        self.label_noise_prob = label_noise_prob
        self.box_noise_scale = box_noise_scale
        self.label_encoder = nn.Embedding(num_classes, embed_dim)

    @property
    def dn_cap(self) -> int:
        return 2 * self.denoising_nums

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.label_encoder.weight, generator=generator)

    def draw_noise(self, bs: int, generator: Optional[torch.Generator], device
                   ) -> Dict[str, torch.Tensor]:
        """The random draws of one call, in the (B, dn_cap) slot layout."""
        shape = (bs, self.dn_cap)
        return {
            "flip_u": torch.rand(shape, generator=generator, device=device),
            "random_labels": torch.randint(0, self.num_classes, shape,
                                           generator=generator, device=device),
            "rand_sign": torch.randint(0, 2, (*shape, 4), generator=generator,
                                       device=device).float() * 2.0 - 1.0,
            "rand_part": torch.rand((*shape, 4), generator=generator, device=device),
        }

    def forward(self, gt_labels: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor, num_matching_queries: int,
                generator: Optional[torch.Generator] = None,
                noise_draws: Optional[Dict[str, torch.Tensor]] = None):
        """gt_labels (B, G) int, gt_boxes (B, G, 4) cxcywh, gt_valid (B, G)
        bool -> (label queries (B, dn_cap, C), box queries (B, dn_cap, 4) in
        logit space, attention bias (1, 1, T, T) with T = dn_cap +
        num_matching_queries, DenoisingMeta)."""
        bs, max_gt_cap = gt_labels.shape
        dn_cap = self.dn_cap
        device = gt_labels.device
        if noise_draws is None:
            noise_draws = self.draw_noise(bs, generator, device)

        n_gt = gt_valid.sum(1)  # (B,)
        max_gt = n_gt.max().clamp(1, max_gt_cap)
        groups = torch.clamp(self.denoising_nums // max_gt, min=1)
        slots = torch.arange(dn_cap, device=device)
        rep = slots // max_gt
        k = slots % max_gt
        group = rep // 2
        positive = rep % 2 == 0
        slot_used = group < groups
        valid = slot_used[None] & (k[None] < n_gt[:, None])  # (B, dn_cap)

        k_b = k[None].expand(bs, dn_cap)
        labels = torch.gather(gt_labels, 1, k_b).clamp(0, self.num_classes - 1)
        boxes = torch.gather(gt_boxes, 1, k_b[..., None].expand(bs, dn_cap, 4))

        # CDN halves the flip probability (denoising.py:275)
        flip = noise_draws["flip_u"] < self.label_noise_prob * 0.5
        noised_labels = torch.where(flip, noise_draws["random_labels"].to(labels.dtype), labels)

        # contrastive box noise (denoising.py:202-231): positives jitter
        # inside the box, negatives are pushed outside, in xyxy space
        diff = torch.cat([boxes[..., 2:] / 2, boxes[..., 2:] / 2], dim=-1)
        rand_part = torch.where(positive[None, :, None], noise_draws["rand_part"],
                                noise_draws["rand_part"] + 1.0)
        xyxy = (box_cxcywh_to_xyxy(boxes)
                + rand_part * noise_draws["rand_sign"] * diff * self.box_noise_scale)
        noised_boxes = box_xyxy_to_cxcywh(xyxy.clamp(0.0, 1.0))

        label_queries = torch.where(valid[..., None], self.label_encoder(noised_labels), 0.0)
        box_queries = torch.where(valid[..., None], inverse_sigmoid(noised_boxes), 0.0)

        # attention bias over [dn | matching] (denoising.py:66-78): matching
        # queries cannot see dn keys; dn queries see only their own group
        total = dn_cap + num_matching_queries
        q_group = torch.cat([group, group.new_full((num_matching_queries,), -1)])
        is_dn_key = torch.arange(total, device=device) < dn_cap
        blocked = is_dn_key[None, :] & (q_group[:, None] != q_group[None, :])
        blocked &= ~torch.eye(total, dtype=torch.bool, device=device)
        attn_bias = torch.zeros(total, total, device=device).masked_fill(blocked, NEG_INF)

        dn_positive = positive[None] & valid
        meta = DenoisingMeta(
            groups=groups,
            max_gt=max_gt,
            dn_valid=valid,
            dn_positive=dn_positive,
            dn_gt_index=torch.where(dn_positive, k[None], -1),
            dn_slot_used=slot_used,
        )
        return label_queries, box_queries, attn_bias[None, None], meta
