"""Denoising queries (contrastive CDN and plain DN) with a static capacity.
Counterpart of ``relation_detr_tpu/models/denoising.py``.

The buffer holds ``dn_cap`` slots whatever the batch (CDN: ``2 *
denoising_nums``; DN: ``denoising_groups * max_gt_cap_dn``); ``max_gt`` and
the group count are tensors computed on the device (no host sync). Slot
``s`` decodes as::

    rep = s // max_gt; k = s % max_gt; group = rep // reps_per_group
    positive = rep % reps_per_group == 0

with 2 repetitions a group for CDN (positive, negative) and 1 for DN: the
reference layout [g0_pos | g0_neg | g1_pos | ...]. Slots with ``group >=
groups`` or ``k >= n_gt[b]`` are padding: zero queries, excluded from the
loss through ``DenoisingMeta``.

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


def _cdn_box_noise(boxes, positive, box_noise_scale, draws):
    """Contrastive noise (denoising.py:202-231): positives jitter inside the
    box, negatives are pushed outside (rand_part + 1), in xyxy space."""
    diff = torch.cat([boxes[..., 2:] / 2, boxes[..., 2:] / 2], dim=-1)
    rand_part = torch.where(positive[None, :, None], draws["rand_part"],
                            draws["rand_part"] + 1.0)
    xyxy = box_cxcywh_to_xyxy(boxes) + rand_part * draws["rand_sign"] * diff * box_noise_scale
    return box_xyxy_to_cxcywh(xyxy.clamp(0.0, 1.0))


def _dn_box_noise(boxes, box_noise_scale, draws):
    """DN-DETR noise (denoising.py:56-64): centre jitter up to wh/2, size
    jitter up to wh, in cxcywh space."""
    diff = torch.cat([boxes[..., 2:] / 2, boxes[..., 2:]], dim=-1)
    noise = (draws["noise_u"] * 2.0 - 1.0) * diff * box_noise_scale
    return (boxes + noise).clamp(0.0, 1.0)


class GenerateDenoisingQueries(nn.Module):
    """The DN and CDN generator; ``contrastive=True`` is CDN (state_dict:
    label_encoder.weight, ``embed_dim - 1`` wide with ``with_indicator``)."""

    def __init__(self, num_classes: int, embed_dim: int = 256, contrastive: bool = True,
                 denoising_nums: int = 100, denoising_groups: int = 5,
                 max_gt_cap_dn: int = 60, label_noise_prob: float = 0.5,
                 box_noise_scale: float = 1.0, with_indicator: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.contrastive = contrastive
        self.denoising_nums = denoising_nums
        self.denoising_groups = denoising_groups
        self.max_gt_cap_dn = max_gt_cap_dn
        self.label_noise_prob = label_noise_prob
        self.box_noise_scale = box_noise_scale
        self.with_indicator = with_indicator
        self.label_encoder = nn.Embedding(num_classes, embed_dim - int(with_indicator))

    @property
    def reps_per_group(self) -> int:
        return 2 if self.contrastive else 1

    @property
    def dn_cap(self) -> int:
        if self.contrastive:
            return 2 * self.denoising_nums
        return self.denoising_groups * self.max_gt_cap_dn

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.label_encoder.weight, generator=generator)

    def draw_noise(self, bs: int, generator: Optional[torch.Generator], device
                   ) -> Dict[str, torch.Tensor]:
        """The random draws of one call, in the (B, dn_cap) slot layout:
        ``flip_u`` and ``random_labels``, then CDN's ``rand_sign`` and
        ``rand_part`` or DN's ``noise_u`` (each (B, dn_cap, 4))."""
        shape = (bs, self.dn_cap)
        draws = {
            "flip_u": torch.rand(shape, generator=generator, device=device),
            "random_labels": torch.randint(0, self.num_classes, shape,
                                           generator=generator, device=device),
        }
        if self.contrastive:
            draws["rand_sign"] = torch.randint(0, 2, (*shape, 4), generator=generator,
                                               device=device).float() * 2.0 - 1.0
            draws["rand_part"] = torch.rand((*shape, 4), generator=generator, device=device)
        else:
            draws["noise_u"] = torch.rand((*shape, 4), generator=generator, device=device)
        return draws

    def forward(self, gt_labels: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor, num_matching_queries: int,
                generator: Optional[torch.Generator] = None,
                noise_draws: Optional[Dict[str, torch.Tensor]] = None,
                max_gt: Optional[torch.Tensor] = None):
        """gt_labels (B, G) int, gt_boxes (B, G, 4) cxcywh, gt_valid (B, G)
        bool -> (label queries (B, dn_cap, C), box queries (B, dn_cap, 4) in
        logit space, attention bias (1, 1, T, T) with T = dn_cap +
        num_matching_queries, DenoisingMeta). ``max_gt`` is the largest GT
        count of an image over the global batch when this batch is one
        process's slice of it (the JAX module takes it over the whole
        batch); None: this batch's own. It sets the slot layout and the
        group count, so every process lays out its slots as the global
        batch does."""
        bs, max_gt_cap = gt_labels.shape
        dn_cap = self.dn_cap
        rpg = self.reps_per_group
        device = gt_labels.device
        if noise_draws is None:
            noise_draws = self.draw_noise(bs, generator, device)

        n_gt = gt_valid.sum(1)  # (B,)
        # (n_gt never exceeds the capacity, which only the JAX module's clip names)
        max_gt = (n_gt.max() if max_gt is None else max_gt).clamp(min=1)
        if self.contrastive:  # groups = denoising_nums // max_gt, >= 1 (denoising.py:253-254)
            groups = torch.clamp(self.denoising_nums // max_gt, min=1)
        else:  # the fixed count, cut only where the static capacity would overflow
            groups = torch.clamp(torch.clamp(dn_cap // max_gt, max=self.denoising_groups),
                                 min=1)
        slots = torch.arange(dn_cap, device=device)
        rep = slots // max_gt
        k = slots % max_gt
        group = rep // rpg
        positive = rep % rpg == 0
        slot_used = group < groups
        valid = slot_used[None] & (k[None] < n_gt[:, None])  # (B, dn_cap)

        # a global max_gt may exceed this batch's capacity: slots past it are
        # padding here (k >= n_gt), and read slot G - 1 only to be masked
        k_b = k.clamp(max=max_gt_cap - 1)[None].expand(bs, dn_cap)
        labels = torch.gather(gt_labels, 1, k_b).clamp(0, self.num_classes - 1)
        boxes = torch.gather(gt_boxes, 1, k_b[..., None].expand(bs, dn_cap, 4))

        # CDN halves the flip probability (denoising.py:275)
        flip_prob = self.label_noise_prob * (0.5 if self.contrastive else 1.0)
        flip = noise_draws["flip_u"] < flip_prob
        noised_labels = torch.where(flip, noise_draws["random_labels"].to(labels.dtype), labels)
        if self.contrastive:
            noised_boxes = _cdn_box_noise(boxes, positive, self.box_noise_scale, noise_draws)
        else:
            noised_boxes = _dn_box_noise(boxes, self.box_noise_scale, noise_draws)

        label_queries = self.label_encoder(noised_labels)
        if self.with_indicator:  # denoising queries carry indicator 1 (denoising.py:121-122)
            label_queries = torch.cat([label_queries, label_queries.new_ones(bs, dn_cap, 1)], -1)
        label_queries = torch.where(valid[..., None], label_queries, 0.0)
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


class GenerateCDNQueries(GenerateDenoisingQueries):
    """Contrastive denoising (DINO), the JAX defaults: flip 0.5 (halved),
    box noise 1.0, no indicator."""

    def __init__(self, num_classes: int, embed_dim: int = 256, denoising_nums: int = 100,
                 label_noise_prob: float = 0.5, box_noise_scale: float = 1.0):
        super().__init__(num_classes, embed_dim, contrastive=True,
                         denoising_nums=denoising_nums, label_noise_prob=label_noise_prob,
                         box_noise_scale=box_noise_scale)


class GenerateDNQueries(GenerateDenoisingQueries):
    """Plain denoising (DN-DETR), the JAX defaults: flip 0.2, box noise 0.4,
    an indicator channel."""

    def __init__(self, num_classes: int, embed_dim: int = 256, denoising_groups: int = 5,
                 max_gt_cap_dn: int = 60, label_noise_prob: float = 0.2,
                 box_noise_scale: float = 0.4):
        super().__init__(num_classes, embed_dim, contrastive=False,
                         denoising_groups=denoising_groups, max_gt_cap_dn=max_gt_cap_dn,
                         label_noise_prob=label_noise_prob, box_noise_scale=box_noise_scale,
                         with_indicator=True)
