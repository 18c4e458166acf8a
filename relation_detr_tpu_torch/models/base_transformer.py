"""Shared DETR-transformer helpers. Counterpart of
``relation_detr_tpu/models/base_transformer.py``; same layouts (per-level
maps channels last)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def flatten_multi_level(elements: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat per-level (B, H, W, C) maps into (B, S, C) tokens, or (B, H, W)
    masks into (B, S)."""
    return torch.cat([e.flatten(1, 2) for e in elements], dim=1)


def get_spatial_shapes(masks: Sequence[torch.Tensor]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(m.shape[1]), int(m.shape[2])) for m in masks)


def get_valid_ratios(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of non-padded rows/cols, (B, 2) in (w, h) order."""
    _, h, w = mask.shape
    valid_h = torch.sum(~mask[:, :, 0], dim=1).float()
    valid_w = torch.sum(~mask[:, 0, :], dim=1).float()
    return torch.stack([valid_w / w, valid_h / h], dim=-1)


def multi_level_valid_ratios(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """(B, L, 2)."""
    return torch.stack([get_valid_ratios(m) for m in masks], dim=1)


def get_full_reference_points(
    spatial_shapes: Sequence[Tuple[int, int]], valid_ratios: torch.Tensor
) -> torch.Tensor:
    """Cell-center grid per level, scaled by 1/valid_ratio -> (B, S, 2) (x, y)."""
    refs: List[torch.Tensor] = []
    device = valid_ratios.device
    for lvl, (h, w) in enumerate(spatial_shapes):
        ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
        xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
        ref_y = ys[:, None].expand(h, w).reshape(1, -1)
        ref_x = xs[None, :].expand(h, w).reshape(1, -1)
        ref_y = ref_y / (valid_ratios[:, None, lvl, 1] * h)
        ref_x = ref_x / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([ref_x, ref_y], dim=-1))
    return torch.cat(refs, dim=1)


def get_reference(
    spatial_shapes: Sequence[Tuple[int, int]], valid_ratios: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder reference points (B, S, L, 2) and two-stage proposals
    (B, S, 4) cxcywh with level-scaled wh = 0.05 * 2**lvl."""
    full = get_full_reference_points(spatial_shapes, valid_ratios)
    reference_points = full[:, :, None, :] * valid_ratios[:, None, :, :]
    level_wh = torch.cat([
        torch.full((h * w, 2), 0.05 * (2.0 ** lvl), device=full.device)
        for lvl, (h, w) in enumerate(spatial_shapes)
    ])
    proposals = torch.cat([full, level_wh[None].expand_as(full)], dim=-1)
    return reference_points, proposals
