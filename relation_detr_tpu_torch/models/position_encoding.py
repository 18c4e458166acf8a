"""Sinusoidal position encodings. Counterpart of
``relation_detr_tpu/models/position_encoding.py``; same layouts (the mask
embedding returns (B, H, W, C), channels last)."""
from __future__ import annotations

import math

import torch


def _dim_t(num_pos_feats: int, temperature: float, device=None) -> torch.Tensor:
    i = torch.arange(num_pos_feats // 2, dtype=torch.float32, device=device)
    return temperature ** (i * 2.0 / num_pos_feats)


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    """(..., n//2) angles -> (..., n) as (sin, cos) pairs."""
    return torch.stack([torch.sin(pos), torch.cos(pos)], dim=-1).flatten(-2)


def position_embedding_sine(
    mask: torch.Tensor,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = 2 * math.pi,
    eps: float = 1e-6,
    offset: float = -0.5,
) -> torch.Tensor:
    """DETR sine embedding of a (B, H, W) padding mask (True = padding) ->
    (B, H, W, 2 * num_pos_feats), channels [y-feats, x-feats]."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        y_embed = (y_embed + offset) / (y_embed[:, -1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, :, -1:] + eps) * scale
    else:
        y_embed = y_embed + offset
        x_embed = x_embed + offset
    dim_t = _dim_t(num_pos_feats, temperature, mask.device)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def get_sine_pos_embed(
    pos_tensor: torch.Tensor,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    scale: float = 2 * math.pi,
    exchange_xy: bool = True,
) -> torch.Tensor:
    """Sine-embed each coordinate of a (..., K) tensor -> (..., K * num_pos_feats);
    ``exchange_xy`` swaps the first two coordinates' embeddings."""
    dim_t = _dim_t(num_pos_feats, temperature, pos_tensor.device)
    pos = _interleave_sin_cos(pos_tensor[..., None] * scale / dim_t)  # (..., K, n)
    if exchange_xy and pos.shape[-2] >= 2:
        pos = torch.cat([pos[..., 1:2, :], pos[..., 0:1, :], pos[..., 2:, :]], dim=-2)
    return pos.flatten(-2)
