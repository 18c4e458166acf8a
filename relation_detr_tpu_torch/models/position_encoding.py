"""Position encodings: the sine embeddings and the learned one.
Counterpart of ``relation_detr_tpu/models/position_encoding.py``; same
layouts (the mask embeddings return (B, H, W, C), channels last)."""
from __future__ import annotations

import math

import torch
from torch import nn


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


class PositionEmbeddingLearned(nn.Module):
    """Learned absolute position embedding (uniform [0, 1) row and column
    tables; state_dict ``row_embed.weight`` / ``col_embed.weight``, the JAX
    module's ``row_embed`` / ``col_embed``). A (B, H, W) mask gives (B, H,
    W, 2 * num_pos_feats), channels [col(x), row(y)], the opposite order
    from the sine embedding's. A row or column past the table takes its
    last entry, as the JAX gather clamps its index."""

    def __init__(self, num_embeddings: int = 50, num_pos_feats: int = 256):
        super().__init__()
        self.row_embed = nn.Embedding(num_embeddings, num_pos_feats)
        self.col_embed = nn.Embedding(num_embeddings, num_pos_feats)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.uniform_(self.row_embed.weight, generator=generator)
        nn.init.uniform_(self.col_embed.weight, generator=generator)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        b, h, w = mask.shape
        last = self.row_embed.num_embeddings - 1
        x_emb = self.col_embed(torch.arange(w, device=mask.device).clamp(max=last))  # (W, F)
        y_emb = self.row_embed(torch.arange(h, device=mask.device).clamp(max=last))  # (H, F)
        f = x_emb.shape[-1]
        pos = torch.cat([x_emb[None].expand(h, w, f), y_emb[:, None].expand(h, w, f)], -1)
        return pos[None].expand(b, h, w, 2 * f)
