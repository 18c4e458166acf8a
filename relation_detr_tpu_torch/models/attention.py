"""Attention modules: dense MHA with an additive logit bias, and multi-scale
deformable attention. Counterpart of ``relation_detr_tpu/models/attention.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from relation_detr_tpu_torch.models.layers import xavier_
from relation_detr_tpu_torch.ops.msda import multi_scale_deformable_attention


class MultiheadAttention(nn.Module):
    """Dense multi-head attention with an optional additive (B, H, Q, K)
    bias: plain matmuls and a softmax (``attention.py:61-67``; the port
    runs in fp32 throughout).
    Parameters use torch's ``nn.MultiheadAttention`` names (in_proj_weight
    holds q/k/v stacked, out_proj)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        # xavier over each (C, C) projection, as the JAX q/k/v Dense layers
        for chunk in self.in_proj_weight.data.chunk(3, dim=0):
            nn.init.xavier_uniform_(chunk, generator=generator)
        nn.init.zeros_(self.in_proj_bias)
        xavier_(self.out_proj, generator)

    def forward(self, query, key, value, attn_bias: Optional[torch.Tensor] = None):
        c, h = self.embed_dim, self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:c], b[:c])
        k = F.linear(key, w[c:2 * c], b[c:2 * c])
        v = F.linear(value, w[2 * c:], b[2 * c:])
        q, k, v = (t.reshape(t.shape[0], t.shape[1], h, c // h) for t in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(c // h)
        if attn_bias is not None:
            logits = logits + attn_bias
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], c))


def sampling_offsets_bias(num_heads: int, num_levels: int, num_points: int) -> torch.Tensor:
    """Per-head radial offset bias (``attention.py:92-109``): head h points
    along angle 2*pi*h/H at unit Chebyshev length, tiled over levels, scaled
    by point index + 1."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (2.0 * math.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    grid = grid * torch.arange(1, num_points + 1, dtype=torch.float32)[None, None, :, None]
    return grid.reshape(-1)


class MultiScaleDeformableAttention(nn.Module):
    """Deformable-DETR MSDA module. The sampling core is
    ``ops.msda.multi_scale_deformable_attention`` (CUDA kernel on the card,
    plain version on CPU); the padded value rows are zeroed after the
    projection (``attention.py:159-160``)."""

    def __init__(self, embed_dim: int = 256, num_levels: int = 4,
                 num_heads: int = 8, num_points: int = 4):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_levels = num_levels
        self.num_heads = num_heads
        self.num_points = num_points
        self.sampling_offsets = nn.Linear(embed_dim, num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(embed_dim, num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.output_proj = nn.Linear(embed_dim, embed_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(
                sampling_offsets_bias(self.num_heads, self.num_levels, self.num_points)
            )
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        xavier_(self.value_proj, generator)
        xavier_(self.output_proj, generator)

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C)
        reference_points: torch.Tensor,  # (B, Q, L, 2) or (B, Q, L, 4), in [0, 1]
        value: torch.Tensor,  # (B, S, C)
        spatial_shapes: Sequence[Tuple[int, int]],
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
    ) -> torch.Tensor:
        bs, num_queries, _ = query.shape
        h, l, p = self.num_heads, self.num_levels, self.num_points
        value = self.value_proj(value)
        if key_padding_mask is not None:
            value = value.masked_fill(key_padding_mask[..., None], 0.0)
        value = value.reshape(bs, value.shape[1], h, self.embed_dim // h)

        offsets = self.sampling_offsets(query).reshape(bs, num_queries, h, l, p, 2)
        weights = self.attention_weights(query).reshape(bs, num_queries, h, l * p)
        weights = torch.softmax(weights, dim=-1).reshape(bs, num_queries, h, l, p)

        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor(
                [(w_, h_) for h_, w_ in spatial_shapes], dtype=torch.float32,
                device=query.device,
            )
            locations = (
                reference_points[:, :, None, :, None, :]
                + offsets / normalizer[None, None, None, :, None, :]
            )
        elif reference_points.shape[-1] == 4:
            locations = (
                reference_points[:, :, None, :, None, :2]
                + offsets / p * reference_points[:, :, None, :, None, 2:] * 0.5
            )
        else:
            raise ValueError(
                f"reference_points last dim must be 2 or 4, got {reference_points.shape[-1]}"
            )
        output = multi_scale_deformable_attention(
            value.contiguous(), tuple(spatial_shapes), locations.contiguous(),
            weights.contiguous(),
        )
        return self.output_proj(output)
