"""Position relation embedding. Counterpart of
``relation_detr_tpu/models/relation.py``.

The bias runs through ``ops.relation_bias.relation_bias_v4`` — the v4 math
of the JAX package's TPU default path (the CUDA kernel on the card, its
plain version on CPU). ``box_rel_encoding`` is the direct pairwise relation,
kept for parity tests against the unfused JAX path.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from relation_detr_tpu_torch.ops.relation_bias import relation_bias_v4


def box_rel_encoding(src_boxes: torch.Tensor, tgt_boxes: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Pairwise 4-vector relation of cxcywh boxes: (B, N1, 4) x (B, N2, 4)
    -> (B, N1, N2, 4)."""
    xy1, wh1 = src_boxes[..., :2], src_boxes[..., 2:]
    xy2, wh2 = tgt_boxes[..., :2], tgt_boxes[..., 2:]
    delta_xy = torch.abs(xy1[..., :, None, :] - xy2[..., None, :, :])
    delta_xy = torch.log(delta_xy / (wh1[..., :, None, :] + eps) + 1.0)
    delta_wh = torch.log((wh1[..., :, None, :] + eps) / (wh2[..., None, :, :] + eps))
    return torch.cat([delta_xy, delta_wh], dim=-1)


class PositionRelationEmbedding(nn.Module):
    """Box-pair geometry -> per-head additive attention bias (B, H, N1, N2).

    state_dict: pos_proj.0.weight (H, 4E, 1, 1) and pos_proj.0.bias, the
    reference's 1x1 Conv2d + ReLU."""

    def __init__(self, embed_dim: int = 16, num_heads: int = 8,
                 temperature: float = 10000.0, scale: float = 100.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.temperature = temperature
        self.scale = scale
        self.pos_proj = nn.Sequential(nn.Conv2d(4 * embed_dim, num_heads, 1), nn.ReLU())

    def init_weights(self, generator: torch.Generator) -> None:
        # torch Conv2d default, as the JAX module's init
        bound = 1.0 / math.sqrt(4 * self.embed_dim)
        nn.init.uniform_(self.pos_proj[0].weight, -bound, bound, generator=generator)
        nn.init.uniform_(self.pos_proj[0].bias, -bound, bound, generator=generator)

    def forward(self, src_boxes: torch.Tensor, tgt_boxes: torch.Tensor) -> torch.Tensor:
        conv = self.pos_proj[0]
        kernel = conv.weight.reshape(self.num_heads, 4 * self.embed_dim).t().contiguous()
        # the sine embedding carries no gradient: boxes are detached
        return relation_bias_v4(
            src_boxes.detach().contiguous(), tgt_boxes.detach().contiguous(),
            kernel, conv.bias, self.embed_dim, self.temperature, self.scale,
        )
