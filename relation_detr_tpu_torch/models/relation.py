"""Position relation embedding. Counterpart of
``relation_detr_tpu/models/relation.py``.

On CUDA tensors the bias follows ``ops.relation_bias.set_fused_relation``
as the JAX ``_PosProj`` does on the TPU: version 4 (the default) the v4
kernel (``relation_bias_v4``), version 3 ``separable_relation_bias``, 1 and
2 the relation-tensor kernel (``fused_relation_bias`` over
``box_rel_encoding``), disabled the direct embedding. CPU tensors take the
v4 math's plain version whatever the setting.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from relation_detr_tpu_torch.models.position_encoding import get_sine_pos_embed
from relation_detr_tpu_torch.ops import relation_bias as rb


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


def separable_relation_bias(src_boxes, tgt_boxes, kernel, bias, embed_dim: int = 16,
                            temperature: float = 10000.0, scale: float = 100.0,
                            eps: float = 1e-5) -> torch.Tensor:
    """Relation bias (B, H, N1, N2) with per-box transcendentals for the wh
    coordinates (relation version 3): log((w1+eps)/(w2+eps)) = p_i - q_j, so
    their sine features factor by the angle-addition identities into a
    bilinear form per head; the xy coordinates pay per-pair sin/cos. No
    ratio clamp (the JAX package writes it in XLA)."""
    half = embed_dim // 2
    inv = scale / temperature ** (
        torch.arange(half, dtype=torch.float32, device=src_boxes.device) * 2.0 / embed_dim)
    xy1, wh1 = src_boxes[..., :2], src_boxes[..., 2:]
    xy2, wh2 = tgt_boxes[..., :2], tgt_boxes[..., 2:]
    num_heads = kernel.shape[1]
    delta_xy = torch.abs(xy1[..., :, None, :] - xy2[..., None, :, :])
    delta_xy = torch.log(delta_xy / (wh1[..., :, None, :] + eps) + 1.0)
    ang_xy = delta_xy[..., None] * inv  # (B, N1, N2, 2, half)
    pos_xy = torch.stack([torch.sin(ang_xy), torch.cos(ang_xy)], dim=-1).reshape(
        *delta_xy.shape[:-1], 2 * embed_dim)
    part_xy = torch.einsum("bijf,fh->bijh", pos_xy, kernel[:2 * embed_dim])
    p = torch.log(wh1 + eps)[..., None] * inv  # (B, N1, 2, half)
    q = torch.log(wh2 + eps)[..., None] * inv  # (B, N2, 2, half)
    sp, cp = torch.sin(p), torch.cos(p)
    sq, cq = torch.sin(q), torch.cos(q)
    w_wh = kernel[2 * embed_dim:].reshape(2, half, 2, num_heads)
    ws = w_wh[:, :, 0].permute(2, 0, 1)  # (H, 2, half)
    wc = w_wh[:, :, 1].permute(2, 0, 1)
    alpha = sp[..., None, :, :] * ws + cp[..., None, :, :] * wc  # (B, N1, H, 2, half)
    beta = sp[..., None, :, :] * wc - cp[..., None, :, :] * ws
    a_feats = torch.stack([alpha, beta], dim=-1).reshape(*alpha.shape[:2], num_heads,
                                                         2 * embed_dim)
    b_feats = torch.stack([cq, sq], dim=-1).reshape(*cq.shape[:2], 2 * embed_dim)
    part_wh = torch.einsum("bihf,bjf->bijh", a_feats, b_feats)
    return torch.relu(part_xy + part_wh + bias).permute(0, 3, 1, 2)


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
        # (4E, H) as a view of the (H, 4E, 1, 1) weight: the v4 kernel reads it in place
        kernel = conv.weight.reshape(self.num_heads, 4 * self.embed_dim).t()
        # the sine embedding carries no gradient: boxes are detached
        src, tgt = src_boxes.detach().contiguous(), tgt_boxes.detach().contiguous()
        settings = (self.embed_dim, self.temperature, self.scale)
        if src.device.type == "cuda":
            if not rb.fused_relation_enabled():  # the direct embedding
                pos = get_sine_pos_embed(box_rel_encoding(src, tgt), self.embed_dim,
                                         self.temperature, self.scale, exchange_xy=False)
                return torch.relu(pos @ kernel + conv.bias).permute(0, 3, 1, 2)
            if rb.fused_relation_version() == 3:
                return separable_relation_bias(src, tgt, kernel, conv.bias, *settings)
            if rb.fused_relation_version() in (1, 2):
                return rb.fused_relation_bias(box_rel_encoding(src, tgt), kernel.contiguous(),
                                              conv.bias, *settings)
        return rb.relation_bias_v4(src, tgt, kernel, conv.bias, *settings)
