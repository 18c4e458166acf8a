"""Relation-DETR transformer stack. Counterpart of
``relation_detr_tpu/models/transformer.py``.

The encoder with memory fusion, ``get_encoder_output``, the two-stage
top-k, and the decoder with the position-relation bias and
look-forward-twice box refinement. The decoder's MSDA projects the encoder
memory per layer and masks the padded rows (where the JAX package on TPU
shares one prepacked corner table across layers: pack and projection
commute, so both give the same values).

``train=True`` adds the train forward: the CDN queries go in front of the
matching queries with their attention bias (added to the relation bias of
every decoder layer, and alone at layer 0), and the hybrid branch takes its
own top-k proposals through a second decoder pass without relation bias.
Every ``stop_gradient`` of the JAX module is a ``.detach()`` at the same
place. The model-family switches (DINO++, Def-DETR++, DN++, DAB++) are
ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from relation_detr_tpu_torch.models import base_transformer as bt
from relation_detr_tpu_torch.models.attention import (
    MultiheadAttention,
    MultiScaleDeformableAttention,
)
from relation_detr_tpu_torch.models.layers import (
    LN_EPS,
    MLP,
    lecun_,
    prior_prob_bias,
    with_pos_embed,
    xavier_,
)
from relation_detr_tpu_torch.models.position_encoding import get_sine_pos_embed
from relation_detr_tpu_torch.models.relation import PositionRelationEmbedding
from relation_detr_tpu_torch.ops.boxes import inverse_sigmoid

def _init_class_head(layer: nn.Linear, generator: torch.Generator) -> None:
    lecun_(layer, generator)
    nn.init.constant_(layer.bias, prior_prob_bias(0.01))


class TransformerEncoderLayer(nn.Module):
    """MSDA self-attention + FFN, post-norm."""

    def __init__(self, embed_dim=256, d_ffn=2048, num_heads=8, num_levels=4, num_points=4):
        super().__init__()
        self.self_attn = MultiScaleDeformableAttention(embed_dim, num_levels, num_heads, num_points)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.linear1 = nn.Linear(embed_dim, d_ffn)
        self.linear2 = nn.Linear(d_ffn, embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def init_weights(self, generator: torch.Generator) -> None:
        xavier_(self.linear1, generator)
        xavier_(self.linear2, generator)

    def forward(self, query, query_pos, reference_points, spatial_shapes, key_padding_mask):
        attn = self.self_attn(
            with_pos_embed(query, query_pos), reference_points, query,
            spatial_shapes, key_padding_mask,
        )
        query = self.norm1(query + attn)
        ffn = self.linear2(torch.relu(self.linear1(query)))
        return self.norm2(query + ffn)


class RelationTransformerEncoder(nn.Module):
    """Encoder with memory fusion over all layer outputs."""

    def __init__(self, embed_dim=256, d_ffn=2048, num_heads=8, num_levels=4,
                 num_points=4, num_layers=6):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, d_ffn, num_heads, num_levels, num_points)
            for _ in range(num_layers)
        )
        self.memory_fusion = nn.Sequential(
            nn.Linear((num_layers + 1) * embed_dim, embed_dim),
            nn.ReLU(),
            nn.Linear(embed_dim, embed_dim),
            nn.LayerNorm(embed_dim, eps=LN_EPS),
        )

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_(self.memory_fusion[0], generator)
        lecun_(self.memory_fusion[2], generator)

    def forward(self, query, query_pos, reference_points, spatial_shapes, key_padding_mask):
        states = [query]
        for layer in self.layers:
            query = layer(query, query_pos, reference_points, spatial_shapes, key_padding_mask)
            states.append(query)
        return self.memory_fusion(torch.cat(states, dim=-1))


class TransformerDecoderLayer(nn.Module):
    """MHA self-attention with an additive bias + MSDA cross-attention + FFN."""

    def __init__(self, embed_dim=256, d_ffn=2048, num_heads=8, num_levels=4, num_points=4):
        super().__init__()
        self.self_attn = MultiheadAttention(embed_dim, num_heads)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.cross_attn = MultiScaleDeformableAttention(embed_dim, num_levels, num_heads, num_points)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.linear1 = nn.Linear(embed_dim, d_ffn)
        self.linear2 = nn.Linear(d_ffn, embed_dim)
        self.norm3 = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def init_weights(self, generator: torch.Generator) -> None:
        xavier_(self.linear1, generator)
        xavier_(self.linear2, generator)

    def forward(self, query, query_pos, reference_points, value, spatial_shapes,
                key_padding_mask, self_attn_bias: Optional[torch.Tensor]):
        q_with_pos = with_pos_embed(query, query_pos)
        attn = self.self_attn(q_with_pos, q_with_pos, query, self_attn_bias)
        query = self.norm2(query + attn)
        cross = self.cross_attn(
            with_pos_embed(query, query_pos), reference_points, value,
            spatial_shapes, key_padding_mask,
        )
        query = self.norm1(query + cross)
        ffn = self.linear2(torch.relu(self.linear1(query)))
        return self.norm3(query + ffn)


class RelationTransformerDecoder(nn.Module):
    """Decoder with iterative box refinement, look-forward-twice and the
    position-relation bias between consecutive layers' boxes."""

    def __init__(self, num_classes, embed_dim=256, d_ffn=2048, num_heads=8,
                 num_levels=4, num_points=4, num_layers=6):
        super().__init__()
        self.embed_dim = embed_dim
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(embed_dim, d_ffn, num_heads, num_levels, num_points)
            for _ in range(num_layers)
        )
        self.ref_point_head = MLP(2 * embed_dim, embed_dim, embed_dim, 2)
        self.query_scale = MLP(embed_dim, embed_dim, embed_dim, 2)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.class_head = nn.ModuleList(
            nn.Linear(embed_dim, num_classes) for _ in range(num_layers)
        )
        self.bbox_head = nn.ModuleList(
            MLP(embed_dim, embed_dim, 4, 3, zero_last=True) for _ in range(num_layers)
        )
        self.position_relation_embedding = PositionRelationEmbedding(16, num_heads)

    def init_weights(self, generator: torch.Generator) -> None:
        for head in self.class_head:
            _init_class_head(head, generator)

    def forward(self, query, reference_points, value, spatial_shapes, valid_ratios,
                key_padding_mask, attn_bias: Optional[torch.Tensor] = None,
                skip_relation: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``attn_bias`` (1, 1, Q, Q): the CDN mask, -1e9 where blocked;
        ``skip_relation``: no relation bias (the hybrid pass)."""
        valid_ratio_scale = torch.cat([valid_ratios, valid_ratios], -1)[:, None]  # (B,1,L,4)
        outputs_classes, outputs_coords = [], []
        pos_relation = attn_bias  # the layer-0 bias (relation_transformer.py:335)
        tgt_boxes = None
        last = len(self.layers) - 1
        for layer_idx, layer in enumerate(self.layers):
            ref_input = reference_points.detach()[:, :, None] * valid_ratio_scale
            query_sine = get_sine_pos_embed(ref_input[:, :, 0, :], self.embed_dim // 2)
            query_pos = self.ref_point_head(query_sine)
            if layer_idx != 0:
                query_pos = query_pos * self.query_scale(query)
            query = layer(query, query_pos, ref_input, value, spatial_shapes,
                          key_padding_mask, pos_relation)

            normed = self.norm(query)
            bbox_head = self.bbox_head[layer_idx]
            outputs_classes.append(self.class_head[layer_idx](normed))
            # look-forward-twice: reference_points not detached here
            output_coord = torch.sigmoid(bbox_head(normed) + inverse_sigmoid(reference_points))
            outputs_coords.append(output_coord)
            if layer_idx == last:
                break
            if not skip_relation:
                src_boxes = tgt_boxes if layer_idx >= 1 else reference_points
                tgt_boxes = output_coord
                pos_relation = self.position_relation_embedding(src_boxes, tgt_boxes)
                if attn_bias is not None:
                    pos_relation = pos_relation + attn_bias  # blocked pairs stay blocked
            # refinement on detached references, from the un-normed query
            reference_points = torch.sigmoid(
                bbox_head(query) + inverse_sigmoid(reference_points.detach())
            )
        return torch.stack(outputs_classes), torch.stack(outputs_coords)


class RelationTransformer(nn.Module):
    """Two-stage Relation-DETR transformer with the hybrid branch."""

    def __init__(self, num_classes, embed_dim=256, d_ffn=2048, num_heads=8,
                 num_feature_levels=4, num_points=4, num_encoder_layers=6,
                 num_decoder_layers=6, two_stage_num_proposals=900,
                 hybrid_num_proposals=1500):
        super().__init__()
        self.num_classes = num_classes
        self.two_stage_num_proposals = two_stage_num_proposals
        self.encoder = RelationTransformerEncoder(
            embed_dim, d_ffn, num_heads, num_feature_levels, num_points, num_encoder_layers
        )
        self.decoder = RelationTransformerDecoder(
            num_classes, embed_dim, d_ffn, num_heads, num_feature_levels, num_points,
            num_decoder_layers,
        )
        self.level_embeds = nn.Parameter(torch.empty(num_feature_levels, embed_dim))
        self.enc_output = nn.Linear(embed_dim, embed_dim)
        self.enc_output_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.encoder_class_head = nn.Linear(embed_dim, num_classes)
        self.encoder_bbox_head = MLP(embed_dim, embed_dim, 4, 3, zero_last=True)
        self.tgt_embed = nn.Embedding(two_stage_num_proposals, embed_dim)
        self.hybrid_num_proposals = hybrid_num_proposals
        if hybrid_num_proposals > 0:
            self.hybrid_tgt_embed = nn.Embedding(hybrid_num_proposals, embed_dim)
            self.hybrid_class_head = nn.Linear(embed_dim, num_classes)
            self.hybrid_bbox_head = MLP(embed_dim, embed_dim, 4, 3, zero_last=True)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.level_embeds, generator=generator)
        nn.init.normal_(self.tgt_embed.weight, generator=generator)
        xavier_(self.enc_output, generator)
        _init_class_head(self.encoder_class_head, generator)
        if self.hybrid_num_proposals > 0:
            nn.init.normal_(self.hybrid_tgt_embed.weight, generator=generator)
            _init_class_head(self.hybrid_class_head, generator)

    def get_encoder_output(self, memory, proposals, memory_padding_mask):
        """Mask invalid proposals, inverse-sigmoid them, project memory."""
        valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1, keepdim=True)
        p = proposals.clamp(1e-7, 1.0 - 1e-7)
        proposals_logit = torch.log(p / (1.0 - p))
        invalid = memory_padding_mask[..., None] | ~valid
        proposals_logit = proposals_logit.masked_fill(invalid, float("inf"))
        output_memory = memory * (~memory_padding_mask[..., None]) * valid
        return self.enc_output_norm(self.enc_output(output_memory)), proposals_logit

    @staticmethod
    def _select_topk(class_logits, coords, k):
        """Top-k proposals by max class logit -> (class, coord, index)."""
        topk_index = torch.topk(class_logits.max(-1)[0], k, dim=1)[1]  # (B, k)
        topk_class = torch.gather(
            class_logits, 1, topk_index[..., None].expand(-1, -1, class_logits.shape[-1])
        )
        topk_coord = torch.gather(coords, 1, topk_index[..., None].expand(-1, -1, 4))
        return topk_class, topk_coord, topk_index

    def forward(
        self,
        multi_level_feats: Sequence[torch.Tensor],  # (B, H, W, C) per level
        multi_level_masks: Sequence[torch.Tensor],  # (B, H, W) True = pad
        multi_level_pos_embeds: Sequence[torch.Tensor],  # (B, H, W, C) per level
        noised_label_query: Optional[torch.Tensor] = None,  # (B, Qdn, C)
        noised_box_query: Optional[torch.Tensor] = None,  # (B, Qdn, 4) logit space
        attn_bias: Optional[torch.Tensor] = None,  # (1, 1, Qdn + Q, Qdn + Q)
        train: bool = False,
    ):
        """Returns (classes, coords) of every decoder layer over the CDN and
        matching queries, the encoder top-k (class, coord), and with
        ``train`` the hybrid pass's (classes, coords) and its encoder top-k
        (class, coord); None for what is not computed."""
        spatial_shapes = bt.get_spatial_shapes(multi_level_masks)
        feat_flatten = bt.flatten_multi_level(multi_level_feats)
        mask_flatten = bt.flatten_multi_level(multi_level_masks)
        lvl_pos_flatten = bt.flatten_multi_level([
            p + self.level_embeds[i] for i, p in enumerate(multi_level_pos_embeds)
        ])
        valid_ratios = bt.multi_level_valid_ratios(multi_level_masks)
        reference_points, proposals = bt.get_reference(spatial_shapes, valid_ratios)

        memory = self.encoder(
            feat_flatten, lvl_pos_flatten, reference_points, spatial_shapes, mask_flatten
        )
        output_memory, output_proposals = self.get_encoder_output(
            memory, proposals, mask_flatten
        )
        enc_class = self.encoder_class_head(output_memory)
        enc_coord = torch.sigmoid(self.encoder_bbox_head(output_memory) + output_proposals)
        enc_class, enc_coord, _ = self._select_topk(
            enc_class, enc_coord, self.two_stage_num_proposals
        )
        bs = feat_flatten.shape[0]
        target = self.tgt_embed.weight[None].expand(bs, -1, -1)
        reference = enc_coord.detach()
        hybrid = train and self.hybrid_num_proposals > 0
        if hybrid:
            hybrid_enc_class = self.hybrid_class_head(output_memory)
            hybrid_enc_coord = torch.sigmoid(
                self.hybrid_bbox_head(output_memory) + output_proposals
            )
            hybrid_enc_class, hybrid_enc_coord, _ = self._select_topk(
                hybrid_enc_class, hybrid_enc_coord, self.hybrid_num_proposals
            )
        if noised_label_query is not None and noised_box_query is not None:
            target = torch.cat([noised_label_query, target], dim=1)
            reference = torch.cat([torch.sigmoid(noised_box_query), reference], dim=1)

        outputs_classes, outputs_coords = self.decoder(
            target, reference, memory, spatial_shapes, valid_ratios, mask_flatten,
            attn_bias=attn_bias,
        )
        if not hybrid:
            return outputs_classes, outputs_coords, enc_class, enc_coord, None, None, None, None
        hybrid_target = self.hybrid_tgt_embed.weight[None].expand(bs, -1, -1)
        hybrid_classes, hybrid_coords = self.decoder(
            hybrid_target, hybrid_enc_coord.detach(), memory, spatial_shapes, valid_ratios,
            mask_flatten, skip_relation=True,
        )
        return (outputs_classes, outputs_coords, enc_class, enc_coord,
                hybrid_classes, hybrid_coords, hybrid_enc_class, hybrid_enc_coord)
