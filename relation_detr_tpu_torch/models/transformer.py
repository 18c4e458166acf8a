"""Relation-DETR transformer stack. Counterpart of
``relation_detr_tpu/models/transformer.py``.

The encoder (with memory fusion unless ``encoder_memory_fusion`` is off),
``get_encoder_output``, the two-stage top-k, and the decoder with the
position-relation bias (unless ``decoder_use_relation`` is off) and
look-forward-twice box refinement. The decoder's MSDA projects the encoder
memory per layer and masks the padded rows (where the JAX package on TPU
shares one prepacked corner table across layers: pack and projection
commute, so both give the same values).

``train=True`` adds the train forward: the denoising queries go in front
of the matching queries with their attention bias (added to the relation
bias of every decoder layer, and alone at layer 0), and the hybrid branch
takes its own top-k proposals through a second decoder pass without
relation bias.
Every ``stop_gradient`` of the JAX module is a ``.detach()`` at the same
place.

The model families' switches are the JAX module's fields. ``query_source``
"tgt_embed" (Relation-DETR, DINO++, Def-DETR++) takes learned content
queries and the two-stage boxes; "memory" (DAB-Def-DETR++) takes the
selected rows of the projected encoder memory, detached, as content;
"learned_anchor" (DN-Def-DETR++) is single-stage: a zero-initialised
``tgt_embed`` (one channel narrower with ``learned_query_indicator``, a zero
indicator column appended) and a learned ``refpoint_embed`` of anchors,
with no encoder heads and no encoder outputs. ``dropout`` applies after
each attention, after the FFN's ReLU and after the FFN, in train forwards
given a ``dropout_seed``: each layer draws its masks from a generator
seeded from it (``layers.dropout_generator``), so a recompute draws them
again.

Under a compute dtype (set on the encoder and decoder layers and the memory
fusion, ``detector.py``) each layer's projections return it and every
residual add promotes back to fp32 (``query + attn``: fp32 + bf16, as in
JAX), so LayerNorms, heads, ``ref_point_head``, ``query_scale``,
``enc_output`` and the relation embedding stay fp32.

``remat_policy`` (``resolve_remat_policy``) recomputes each encoder and
decoder layer in the backward with ``torch.utils.checkpoint``. Unset, the
port recomputes nothing (where the JAX package's default is full
rematerialisation, for a 16 GB chip).
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from relation_detr_tpu_torch.models import base_transformer as bt
from relation_detr_tpu_torch.models.attention import (
    MultiheadAttention,
    MultiScaleDeformableAttention,
)
from relation_detr_tpu_torch.models.layers import (
    LN_EPS,
    MLP,
    Linear,
    dropout,
    dropout_generator,
    lecun_,
    prior_prob_bias,
    with_pos_embed,
    xavier_,
)
from relation_detr_tpu_torch.models.position_encoding import get_sine_pos_embed
from relation_detr_tpu_torch.models.relation import PositionRelationEmbedding
from relation_detr_tpu_torch.ops.boxes import inverse_sigmoid

# matmul outputs saved by a policy (JAX's dots_saveable saves every dot,
# checkpoint_dots_with_no_batch_dims the unbatched ones)
_SAVED_PRODUCTS = {
    "dots": ("mm", "addmm", "bmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def _call(layer: nn.Module, *args):
    return layer(*args)


def _save_products(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(context_fn, layer: nn.Module, *args):
    if not torch.is_grad_enabled():
        return layer(*args)
    return checkpoint(layer, *args, use_reentrant=False, context_fn=context_fn)


def resolve_remat_policy(name: Optional[str]) -> Callable:
    """``run(layer, *args)`` under rematerialisation policy ``name`` (JAX
    ``transformer.py:42-64``): "none" recomputes the whole layer in the
    backward; "dots" saves the ``mm`` / ``addmm`` / ``bmm`` outputs and
    recomputes the rest; "dots_no_batch" saves ``mm`` / ``addmm`` only;
    "save_all" and None (the port's default) recompute nothing. The MSDA
    kernels run in an autograd Function, no aten product: every policy
    but save_all launches ``msda_fwd`` again in the backward, as JAX's
    dots recomputes its gather."""
    if name in (None, "save_all"):
        return _call
    if name == "none":
        return functools.partial(_checkpointed, noop_context_fn)
    if name not in _SAVED_PRODUCTS:
        raise ValueError(f"unknown remat policy {name!r}; use none|dots|dots_no_batch|save_all")
    saved = frozenset(getattr(torch.ops.aten, n) for n in _SAVED_PRODUCTS[name])
    policy = functools.partial(_save_products, saved)
    return functools.partial(
        _checkpointed, functools.partial(create_selective_checkpoint_contexts, policy))


def _init_class_head(layer: nn.Linear, generator: torch.Generator) -> None:
    lecun_(layer, generator)
    nn.init.constant_(layer.bias, prior_prob_bias(0.01))


def split_seed(seed: Optional[int], n: int) -> List[Optional[int]]:
    """``n`` seeds drawn on the host from ``seed`` (None: n Nones)."""
    if seed is None:
        return [None] * n
    return torch.randint(0, 2**62, (n,), generator=torch.Generator().manual_seed(seed)).tolist()


class TransformerEncoderLayer(nn.Module):
    """MSDA self-attention + FFN, post-norm."""

    def __init__(self, embed_dim=256, d_ffn=2048, num_heads=8, num_levels=4, num_points=4,
                 dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiScaleDeformableAttention(embed_dim, num_levels, num_heads, num_points)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.linear1 = Linear(embed_dim, d_ffn)
        self.linear2 = Linear(d_ffn, embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def init_weights(self, generator: torch.Generator) -> None:
        xavier_(self.linear1, generator)
        xavier_(self.linear2, generator)

    def forward(self, query, query_pos, reference_points, spatial_shapes, key_padding_mask,
                dropout_seed: Optional[int] = None):
        gen = dropout_generator(dropout_seed, self.dropout, query.device)
        attn = self.self_attn(
            with_pos_embed(query, query_pos), reference_points, query,
            spatial_shapes, key_padding_mask,
        )
        query = self.norm1(query + dropout(attn, self.dropout, gen))
        ffn = self.linear2(dropout(torch.relu(self.linear1(query)), self.dropout, gen))
        return self.norm2(query + dropout(ffn, self.dropout, gen))


class RelationTransformerEncoder(nn.Module):
    """Encoder with memory fusion over all layer outputs; without it
    (``memory_fusion=False``, the plain DINO encoder) the last layer's output
    and no ``memory_fusion`` parameters."""

    def __init__(self, embed_dim=256, d_ffn=2048, num_heads=8, num_levels=4,
                 num_points=4, num_layers=6, remat_policy: Optional[str] = None,
                 memory_fusion: bool = True, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, d_ffn, num_heads, num_levels, num_points, dropout)
            for _ in range(num_layers)
        )
        self.memory_fusion = nn.Sequential(
            Linear((num_layers + 1) * embed_dim, embed_dim),
            nn.ReLU(),
            Linear(embed_dim, embed_dim),
            nn.LayerNorm(embed_dim, eps=LN_EPS),
        ) if memory_fusion else None
        self.run_layer = resolve_remat_policy(remat_policy)

    def init_weights(self, generator: torch.Generator) -> None:
        if self.memory_fusion is not None:
            lecun_(self.memory_fusion[0], generator)
            lecun_(self.memory_fusion[2], generator)

    def forward(self, query, query_pos, reference_points, spatial_shapes, key_padding_mask,
                dropout_seed: Optional[int] = None):
        states = [query]  # every layer's output, for the memory fusion
        for layer, seed in zip(self.layers, split_seed(dropout_seed, len(self.layers))):
            query = self.run_layer(layer, query, query_pos, reference_points, spatial_shapes,
                                   key_padding_mask, seed)
            if self.memory_fusion is not None:
                states.append(query)
        if self.memory_fusion is None:
            return query
        fc0, relu, fc1, norm = self.memory_fusion
        # the LayerNorm takes the fusion's compute-dtype output as fp32 (flax
        # promotes it against its fp32 parameters)
        return norm(fc1(relu(fc0(torch.cat(states, dim=-1)))).float())


class TransformerDecoderLayer(nn.Module):
    """MHA self-attention with an additive bias + MSDA cross-attention + FFN."""

    def __init__(self, embed_dim=256, d_ffn=2048, num_heads=8, num_levels=4, num_points=4,
                 dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(embed_dim, num_heads)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.cross_attn = MultiScaleDeformableAttention(embed_dim, num_levels, num_heads, num_points)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.linear1 = Linear(embed_dim, d_ffn)
        self.linear2 = Linear(d_ffn, embed_dim)
        self.norm3 = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def init_weights(self, generator: torch.Generator) -> None:
        xavier_(self.linear1, generator)
        xavier_(self.linear2, generator)

    def forward(self, query, query_pos, reference_points, value, spatial_shapes,
                key_padding_mask, self_attn_bias: Optional[torch.Tensor],
                dropout_seed: Optional[int] = None):
        gen = dropout_generator(dropout_seed, self.dropout, query.device)
        q_with_pos = with_pos_embed(query, query_pos)
        attn = self.self_attn(q_with_pos, q_with_pos, query, self_attn_bias)
        query = self.norm2(query + dropout(attn, self.dropout, gen))
        cross = self.cross_attn(
            with_pos_embed(query, query_pos), reference_points, value,
            spatial_shapes, key_padding_mask,
        )
        query = self.norm1(query + dropout(cross, self.dropout, gen))
        ffn = self.linear2(dropout(torch.relu(self.linear1(query)), self.dropout, gen))
        return self.norm3(query + dropout(ffn, self.dropout, gen))


class RelationTransformerDecoder(nn.Module):
    """Decoder with iterative box refinement, look-forward-twice and, with
    ``use_relation``, the position-relation bias between consecutive layers'
    boxes (without it every layer takes ``attn_bias`` alone)."""

    def __init__(self, num_classes, embed_dim=256, d_ffn=2048, num_heads=8,
                 num_levels=4, num_points=4, num_layers=6, remat_policy: Optional[str] = None,
                 use_relation: bool = True, dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.run_layer = resolve_remat_policy(remat_policy)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(embed_dim, d_ffn, num_heads, num_levels, num_points, dropout)
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
        self.position_relation_embedding = (
            PositionRelationEmbedding(16, num_heads) if use_relation else None)

    def init_weights(self, generator: torch.Generator) -> None:
        for head in self.class_head:
            _init_class_head(head, generator)

    def forward(self, query, reference_points, value, spatial_shapes, valid_ratios,
                key_padding_mask, attn_bias: Optional[torch.Tensor] = None,
                skip_relation: bool = False, dropout_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``attn_bias`` (1, 1, Q, Q): the denoising mask, -1e9 where blocked;
        ``skip_relation``: no relation bias (the hybrid pass)."""
        valid_ratio_scale = torch.cat([valid_ratios, valid_ratios], -1)[:, None]  # (B,1,L,4)
        outputs_classes, outputs_coords = [], []
        pos_relation = attn_bias  # the layer-0 bias (relation_transformer.py:335)
        tgt_boxes = None
        last = len(self.layers) - 1
        seeds = split_seed(dropout_seed, len(self.layers))
        for layer_idx, layer in enumerate(self.layers):
            ref_input = reference_points.detach()[:, :, None] * valid_ratio_scale
            query_sine = get_sine_pos_embed(ref_input[:, :, 0, :], self.embed_dim // 2)
            query_pos = self.ref_point_head(query_sine)
            if layer_idx != 0:
                query_pos = query_pos * self.query_scale(query)
            query = self.run_layer(layer, query, query_pos, ref_input, value, spatial_shapes,
                                   key_padding_mask, pos_relation, seeds[layer_idx])

            normed = self.norm(query)
            bbox_head = self.bbox_head[layer_idx]
            outputs_classes.append(self.class_head[layer_idx](normed))
            # look-forward-twice: reference_points not detached here
            output_coord = torch.sigmoid(bbox_head(normed) + inverse_sigmoid(reference_points))
            outputs_coords.append(output_coord)
            if layer_idx == last:
                break
            if self.position_relation_embedding is not None and not skip_relation:
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
    """The two-stage Relation-DETR transformer with the hybrid branch, and
    the model families' forms of it (see the module docstring)."""

    QUERY_SOURCES = ("tgt_embed", "memory", "learned_anchor")

    def __init__(self, num_classes, embed_dim=256, d_ffn=2048, num_heads=8,
                 num_feature_levels=4, num_points=4, num_encoder_layers=6,
                 num_decoder_layers=6, two_stage_num_proposals=900,
                 hybrid_num_proposals=1500, remat_policy: Optional[str] = None,
                 encoder_memory_fusion: bool = True, decoder_use_relation: bool = True,
                 dropout: float = 0.0, query_source: str = "tgt_embed",
                 learned_query_indicator: bool = False):
        super().__init__()
        if query_source not in self.QUERY_SOURCES:
            raise ValueError(f"unknown query_source {query_source!r}; use "
                             + "|".join(self.QUERY_SOURCES))
        self.two_stage = query_source != "learned_anchor"
        if hybrid_num_proposals > 0 and not self.two_stage:
            raise ValueError("the hybrid branch takes two-stage proposals; "
                             "query_source 'learned_anchor' has none")
        self.num_classes = num_classes
        self.two_stage_num_proposals = two_stage_num_proposals
        self.query_source = query_source
        self.learned_query_indicator = learned_query_indicator
        self.encoder = RelationTransformerEncoder(
            embed_dim, d_ffn, num_heads, num_feature_levels, num_points, num_encoder_layers,
            remat_policy, encoder_memory_fusion, dropout,
        )
        self.decoder = RelationTransformerDecoder(
            num_classes, embed_dim, d_ffn, num_heads, num_feature_levels, num_points,
            num_decoder_layers, remat_policy, decoder_use_relation, dropout,
        )
        self.level_embeds = nn.Parameter(torch.empty(num_feature_levels, embed_dim))
        if self.two_stage:
            self.enc_output = nn.Linear(embed_dim, embed_dim)
            self.enc_output_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
            self.encoder_class_head = nn.Linear(embed_dim, num_classes)
            self.encoder_bbox_head = MLP(embed_dim, embed_dim, 4, 3, zero_last=True)
        if query_source == "tgt_embed":
            self.tgt_embed = nn.Embedding(two_stage_num_proposals, embed_dim)
        elif query_source == "learned_anchor":
            self.tgt_embed = nn.Embedding(two_stage_num_proposals,
                                          embed_dim - int(learned_query_indicator))
            self.refpoint_embed = nn.Embedding(two_stage_num_proposals, 4)
        self.hybrid_num_proposals = hybrid_num_proposals
        if hybrid_num_proposals > 0:
            self.hybrid_tgt_embed = nn.Embedding(hybrid_num_proposals, embed_dim)
            self.hybrid_class_head = nn.Linear(embed_dim, num_classes)
            self.hybrid_bbox_head = MLP(embed_dim, embed_dim, 4, 3, zero_last=True)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.level_embeds, generator=generator)
        if self.query_source == "tgt_embed":
            nn.init.normal_(self.tgt_embed.weight, generator=generator)
        if self.two_stage:
            xavier_(self.enc_output, generator)
            _init_class_head(self.encoder_class_head, generator)
        if self.query_source == "learned_anchor":
            # zero content queries, anchors uniform -> clamped logit (JAX :431-445)
            nn.init.zeros_(self.tgt_embed.weight)
            with torch.no_grad():
                anchors = torch.rand(self.refpoint_embed.weight.shape, generator=generator)
                self.refpoint_embed.weight.copy_(inverse_sigmoid(anchors).clamp(-3.0, 3.0))
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

    def _queries(self, memory, proposals, mask_flatten, hybrid: bool):
        """(content queries, reference boxes, encoder top-k class and box or
        None, the hybrid pass's queries, boxes and encoder top-k or None)."""
        bs = memory.shape[0]
        if not self.two_stage:  # DN: learned queries and anchors (JAX :549-562)
            tgt = self.tgt_embed.weight
            if self.learned_query_indicator:
                tgt = torch.cat([tgt, tgt.new_zeros(tgt.shape[0], 1)], -1)
            reference = torch.sigmoid(self.refpoint_embed.weight)[None].expand(bs, -1, -1)
            return tgt[None].expand(bs, -1, -1), reference, None, None, None
        output_memory, output_proposals = self.get_encoder_output(memory, proposals, mask_flatten)
        enc_class = self.encoder_class_head(output_memory)
        enc_coord = torch.sigmoid(self.encoder_bbox_head(output_memory) + output_proposals)
        enc_class, enc_coord, topk_index = self._select_topk(
            enc_class, enc_coord, self.two_stage_num_proposals
        )
        if self.query_source == "memory":  # DAB: the selected memory rows, detached
            target = torch.gather(output_memory, 1, topk_index[..., None].expand(
                -1, -1, output_memory.shape[-1])).detach()
        else:
            target = self.tgt_embed.weight[None].expand(bs, -1, -1)
        hybrid_pass = None
        if hybrid:
            hybrid_enc_class = self.hybrid_class_head(output_memory)
            hybrid_enc_coord = torch.sigmoid(
                self.hybrid_bbox_head(output_memory) + output_proposals
            )
            hybrid_enc_class, hybrid_enc_coord, _ = self._select_topk(
                hybrid_enc_class, hybrid_enc_coord, self.hybrid_num_proposals
            )
            hybrid_pass = (self.hybrid_tgt_embed.weight[None].expand(bs, -1, -1),
                           hybrid_enc_coord.detach(), hybrid_enc_class, hybrid_enc_coord)
        return target, enc_coord.detach(), enc_class, enc_coord, hybrid_pass

    def forward(
        self,
        multi_level_feats: Sequence[torch.Tensor],  # (B, H, W, C) per level
        multi_level_masks: Sequence[torch.Tensor],  # (B, H, W) True = pad
        multi_level_pos_embeds: Sequence[torch.Tensor],  # (B, H, W, C) per level
        noised_label_query: Optional[torch.Tensor] = None,  # (B, Qdn, C)
        noised_box_query: Optional[torch.Tensor] = None,  # (B, Qdn, 4) logit space
        attn_bias: Optional[torch.Tensor] = None,  # (1, 1, Qdn + Q, Qdn + Q)
        train: bool = False,
        dropout_seed: Optional[int] = None,
    ):
        """Returns (classes, coords) of every decoder layer over the
        denoising and matching queries, the encoder top-k (class, coord),
        and with ``train`` the hybrid pass's (classes, coords) and its
        encoder top-k (class, coord); None for what is not computed (the
        encoder top-k of a single-stage model). ``dropout_seed`` seeds the
        layers' dropout masks when ``train``."""
        spatial_shapes = bt.get_spatial_shapes(multi_level_masks)
        feat_flatten = bt.flatten_multi_level(multi_level_feats)
        mask_flatten = bt.flatten_multi_level(multi_level_masks)
        lvl_pos_flatten = bt.flatten_multi_level([
            p + self.level_embeds[i] for i, p in enumerate(multi_level_pos_embeds)
        ])
        valid_ratios = bt.multi_level_valid_ratios(multi_level_masks)
        reference_points, proposals = bt.get_reference(spatial_shapes, valid_ratios)
        seeds = split_seed(dropout_seed if train else None, 3)

        memory = self.encoder(
            feat_flatten, lvl_pos_flatten, reference_points, spatial_shapes, mask_flatten,
            seeds[0],
        )
        hybrid = train and self.hybrid_num_proposals > 0
        target, reference, enc_class, enc_coord, hybrid_pass = self._queries(
            memory, proposals, mask_flatten, hybrid)
        if noised_label_query is not None and noised_box_query is not None:
            target = torch.cat([noised_label_query, target], dim=1)
            reference = torch.cat([torch.sigmoid(noised_box_query), reference], dim=1)

        outputs_classes, outputs_coords = self.decoder(
            target, reference, memory, spatial_shapes, valid_ratios, mask_flatten,
            attn_bias=attn_bias, dropout_seed=seeds[1],
        )
        if hybrid_pass is None:
            return outputs_classes, outputs_coords, enc_class, enc_coord, None, None, None, None
        hybrid_target, hybrid_reference, hybrid_enc_class, hybrid_enc_coord = hybrid_pass
        hybrid_classes, hybrid_coords = self.decoder(
            hybrid_target, hybrid_reference, memory, spatial_shapes, valid_ratios,
            mask_flatten, skip_relation=True, dropout_seed=seeds[2],
        )
        return (outputs_classes, outputs_coords, enc_class, enc_coord,
                hybrid_classes, hybrid_coords, hybrid_enc_class, hybrid_enc_coord)
