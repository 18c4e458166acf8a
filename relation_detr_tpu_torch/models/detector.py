"""Relation-DETR detector. Counterpart of
``relation_detr_tpu/models/detector.py``.

As in the JAX package, resizing, normalising and padding to the canvas happen
on the host; the model takes a (B, H, W, 3) canvas and a (B, H, W) padding
mask (True = padding) and returns the raw heads; ``post_process`` decodes
them and ``losses.criterion.relation_detr_loss`` scores the train forward.

The precision policy is the JAX module's two fields (``detector.py:70-80``,
the reference's ``--mixed-precision bf16``): ``backbone_dtype`` runs a ResNet
backbone's convolutions in that dtype (its DCN convs and the Swin,
ConvNeXt, FocalNet, ViT and EVA-02 backbones stay fp32, as in JAX),
``compute_dtype`` the encoder and
decoder layers' projections (MHA, MSDA, FFN) and the memory fusion. The
neck, every LayerNorm, the heads, the relation embedding, the MSDA
sampling arithmetic and softmaxes, the denoising generator and the loss
stay fp32; parameters are fp32 either way (the same state_dict).

The model-family switches are the JAX module's fields too
(``detector.py:64-69``): ``with_hybrid`` (off: no hybrid branch),
``denoising`` ("cdn", "dn" with ``dn_groups``, or None), ``query_source``,
``encoder_memory_fusion``, ``decoder_use_relation`` and ``dropout``. As in
JAX, the transformer runs its train form (the hybrid pass and dropout)
only with ``with_hybrid``: a family without the hybrid branch trains
without dropout, whatever ``dropout`` says.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from relation_detr_tpu_torch.models.backbones import ResNetBackbone, build_backbone
from relation_detr_tpu_torch.models.denoising import GenerateCDNQueries, GenerateDNQueries
from relation_detr_tpu_torch.models.layers import init_weights, resolve_dtype, set_compute_dtype
from relation_detr_tpu_torch.models.neck import ChannelMapper
from relation_detr_tpu_torch.models.position_encoding import position_embedding_sine
from relation_detr_tpu_torch.models.transformer import RelationTransformer


def downsample_mask(mask: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour mask downsample (F.interpolate(mode='nearest'))."""
    _, in_h, in_w = mask.shape
    out_h, out_w = out_hw
    rows = torch.arange(out_h, device=mask.device) * in_h // out_h
    cols = torch.arange(out_w, device=mask.device) * in_w // out_w
    return mask[:, rows][:, :, cols]


class RelationDETR(nn.Module):
    """Backbone -> neck -> transformer. Constructor arguments are the JAX
    module's fields (``backbone_stage_with_dcn``: the DCN ResNet's stage
    flags; ``backbone_dtype`` / ``compute_dtype``: None or
    "bfloat16"; ``remat_policy``: see ``transformer.resolve_remat_policy``;
    the family switches: see the module docstring);
    ``generator`` seeds the initialisation (the model is built on CPU; move
    it with ``.to(device)``)."""

    def __init__(
        self,
        num_classes: int,
        embed_dim: int = 256,
        num_queries: int = 900,
        hybrid_num_proposals: int = 1500,
        hybrid_assign: int = 6,
        denoising_nums: int = 100,
        num_feature_levels: int = 4,
        num_heads: int = 8,
        dim_feedforward: int = 2048,
        transformer_enc_layers: int = 6,
        transformer_dec_layers: int = 6,
        backbone_arch: str = "resnet50",
        backbone_stage_with_dcn: Optional[Tuple[bool, bool, bool, bool]] = None,
        encoder_memory_fusion: bool = True,
        decoder_use_relation: bool = True,
        with_hybrid: bool = True,
        denoising: Optional[str] = "cdn",
        dn_groups: int = 5,
        query_source: str = "tgt_embed",
        dropout: float = 0.0,
        backbone_dtype: Optional[str] = None,
        compute_dtype: Optional[str] = None,
        remat_policy: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_queries = num_queries
        self.hybrid_assign = hybrid_assign
        self.denoising_nums = denoising_nums
        self.with_hybrid = with_hybrid
        self.dropout = dropout
        self.backbone = build_backbone(backbone_arch, backbone_stage_with_dcn)
        self.neck = ChannelMapper(self.backbone.num_channels, embed_dim, num_feature_levels)
        self.transformer = RelationTransformer(
            num_classes=num_classes,
            embed_dim=embed_dim,
            d_ffn=dim_feedforward,
            num_heads=num_heads,
            num_feature_levels=num_feature_levels,
            num_encoder_layers=transformer_enc_layers,
            num_decoder_layers=transformer_dec_layers,
            two_stage_num_proposals=num_queries,
            hybrid_num_proposals=hybrid_num_proposals if with_hybrid else 0,
            remat_policy=remat_policy,
            encoder_memory_fusion=encoder_memory_fusion,
            decoder_use_relation=decoder_use_relation,
            dropout=dropout,
            query_source=query_source,
            learned_query_indicator=denoising == "dn",
        )
        if denoising == "cdn":
            self.denoising_generator = GenerateCDNQueries(num_classes, embed_dim, denoising_nums)
        elif denoising == "dn":
            self.denoising_generator = GenerateDNQueries(num_classes, embed_dim, dn_groups)
        elif denoising is None:
            self.denoising_generator = None
        else:
            raise ValueError(f"unknown denoising {denoising!r}; use cdn|dn|None")
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        # the bf16 islands: the JAX modules built with dtype=compute dtype.
        # The JAX package gives the backbone dtype to the ResNet only: Swin,
        # ConvNeXt, FocalNet, ViT and EVA-02 stay fp32 under the bf16 policy,
        # and so does the DCN (its convs are plain nn.Conv2d, not set here).
        if isinstance(self.backbone, ResNetBackbone):
            set_compute_dtype(self.backbone, resolve_dtype(backbone_dtype))
        encoder, decoder = self.transformer.encoder, self.transformer.decoder
        for island in (encoder.layers, encoder.memory_fusion, decoder.layers):
            if island is not None:
                set_compute_dtype(island, resolve_dtype(compute_dtype))

    def forward(
        self,
        images: torch.Tensor,  # (B, H, W, 3) normalised float
        mask: torch.Tensor,  # (B, H, W) bool, True = padding
        gt_labels: Optional[torch.Tensor] = None,  # (B, G) int, padded
        gt_boxes: Optional[torch.Tensor] = None,  # (B, G, 4) normalised cxcywh
        gt_valid: Optional[torch.Tensor] = None,  # (B, G) bool
        train: bool = False,
        generator: Optional[torch.Generator] = None,  # denoising draws (train)
        noise_draws: Optional[Dict[str, torch.Tensor]] = None,  # injected denoising draws
        dropout_seed: Optional[int] = None,  # dropout masks (train)
    ) -> Dict[str, object]:
        """The JAX module's output dict: ``pred_logits``/``pred_boxes`` of the
        last decoder layer, ``aux_outputs`` (the others, stacked) and, when
        two-stage, ``enc_outputs``; with ``train`` also
        ``dn_outputs``/``dn_meta`` (the denoising slots, split off at
        ``dn_cap``) and, with the hybrid branch, ``hybrid_outputs`` (with
        its own ``aux_outputs`` and ``enc_outputs``). ``dropout_seed`` seeds
        the transformer's dropout (None: drawn from torch's default
        generator on the host)."""
        feats = self.backbone(images.permute(0, 3, 1, 2))
        multi_level_feats = [f.permute(0, 2, 3, 1) for f in self.neck(feats)]
        multi_level_masks = [downsample_mask(mask, f.shape[1:3]) for f in multi_level_feats]
        multi_level_pos = [
            position_embedding_sine(m, num_pos_feats=self.embed_dim // 2, normalize=True,
                                    offset=-0.5)
            for m in multi_level_masks
        ]
        dn_meta = None
        noised_label_queries = noised_box_queries = attn_bias = None
        if train and self.denoising_generator is not None:
            noised_label_queries, noised_box_queries, attn_bias, dn_meta = (
                self.denoising_generator(gt_labels, gt_boxes, gt_valid, self.num_queries,
                                         generator, noise_draws)
            )
        train_transformer = train and self.with_hybrid
        if train_transformer and dropout_seed is None and self.dropout > 0:
            dropout_seed = int(torch.randint(0, 2**62, ()))
        (outputs_class, outputs_coord, enc_class, enc_coord, hybrid_class, hybrid_coord,
         hybrid_enc_class, hybrid_enc_coord) = self.transformer(
            multi_level_feats, multi_level_masks, multi_level_pos,
            noised_label_queries, noised_box_queries, attn_bias, train=train_transformer,
            dropout_seed=dropout_seed,
        )
        outputs = {}
        if dn_meta is not None:
            dn_cap = self.denoising_generator.dn_cap
            outputs["dn_outputs"] = {"pred_logits": outputs_class[:, :, :dn_cap],
                                     "pred_boxes": outputs_coord[:, :, :dn_cap]}
            outputs["dn_meta"] = dn_meta
            outputs_class = outputs_class[:, :, dn_cap:]
            outputs_coord = outputs_coord[:, :, dn_cap:]
        outputs["pred_logits"] = outputs_class[-1]
        outputs["pred_boxes"] = outputs_coord[-1]
        outputs["aux_outputs"] = {"pred_logits": outputs_class[:-1],
                                  "pred_boxes": outputs_coord[:-1]}
        if enc_class is not None:
            outputs["enc_outputs"] = {"pred_logits": enc_class, "pred_boxes": enc_coord}
        if hybrid_class is not None:
            outputs["hybrid_outputs"] = {
                "pred_logits": hybrid_class[-1],
                "pred_boxes": hybrid_coord[-1],
                "aux_outputs": {"pred_logits": hybrid_class[:-1],
                                "pred_boxes": hybrid_coord[:-1]},
                "enc_outputs": {"pred_logits": hybrid_enc_class,
                                "pred_boxes": hybrid_enc_coord},
            }
        return outputs
