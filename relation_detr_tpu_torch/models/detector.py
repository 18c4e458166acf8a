"""Relation-DETR detector, eval forward. Counterpart of
``relation_detr_tpu/models/detector.py``.

As in the JAX package, resizing, normalising and padding to the canvas happen
on the host; the model takes a (B, H, W, 3) canvas and a (B, H, W) padding
mask (True = padding) and returns the raw heads; ``post_process`` decodes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from relation_detr_tpu_torch.models.backbones import build_backbone
from relation_detr_tpu_torch.models.layers import init_weights
from relation_detr_tpu_torch.models.neck import ChannelMapper
from relation_detr_tpu_torch.models.position_encoding import position_embedding_sine
from relation_detr_tpu_torch.models.transformer import TRAIN_NOT_PORTED, RelationTransformer


def downsample_mask(mask: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour mask downsample (F.interpolate(mode='nearest'))."""
    _, in_h, in_w = mask.shape
    out_h, out_w = out_hw
    rows = torch.arange(out_h, device=mask.device) * in_h // out_h
    cols = torch.arange(out_w, device=mask.device) * in_w // out_w
    return mask[:, rows][:, :, cols]


class _DenoisingGenerator(nn.Module):
    """Holds the CDN label encoder (state_dict:
    denoising_generator.label_encoder.weight); the CDN forward is the train
    step, ROADMAP Queue 1 item 8."""

    def __init__(self, num_classes: int, embed_dim: int):
        super().__init__()
        self.label_encoder = nn.Embedding(num_classes, embed_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.label_encoder.weight, generator=generator)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(TRAIN_NOT_PORTED)


class RelationDETR(nn.Module):
    """Backbone -> neck -> transformer. Constructor arguments are the JAX
    module's fields; ``generator`` seeds the initialisation (the model is
    built on CPU; move it with ``.to(device)``)."""

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
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_queries = num_queries
        self.hybrid_assign = hybrid_assign
        self.denoising_nums = denoising_nums
        self.backbone = build_backbone(backbone_arch)
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
            hybrid_num_proposals=hybrid_num_proposals,
        )
        self.denoising_generator = _DenoisingGenerator(num_classes, embed_dim)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor, mask: torch.Tensor, train: bool = False
                ) -> Dict[str, object]:
        """images (B, H, W, 3) normalised float, mask (B, H, W) bool."""
        if train:
            raise NotImplementedError(TRAIN_NOT_PORTED)
        feats = self.backbone(images.permute(0, 3, 1, 2))
        multi_level_feats = [f.permute(0, 2, 3, 1) for f in self.neck(feats)]
        multi_level_masks = [downsample_mask(mask, f.shape[1:3]) for f in multi_level_feats]
        multi_level_pos = [
            position_embedding_sine(m, num_pos_feats=self.embed_dim // 2, normalize=True,
                                    offset=-0.5)
            for m in multi_level_masks
        ]
        outputs_class, outputs_coord, enc_class, enc_coord = self.transformer(
            multi_level_feats, multi_level_masks, multi_level_pos
        )
        return {
            "pred_logits": outputs_class[-1],
            "pred_boxes": outputs_coord[-1],
            "aux_outputs": {
                "pred_logits": outputs_class[:-1],
                "pred_boxes": outputs_coord[:-1],
            },
            "enc_outputs": {"pred_logits": enc_class, "pred_boxes": enc_coord},
        }
