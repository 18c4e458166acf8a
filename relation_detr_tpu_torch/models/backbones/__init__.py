from typing import Optional, Sequence

from torch import nn

from relation_detr_tpu_torch.models.backbones import convnext, focalnet, resnet, swin, vit
from relation_detr_tpu_torch.models.backbones.convnext import ConvNeXtBackbone
from relation_detr_tpu_torch.models.backbones.focalnet import FocalNetBackbone
from relation_detr_tpu_torch.models.backbones.resnet import ResNetBackbone
from relation_detr_tpu_torch.models.backbones.swin import SwinTransformerBackbone
from relation_detr_tpu_torch.models.backbones.vit import VisionTransformerBackbone

_FAMILIES = ((("swin",), swin.ARCH_SETTINGS, SwinTransformerBackbone),
             (("convnext",), convnext.ARCH_SETTINGS, ConvNeXtBackbone),
             (("focalnet",), focalnet.ARCH_SETTINGS, FocalNetBackbone),
             (("vit", "eva_02_vit"), vit.ARCH_SETTINGS, VisionTransformerBackbone))


def build_backbone(arch: str, stage_with_dcn: Optional[Sequence[bool]] = None) -> nn.Module:
    """Backbone factory keyed by arch string, as the JAX package's: the
    ResNets (``stage_with_dcn``: the DCN form), Swin (v1 and v2), ConvNeXt,
    FocalNet, ViT and EVA-02. An unknown arch raises ValueError."""
    if arch in resnet.ARCH_SETTINGS:
        return ResNetBackbone(arch=arch, stage_with_dcn=tuple(stage_with_dcn or (False,) * 4))
    for prefixes, table, cls in _FAMILIES:
        if arch.startswith(prefixes):
            if arch not in table:
                raise ValueError(f"unknown {prefixes[0]} arch {arch!r}; known: {sorted(table)}")
            return cls(arch=arch)
    raise ValueError(f"unknown backbone arch: {arch}")


__all__ = ["ConvNeXtBackbone", "FocalNetBackbone", "ResNetBackbone", "SwinTransformerBackbone",
           "VisionTransformerBackbone", "build_backbone"]
