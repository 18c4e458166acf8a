from typing import Optional, Sequence

from torch import nn

from relation_detr_tpu_torch.models.backbones import convnext, focalnet, resnet, swin
from relation_detr_tpu_torch.models.backbones.convnext import ConvNeXtBackbone
from relation_detr_tpu_torch.models.backbones.focalnet import FocalNetBackbone
from relation_detr_tpu_torch.models.backbones.resnet import ResNetBackbone
from relation_detr_tpu_torch.models.backbones.swin import SwinTransformerBackbone

_FAMILIES = (("swin", swin.ARCH_SETTINGS, SwinTransformerBackbone),
             ("convnext", convnext.ARCH_SETTINGS, ConvNeXtBackbone),
             ("focalnet", focalnet.ARCH_SETTINGS, FocalNetBackbone))


def build_backbone(arch: str, stage_with_dcn: Optional[Sequence[bool]] = None) -> nn.Module:
    """Backbone factory keyed by arch string, as the JAX package's: the plain
    ResNets, Swin (v1 and v2), ConvNeXt and FocalNet. ViT / EVA-02 and the
    DCN ResNet (``stage_with_dcn``) are ROADMAP Queue 1 item 4."""
    if stage_with_dcn is not None and any(stage_with_dcn):
        raise NotImplementedError("the DCN ResNet is not ported yet "
                                  "(ROADMAP Queue 1 item 4: other backbones and bricks)")
    if arch in resnet.ARCH_SETTINGS:
        return ResNetBackbone(arch=arch)
    for prefix, table, cls in _FAMILIES:
        if arch.startswith(prefix):
            if arch not in table:
                raise ValueError(f"unknown {prefix} arch {arch!r}; known: {sorted(table)}")
            return cls(arch=arch)
    raise NotImplementedError(
        f"backbone {arch!r} is not ported yet "
        "(ROADMAP Queue 1 item 4: other backbones and bricks)"
    )


__all__ = ["ConvNeXtBackbone", "FocalNetBackbone", "ResNetBackbone", "SwinTransformerBackbone",
           "build_backbone"]
