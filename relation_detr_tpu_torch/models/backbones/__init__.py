from relation_detr_tpu_torch.models.backbones.resnet import ARCH_SETTINGS, ResNetBackbone


def build_backbone(arch: str) -> ResNetBackbone:
    """Backbone factory keyed by arch string, as the JAX package's. The port
    has the plain ResNet family so far; the other families (Swin, FocalNet,
    ConvNeXt, ViT) and DCN ResNets are ROADMAP Queue 1 item 12."""
    if arch in ARCH_SETTINGS:
        return ResNetBackbone(arch=arch)
    raise NotImplementedError(
        f"backbone {arch!r} is not ported yet "
        "(ROADMAP Queue 1 item 12: other backbones and bricks)"
    )


__all__ = ["ResNetBackbone", "build_backbone"]
