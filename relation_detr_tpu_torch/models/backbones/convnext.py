"""ConvNeXt backbone. Counterpart of
``relation_detr_tpu/models/backbones/convnext.py``.

state_dict names are the JAX module names, with block j of stage s at
``features.{2s+1}.{j}`` (``dwconv``, ``norm``, ``pwconv1``, ``pwconv2``,
``gamma``): the JAX package names every backbone's blocks
``stage{s}_block{j}``, and the weight bridge maps that name to
torchvision's Swin layout for all three families. Then ``stem_conv`` /
``stem_norm``, ``down_norm{s}`` / ``down_conv{s}`` before stage s, and
``outnorm{s}`` per returned stage.

The blocks compute in NHWC, the depthwise convolution on an NCHW view;
the backbone takes NCHW and returns NCHW stage outputs, fp32.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

ARCH_SETTINGS = {
    # name: (dims, depths), the JAX table
    "convnext_tiny": ((96, 192, 384, 768), (3, 3, 9, 3)),
    "convnext_small": ((96, 192, 384, 768), (3, 3, 27, 3)),
    "convnext_base": ((128, 256, 512, 1024), (3, 3, 27, 3)),
    "convnext_large": ((192, 384, 768, 1536), (3, 3, 27, 3)),
    "convnext_xlarge": ((256, 512, 1024, 2048), (3, 3, 27, 3)),
}


def trunc_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX modules' ``truncated_normal(0.02)`` weight (cut at 2 std), zero
    bias."""
    nn.init.trunc_normal_(module.weight, 0.0, 0.02, -0.04, 0.04, generator=generator)
    if module.bias is not None:
        nn.init.zeros_(module.bias)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NHWC map, through NCHW views."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class CNBlock(nn.Module):
    """7x7 depthwise conv, LN (eps 1e-6), Linear 4x, exact GELU, Linear,
    layer scale ``gamma`` (1e-6), residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in (self.dwconv, self.pwconv1, self.pwconv2):
            trunc_normal_(layer, generator)
        nn.init.constant_(self.gamma, 1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(conv_nhwc(self.dwconv, x))
        return x + self.gamma * self.pwconv2(F.gelu(self.pwconv1(h)))


class ConvNeXtBackbone(nn.Module):
    """ConvNeXt feature extractor: (B, 3, H, W) -> the stage outputs of
    ``return_indices`` (default 1-3, strides 8/16/32), each through its
    ``outnorm``, NCHW, fp32."""

    def __init__(self, arch: str = "convnext_large", return_indices: Sequence[int] = (1, 2, 3)):
        super().__init__()
        dims, depths = ARCH_SETTINGS[arch]
        self.return_indices = tuple(return_indices)
        self.num_channels: Tuple[int, ...] = tuple(dims[i] for i in self.return_indices)
        self.stem_conv = nn.Conv2d(3, dims[0], 4, 4)
        self.stem_norm = nn.LayerNorm(dims[0], eps=1e-6)
        for stage in range(1, len(depths)):
            self.add_module(f"down_norm{stage}", nn.LayerNorm(dims[stage - 1], eps=1e-6))
            self.add_module(f"down_conv{stage}", nn.Conv2d(dims[stage - 1], dims[stage], 2, 2))
        self.features = nn.ModuleDict({
            str(2 * stage + 1): nn.Sequential(*[CNBlock(dims[stage]) for _ in range(depth)])
            for stage, depth in enumerate(depths)})
        for stage in self.return_indices:
            self.add_module(f"outnorm{stage}", nn.LayerNorm(dims[stage], eps=1e-6))

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.stem_conv, generator)
        for stage in range(1, len(self.features)):
            trunc_normal_(getattr(self, f"down_conv{stage}"), generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem_norm(self.stem_conv(x).permute(0, 2, 3, 1))
        outputs = []
        for stage in range(len(self.features)):
            if stage > 0:
                x = conv_nhwc(getattr(self, f"down_conv{stage}"),
                              getattr(self, f"down_norm{stage}")(x))
            x = self.features[str(2 * stage + 1)](x)
            if stage in self.return_indices:
                outputs.append(getattr(self, f"outnorm{stage}")(x).permute(0, 3, 1, 2))
        return outputs
