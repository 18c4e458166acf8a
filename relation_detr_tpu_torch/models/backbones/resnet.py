"""ResNet backbone with frozen BatchNorm (NCHW). Counterpart of
``relation_detr_tpu/models/backbones/resnet.py``: every arch of its table,
and ``stage_with_dcn``, which makes conv2 of each block of a stage a
``models/deform_conv.py::DeformConv2dPack`` (bias-free, at the block's
stride and groups). state_dict names are torchvision's (conv1, bn1,
layer{s}.{b}.conv{n}, downsample.0/1; a DCN conv2's ``weight``,
``conv_offset`` and ``conv_mask``).

The stem and ``layer1`` are frozen (``requires_grad=False``, so the
optimizer never holds them), as the reference freezes them
(``freeze_indices=(0,)``); this is the port's form of the JAX package's
``utils/param_groups.py::is_frozen`` mask.

``compute_dtype`` (the JAX module's ``dtype``; ``set_compute_dtype`` sets it
on the backbone and its convolutions) runs the convolutions in that dtype:
the input is cast before ``conv1`` and the activations after ``bn1`` and
after every block, as the JAX module casts them (``resnet.py:140-203``);
FrozenBatchNorm's fp32 buffers promote a bf16 conv output to fp32 in
between, as in JAX, and each returned stage output is fp32. A DCN conv2
is fed that fp32 and stays fp32, as the JAX module (which has no dtype)
does."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from relation_detr_tpu_torch.models.deform_conv import DeformConv2dPack
from relation_detr_tpu_torch.models.layers import Conv2d, FrozenBatchNorm

# arch -> (block, stage sizes, groups, width_per_group), as the JAX table
ARCH_SETTINGS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1, 64),
    "resnet34": ("basic", (3, 4, 6, 3), 1, 64),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 1, 64),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 1, 64),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 32, 4),
    "resnext101_32x4d": ("bottleneck", (3, 4, 23, 3), 32, 4),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3), 32, 8),
    "resnext101_64x4d": ("bottleneck", (3, 4, 23, 3), 64, 4),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3), 1, 128),
    "wide_resnet101_2": ("bottleneck", (3, 4, 23, 3), 1, 128),
}


def _conv(cin, cout, kernel, stride=1, groups=1):
    return Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups, bias=False)


def _init_convs(module: nn.Module, generator: torch.Generator) -> None:
    """kaiming normal over fan_out for the block's own convs (the JAX
    ``variance_scaling(2, fan_out, truncated_normal)``)."""
    for child in module.children():
        if isinstance(child, nn.Conv2d):
            nn.init.kaiming_normal_(child.weight, mode="fan_out", generator=generator)
        elif isinstance(child, nn.Sequential):
            _init_convs(child, generator)


def _conv2(cin, cout, stride, groups, with_dcn):
    """A block's 3x3 conv2, deformable with ``with_dcn``."""
    if with_dcn:
        return DeformConv2dPack(cin, cout, 3, stride, groups, use_bias=False)
    return _conv(cin, cout, 3, stride, groups)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False,
                 with_dcn: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = _conv2(features, features, 1, 1, with_dcn)
        self.bn2 = FrozenBatchNorm(features)
        self.downsample = (
            nn.Sequential(_conv(cin, features, 1, stride), FrozenBatchNorm(features))
            if downsample else None
        )

    init_weights = _init_convs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck (stride on the 3x3)."""

    def __init__(self, cin: int, width: int, cout: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, with_dcn: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = _conv2(width, width, stride, groups, with_dcn)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, cout, 1)
        self.bn3 = FrozenBatchNorm(cout)
        self.downsample = (
            nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm(cout))
            if downsample else None
        )

    init_weights = _init_convs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNetBackbone(nn.Module):
    """ResNet feature extractor: (B, 3, H, W) -> stage outputs selected by
    ``return_indices`` (0 = layer1 ... 3 = layer4), NCHW, fp32;
    ``stage_with_dcn`` (one flag a stage) as the JAX module's."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, arch: str = "resnet50", return_indices: Sequence[int] = (1, 2, 3),
                 stage_with_dcn: Sequence[bool] = (False, False, False, False)):
        super().__init__()
        block, stage_sizes, groups, width_per_group = ARCH_SETTINGS[arch]
        self.return_indices = tuple(return_indices)
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        expansion = 4 if block == "bottleneck" else 1
        cin = 64
        channels = []
        for stage_idx, num_blocks in enumerate(stage_sizes):
            base = 64 * 2 ** stage_idx
            blocks = []
            for block_idx in range(num_blocks):
                stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
                needs_down = block_idx == 0 and (
                    stride != 1 or (stage_idx == 0 and block == "bottleneck")
                )
                if block == "bottleneck":
                    width = int(base * (width_per_group / 64.0)) * groups
                    blocks.append(Bottleneck(cin, width, base * 4, stride, needs_down, groups,
                                             stage_with_dcn[stage_idx]))
                else:
                    blocks.append(BasicBlock(cin, base, stride, needs_down,
                                             stage_with_dcn[stage_idx]))
                cin = base * expansion
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*blocks))
            channels.append(cin)
        self.num_channels: Tuple[int, ...] = tuple(channels[i] for i in self.return_indices)
        self.conv1.requires_grad_(False)
        self.layer1.requires_grad_(False)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.kaiming_normal_(self.conv1.weight, mode="fan_out", generator=generator)

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self._cast(self.bn1(self.conv1(self._cast(x))))
        x = self.maxpool(torch.relu(x))
        outputs = []
        for stage_idx in range(4):
            for block in getattr(self, f"layer{stage_idx + 1}"):
                x = self._cast(block(x))
            if stage_idx in self.return_indices:
                outputs.append(x.float())
        return outputs
