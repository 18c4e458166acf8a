"""Modulated deformable convolution (DCNv2). Counterpart of
``relation_detr_tpu/models/deform_conv.py::DeformConv2dPack``, the conv2
of the DCN ResNet's blocks.

``conv_offset`` (2 x k^2 channels) and ``conv_mask`` (k^2, then a sigmoid)
are k x k convs at the block's stride, zero-initialised (every tap starts
on its grid point with mask 0.5). Tap t reads channel 2t as its dy and
2t + 1 as its dx (torchvision's order), at ``out_pos * stride + tap -
pad``. The k^2 taps are sampled with ``ops.grid_sample.bilinear_sample``
(on the card a hand-written kernel, forward and backward:
``csrc/grid_sample.cu``), scaled by their masks and contracted over tap and
channel with ``weight`` per group.

state_dict names are torchvision's / mmcv's, as
``tools/convert_torch_weights.py`` reads them: ``weight`` (O, C/g, k, k)
(the JAX ``kernel`` (k^2, C/g, O)), ``conv_offset.*``, ``conv_mask.*`` and
``bias`` when ``use_bias``. The module computes in fp32 whatever it is
fed: the JAX module has no dtype, and under the bf16 policy the FrozenBN
before it gives it fp32. ``conv_offset`` and ``conv_mask`` are plain
``nn.Conv2d``, which ``layers.set_compute_dtype`` does not touch.
"""
from __future__ import annotations

import torch
from torch import nn

from relation_detr_tpu_torch.ops.grid_sample import bilinear_sample


class DeformConv2dPack(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 groups: int = 1, use_bias: bool = True):
        super().__init__()
        k, pad = kernel_size, (kernel_size - 1) // 2
        self.kernel_size, self.stride, self.groups, self.pad = k, stride, groups, pad
        self.weight = nn.Parameter(torch.empty(features, in_channels // groups, k, k))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.conv_offset = nn.Conv2d(in_channels, 2 * k * k, k, stride, pad)
        self.conv_mask = nn.Conv2d(in_channels, k * k, k, stride, pad)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.kaiming_normal_(self.weight, mode="fan_out", generator=generator)
        for param in (self.bias, *self.conv_offset.parameters(), *self.conv_mask.parameters()):
            if param is not None:
                nn.init.zeros_(param)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, H, W) -> (B, O, oh, ow)
        x = x.float()
        b, c = x.shape[:2]
        k, taps, g = self.kernel_size, self.kernel_size ** 2, self.groups
        offsets = self.conv_offset(x)  # (B, 2T, oh, ow)
        masks = torch.sigmoid(self.conv_mask(x)).permute(0, 2, 3, 1)  # (B, oh, ow, T)
        oh, ow = offsets.shape[-2:]
        ar = torch.arange(k, device=x.device) - self.pad
        tap_dy, tap_dx = (t.reshape(-1) for t in torch.meshgrid(ar, ar, indexing="ij"))
        base_y = (torch.arange(oh, device=x.device) * self.stride)[:, None, None] + tap_dy
        base_x = (torch.arange(ow, device=x.device) * self.stride)[None, :, None] + tap_dx
        off = offsets.permute(0, 2, 3, 1).reshape(b, oh, ow, taps, 2)
        points = torch.stack([base_x + off[..., 1], base_y + off[..., 0]], -1)
        sampled = bilinear_sample(x.permute(0, 2, 3, 1), points.reshape(b, -1, 2))
        sampled = sampled.reshape(b, oh, ow, taps, c) * masks[..., None]
        features = self.weight.shape[0]
        # (O, C/g, k, k) -> (T, C/g, g, O/g): output channel o is group o // (O/g)
        kernel = self.weight.permute(2, 3, 1, 0).reshape(taps, c // g, g, features // g)
        out = torch.einsum("nthc,tchf->nhf", sampled.reshape(-1, taps, g, c // g), kernel)
        out = out.reshape(b, oh, ow, features)
        if self.bias is not None:
            out = out + self.bias
        return out.permute(0, 3, 1, 2)
