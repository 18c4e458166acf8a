"""ChannelMapper neck: per-level 1x1 conv + GroupNorm(32), extra stride-2
3x3 levels from the last input (C6 from C5), NCHW. Counterpart of
``relation_detr_tpu/models/neck.py``; state_dict: convs.{i}.0/1."""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from relation_detr_tpu_torch.models.layers import ConvNormActivation


class ChannelMapper(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 4):
        super().__init__()
        self.num_inputs = len(in_channels)
        convs = [ConvNormActivation(c, out_channels, 1) for c in in_channels]
        for i in range(self.num_inputs, num_outs):
            cin = in_channels[-1] if i == self.num_inputs else out_channels
            convs.append(ConvNormActivation(cin, out_channels, 3, stride=2))
        self.convs = nn.ModuleList(convs)

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(inputs) != self.num_inputs:
            raise ValueError(f"expected {self.num_inputs} inputs, got {len(inputs)}")
        outs = [conv(x) for conv, x in zip(self.convs, inputs)]
        for i in range(self.num_inputs, len(self.convs)):
            src = inputs[-1] if i == self.num_inputs else outs[-1]
            outs.append(self.convs[i](src))
        return outs
