"""Swin Transformer backbone, v1 and v2. Counterpart of
``relation_detr_tpu/models/backbones/swin.py``.

state_dict names are torchvision's, the layout
``tools/convert_torch_weights.py`` reads: ``features.0.0`` the 4x4/s4
patch conv and ``features.0.2`` its LayerNorm, ``features.{2s}`` the
PatchMerging before stage s (``reduction``, ``norm``), ``features.{2s+1}.{j}``
block j of stage s (``norm1``, ``attn.qkv``, ``attn.proj``,
``attn.relative_position_bias_table`` or v2's ``attn.logit_scale`` and
``attn.cpb_mlp.0/2``, ``norm2``, ``mlp.0``, ``mlp.3``).

The blocks compute in NHWC, as the JAX module does; the backbone takes an
NCHW image and returns NCHW stage outputs, as the ResNet does. Everything
stays fp32: the JAX package gives its compute dtype to the ResNet only.
Stochastic depth is left out: the JAX backbone's default
``stochastic_depth_prob=0.0`` makes it the identity.
"""
from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ARCH_SETTINGS = {
    # name: (embed_dim, depths, num_heads, window_size, v2), the JAX table
    "swin_t": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7, False),
    "swin_s": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7, False),
    "swin_b": (128, (2, 2, 18, 2), (4, 8, 16, 32), 7, False),
    "swin_l": (192, (2, 2, 18, 2), (6, 12, 24, 48), 7, False),
    "swin_b_384": (128, (2, 2, 18, 2), (4, 8, 16, 32), 12, False),
    "swin_l_384": (192, (2, 2, 18, 2), (6, 12, 24, 48), 12, False),
    "swin_v2_t": (96, (2, 2, 6, 2), (3, 6, 12, 24), 8, True),
    "swin_v2_s": (96, (2, 2, 18, 2), (3, 6, 12, 24), 8, True),
    "swin_v2_b": (128, (2, 2, 18, 2), (4, 8, 16, 32), 8, True),
}


def _log_coords_table(ws: int) -> np.ndarray:
    """Static (2ws-1)^2 x 2 log-spaced relative coordinates, the v2
    continuous position bias' input."""
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), -1)  # (2ws-1, 2ws-1, 2)
    table = table / max(ws - 1, 1) * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / 3.0
    return table.reshape(-1, 2)


def _relative_position_index(ws: int) -> np.ndarray:
    """Static (ws^2, ws^2) index into the (2ws-1)^2 bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"), 0
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, n, n)
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(pad_h: int, pad_w: int, ws: int, shift: int) -> np.ndarray:
    """Static (nW, ws^2, ws^2) additive mask, -100 between tokens of
    different regions of a shifted window."""
    img = np.zeros((pad_h, pad_w), np.int32)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    img = img.reshape(pad_h // ws, ws, pad_w // ws, ws).transpose(0, 2, 1, 3)
    img = img.reshape(-1, ws * ws)  # (nW, ws^2)
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(pad_h: int, pad_w: int, ws: int, shift: int,
                    device: torch.device) -> torch.Tensor:
    """``_shift_attn_mask`` on ``device``, made once per canvas (a copy to
    the card per block would stall the host)."""
    with torch.inference_mode(False):  # usable by a later train step too
        return torch.from_numpy(_shift_attn_mask(pad_h, pad_w, ws, shift)).to(device)


def uniform_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)): torch's nn.Linear default and
    the JAX package's ``torch_linear_kernel_init`` / ``torch_linear_bias_init``."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    nn.init.uniform_(tensor, -bound, bound, generator=generator)


def torch_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    uniform_(layer.weight, layer.in_features, generator)
    if layer.bias is not None:
        uniform_(layer.bias, layer.in_features, generator)


class WindowAttention(nn.Module):
    """(Shifted) window attention over an NHWC map. The shift is on when the
    unpadded map is larger than a window both ways; the map is padded to
    whole windows (no padding mask: padded tokens carry the qkv bias), rolled
    by -shift, attended per window with the relative position bias (and,
    shifted, the -100 region mask), and rolled back. v2: cosine attention
    with a learned clamped logit scale, k computed without its bias, and
    the continuous position bias (2 -> 512 -> heads MLP, 16 sigmoid).

    JAX subtracts the k bias back out of the projection instead. Where v2
    pads (its norm comes after the attention, so padded tokens are 0), k is
    then 0 and JAX's gradient of the norm there is NaN, which reaches the k
    rows of ``qkv``; here k is exactly 0 too, but the norm's gradient is
    0 and the k bias gets none."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 v2: bool = False):
        super().__init__()
        self.num_heads, self.window_size, self.shift, self.v2 = num_heads, window_size, shift, v2
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        ws = window_size
        if v2:
            self.logit_scale = nn.Parameter(torch.empty(num_heads, 1, 1))
            self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                         nn.Linear(512, num_heads, bias=False))
            self.register_buffer("coords_table", torch.from_numpy(_log_coords_table(ws)),
                                 persistent=False)
        else:
            self.relative_position_bias_table = nn.Parameter(
                torch.empty((2 * ws - 1) ** 2, num_heads))
        self.register_buffer("rel_index",
                             torch.from_numpy(_relative_position_index(ws).reshape(-1)),
                             persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        torch_linear_(self.qkv, generator)
        torch_linear_(self.proj, generator)
        if self.v2:
            nn.init.constant_(self.logit_scale, math.log(10.0))
            torch_linear_(self.cpb_mlp[0], generator)
            uniform_(self.cpb_mlp[2].weight, 512, generator)
        else:
            nn.init.trunc_normal_(self.relative_position_bias_table, 0.0, 0.02, -0.04, 0.04,
                                  generator=generator)

    def position_bias(self) -> torch.Tensor:
        """(heads, ws^2, ws^2) relative position bias."""
        n = self.window_size ** 2
        table = self.cpb_mlp(self.coords_table) if self.v2 else self.relative_position_bias_table
        bias = table[self.rel_index].reshape(n, n, self.num_heads).permute(2, 0, 1)
        return 16.0 * torch.sigmoid(bias) if self.v2 else bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = self.window_size
        shift = self.shift if min(h, w) > ws else 0
        pad_h, pad_w = -(-h // ws) * ws, -(-w // ws) * ws
        x = F.pad(x, (0, 0, 0, pad_w - w, 0, pad_h - h))
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        nh, nw, n = pad_h // ws, pad_w // ws, ws * ws
        windows = x.reshape(b, nh, ws, nw, ws, c).transpose(2, 3).reshape(b * nh * nw, n, c)
        heads, d = self.num_heads, c // self.num_heads
        bias = self.qkv.bias
        if self.v2:  # k without its bias, as torchvision zeroes it and JAX subtracts it
            bias = torch.cat([bias[:c], torch.zeros_like(bias[c:2 * c]), bias[2 * c:]])
        qkv = F.linear(windows, self.qkv.weight, bias)
        q, k, v = qkv.reshape(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        if self.v2:
            scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
            logits = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1) * scale
        else:
            logits = (q @ k.transpose(-2, -1)) / math.sqrt(d)
        logits = logits + self.position_bias()
        if shift:
            mask = shift_attn_mask(pad_h, pad_w, ws, shift, x.device)
            logits = (logits.reshape(b, nh * nw, heads, n, n) + mask[None, :, None]).reshape(
                b * nh * nw, heads, n, n)
        out = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(-1, n, c)
        out = self.proj(out).reshape(b, nh, nw, ws, ws, c).transpose(2, 3)
        out = out.reshape(b, pad_h, pad_w, c)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        return out[:, :h, :w]


def mlp(dim: int, hidden: int) -> nn.Sequential:
    """Linear, exact GELU, Linear at torchvision's indices 0 and 3 (its
    dropout sits at 2; the JAX blocks have none)."""
    return nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Identity(), nn.Linear(hidden, dim))


class SwinBlock(nn.Module):
    """v1: pre-norm residuals; v2: the norm after attention and MLP."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float = 4.0, v2: bool = False):
        super().__init__()
        self.v2 = v2
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size, shift, v2)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = mlp(dim, int(dim * mlp_ratio))

    def init_weights(self, generator: torch.Generator) -> None:
        torch_linear_(self.mlp[0], generator)
        torch_linear_(self.mlp[3], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.v2:
            x = x + self.norm1(self.attn(x))
            return x + self.norm2(self.mlp(x))
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 patch merge of an NHWC map, odd sizes padded first; the patches
    concatenated as [0::2, 0::2], [1::2, 0::2], [0::2, 1::2], [1::2, 1::2].
    v1: LN(4C) then Linear(4C -> 2C); v2: the Linear, then LN(2C)."""

    def __init__(self, dim: int, v2: bool = False):
        super().__init__()
        self.v2 = v2
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim if v2 else 4 * dim, eps=1e-5)

    def init_weights(self, generator: torch.Generator) -> None:
        torch_linear_(self.reduction, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.norm(self.reduction(x)) if self.v2 else self.reduction(self.norm(x))


class ChannelsLast(nn.Module):
    """NCHW -> NHWC (torchvision's ``Permute([0, 2, 3, 1])``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1)


class SwinTransformerBackbone(nn.Module):
    """Swin feature extractor: (B, 3, H, W) -> the stage outputs of
    ``return_indices`` (default stages 1-3, strides 8/16/32), NCHW, fp32,
    each the raw stage output with no per-stage norm."""

    def __init__(self, arch: str = "swin_l", return_indices: Sequence[int] = (1, 2, 3)):
        super().__init__()
        embed_dim, depths, num_heads, ws, v2 = ARCH_SETTINGS[arch]
        self.return_indices = tuple(return_indices)
        self.num_channels: Tuple[int, ...] = tuple(embed_dim * 2 ** i for i in self.return_indices)
        features = [nn.Sequential(nn.Conv2d(3, embed_dim, 4, 4), ChannelsLast(),
                                  nn.LayerNorm(embed_dim, eps=1e-5))]
        for stage, depth in enumerate(depths):
            dim = embed_dim * 2 ** stage
            if stage > 0:
                features.append(PatchMerging(dim // 2, v2))
            features.append(nn.Sequential(*[
                SwinBlock(dim, num_heads[stage], ws, 0 if i % 2 == 0 else ws // 2, v2=v2)
                for i in range(depth)]))
        self.features = nn.Sequential(*features)

    def init_weights(self, generator: torch.Generator) -> None:
        # the JAX initialiser takes the HWIO kernel's first axis (4) as fan-in
        conv = self.features[0][0]
        uniform_(conv.weight, conv.kernel_size[0], generator)
        nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.features[0](x)
        outputs = []
        for stage in range(len(self.features) // 2):
            if stage > 0:
                x = self.features[2 * stage](x)
            x = self.features[2 * stage + 1](x)
            if stage in self.return_indices:
                outputs.append(x.permute(0, 3, 1, 2))
        return outputs
