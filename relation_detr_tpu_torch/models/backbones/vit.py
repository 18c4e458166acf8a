"""ViT backbone with the SimpleFeaturePyramid, and its EVA-02 forms.
Counterpart of ``relation_detr_tpu/models/backbones/vit.py``.

A 16x16/s16 patch conv, then ``depth`` blocks on the NHWC token map:
windowed attention (windows of 14 for ViT, 16 for EVA-02, the map padded
with zeros after ``norm1`` and the padded tokens attended unmasked) except
in the ``global_idx`` blocks, which attend over the whole map. EVA-02 adds
2-D rotary embeddings on q and k (``rope``: separate ``q_proj`` / ``k_proj``
/ ``v_proj``, k without a bias) and the SwiGLU MLP (``swiglu``). The
pyramid builds strides 4 / 8 / 16 / 32 from the stride-16 map (two 2x
``ConvTranspose2d``, one, the identity, a 2x2 max pool), each projected
to 256 channels by a 1x1 and a 3x3 conv, each followed by a LayerNorm.

state_dict names are the JAX module's, dotted (``patch_embed``,
``block{i}.norm1``, ``block{i}.attn.qkv``, ``block{i}.mlp.w1``,
``block{i}.mlp_fc1``, ``fpn{s}_up1``, ``fpn{s}_conv1``, ...). The
transposed convolutions' weights differ from flax's by a spatial flip (the
bridge, ``utils/weights.py``, flips them). Attention is ``torch.matmul`` +
softmax, as the JAX module computes it with einsum; everything stays fp32
under the bf16 policy, as in JAX (which gives its dtype to the ResNet only).
"""
from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from relation_detr_tpu_torch.models.backbones.swin import torch_linear_, uniform_
from relation_detr_tpu_torch.models.layers import LN_EPS

PATCH = 16
ARCH_SETTINGS = {
    # name: block/arch parameters, the JAX table
    "vit_b": dict(dim=768, depth=12, num_heads=12, mlp_dim=3072,
                  global_idx=(2, 5, 8, 11), rope=False, swiglu=False,
                  window_size=14),
    "vit_l": dict(dim=1024, depth=24, num_heads=16, mlp_dim=4096,
                  global_idx=(5, 11, 17, 23), rope=False, swiglu=False,
                  window_size=14),
    "eva_02_vit_b_4attn_1024": dict(
        dim=768, depth=12, num_heads=12, mlp_dim=2048,
        global_idx=(2, 5, 8, 11), rope=True, swiglu=True, window_size=16),
    "eva_02_vit_l_4attn_1024": dict(
        dim=1024, depth=24, num_heads=16, mlp_dim=2730,
        global_idx=(5, 11, 17, 23), rope=True, swiglu=True, window_size=16),
}


def _rope_tables(head_dim: int, pt_seq_len: int, grid_hw: Tuple[int, int]):
    """Static (gh * gw, head_dim) cos and sin tables of the 2-D rotary
    embedding: per axis, frequencies over a quarter of the head dim each,
    positions normalised by the axis's own length times ``pt_seq_len``,
    each frequency repeated for its (x0, x1) pair; rows then columns."""
    dim = head_dim // 2  # per axis
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    gh, gw = grid_hw
    fy = np.repeat((np.arange(gh) / gh * pt_seq_len)[:, None] * freqs[None, :], 2, axis=-1)
    fx = np.repeat((np.arange(gw) / gw * pt_seq_len)[:, None] * freqs[None, :], 2, axis=-1)
    full = np.concatenate(
        [np.broadcast_to(fy[:, None, :], (gh, gw, dim)),
         np.broadcast_to(fx[None, :, :], (gh, gw, dim))], axis=-1
    ).reshape(gh * gw, head_dim)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


@functools.lru_cache(maxsize=None)
def rope_tables(head_dim: int, pt_seq_len: int, gh: int, gw: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_rope_tables`` on ``device``, made once per grid (a copy to the card
    per block would stall the host)."""
    with torch.inference_mode(False):  # usable by a later train step too
        cos, sin = _rope_tables(head_dim, pt_seq_len, (gh, gw))
        return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved pairs (x0, x1) -> (-x1, x0)."""
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], -1).flatten(-2)


def _apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    return t * cos + _rotate_half(t) * sin


def _trunc_normal_02(tensor: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``truncated_normal(0.02)``: std 0.02, cut at two of them."""
    nn.init.trunc_normal_(tensor, 0.0, 0.02, -0.04, 0.04, generator=generator)


class Attention(nn.Module):
    """Multi-head self-attention over (B, N, C). Plain: one ``qkv`` of 3C,
    split as (3, heads, head_dim). ``use_rope``: ``q_proj`` / ``k_proj``
    (no bias) / ``v_proj``, with the rotary tables on q and k."""

    def __init__(self, dim: int, num_heads: int, use_rope: bool = False):
        super().__init__()
        self.num_heads, self.use_rope = num_heads, use_rope
        if use_rope:
            self.q_proj = nn.Linear(dim, dim)
            self.k_proj = nn.Linear(dim, dim, bias=False)
            self.v_proj = nn.Linear(dim, dim)
        else:
            self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def init_weights(self, generator: torch.Generator) -> None:
        if self.use_rope:
            for layer in (self.q_proj, self.k_proj, self.v_proj):
                uniform_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(self.q_proj.bias)
            nn.init.zeros_(self.v_proj.bias)
        else:
            torch_linear_(self.qkv, generator)
        torch_linear_(self.proj, generator)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        b, n, c = x.shape
        heads, hd = self.num_heads, c // self.num_heads
        if self.use_rope:
            cos, sin = rope  # (N, head_dim), broadcast over the heads
            q = _apply_rope(self.q_proj(x).view(b, n, heads, hd), cos[:, None], sin[:, None])
            k = _apply_rope(self.k_proj(x).view(b, n, heads, hd), cos[:, None], sin[:, None])
            v = self.v_proj(x).view(b, n, heads, hd)
        else:
            q, k, v = self.qkv(x).view(b, n, 3, heads, hd).unbind(2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, N, hd)
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class SwiGLU(nn.Module):
    """silu(w1 x) * (w2 x), then ``ffn_ln`` and ``w3``."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden_dim)
        self.w2 = nn.Linear(dim, hidden_dim)
        self.ffn_ln = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.w3 = nn.Linear(hidden_dim, dim)

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in (self.w1, self.w2, self.w3):
            torch_linear_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ResBottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bias-free convs, each followed by a LayerNorm (the
    first two by GELU), added to the input; ``norm3`` zero-initialised, so
    the block starts as the identity. NHWC in and out. The JAX package
    defines it and its backbone never calls it; so does the port."""

    def __init__(self, features: int, bottleneck: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, bottleneck, 1, bias=False)
        self.norm1 = nn.LayerNorm(bottleneck, eps=LN_EPS)
        self.conv2 = nn.Conv2d(bottleneck, bottleneck, 3, padding=1, bias=False)
        self.norm2 = nn.LayerNorm(bottleneck, eps=LN_EPS)
        self.conv3 = nn.Conv2d(bottleneck, features, 1, bias=False)
        self.norm3 = nn.LayerNorm(features, eps=LN_EPS)

    def init_weights(self, generator: torch.Generator) -> None:
        for conv in (self.conv1, self.conv2, self.conv3):
            nn.init.kaiming_normal_(conv.weight, mode="fan_out", generator=generator)
        nn.init.zeros_(self.norm3.weight)
        nn.init.zeros_(self.norm3.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.gelu(self.norm1(_conv_nhwc(self.conv1, x)))
        out = F.gelu(self.norm2(_conv_nhwc(self.conv2, out)))
        return x + self.norm3(_conv_nhwc(self.conv3, out))


class ViTBlock(nn.Module):
    """Pre-norm attention + MLP block on (B, H, W, C); ``window_size`` 0 is
    global attention."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 0, mlp_dim: int = 0,
                 use_rope: bool = False, use_swiglu: bool = False, pt_seq_len: int = PATCH):
        super().__init__()
        self.num_heads, self.window_size, self.use_rope = num_heads, window_size, use_rope
        self.use_swiglu, self.pt_seq_len = use_swiglu, pt_seq_len
        mlp_dim = mlp_dim or 4 * dim
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, use_rope)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        if use_swiglu:
            self.mlp = SwiGLU(dim, mlp_dim)
        else:
            self.mlp_fc1 = nn.Linear(dim, mlp_dim)
            self.mlp_fc2 = nn.Linear(mlp_dim, dim)

    def init_weights(self, generator: torch.Generator) -> None:
        if not self.use_swiglu:
            torch_linear_(self.mlp_fc1, generator)
            torch_linear_(self.mlp_fc2, generator)

    def _rope(self, c: int, gh: int, gw: int, device):
        if not self.use_rope:
            return None
        return rope_tables(c // self.num_heads, self.pt_seq_len, gh, gw, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            nh, nw = -(-h // ws), -(-w // ws)
            x = F.pad(x, (0, 0, 0, nw * ws - w, 0, nh * ws - h))
            x = x.view(b, nh, ws, nw, ws, c).transpose(2, 3).reshape(b * nh * nw, ws * ws, c)
            x = self.attn(x, self._rope(c, ws, ws, x.device))
            x = x.view(b, nh, nw, ws, ws, c).transpose(2, 3).reshape(b, nh * ws, nw * ws, c)
            x = x[:, :h, :w]
        else:
            x = self.attn(x.reshape(b, h * w, c), self._rope(c, h, w, x.device))
            x = x.view(b, h, w, c)
        x = shortcut + x
        y = self.norm2(x)
        if self.use_swiglu:
            y = self.mlp(y)
        else:
            y = self.mlp_fc2(F.gelu(self.mlp_fc1(y)))
        return x + y


class VisionTransformerBackbone(nn.Module):
    """ViT + SimpleFeaturePyramid: (B, 3, H, W) -> the pyramid stages of
    ``return_indices`` (0-3 = strides 4 / 8 / 16 / 32), each (B, 256, h, w)
    fp32, NCHW as the other backbones return them."""

    def __init__(self, arch: str = "vit_b", return_indices: Sequence[int] = (1, 2, 3),
                 out_channels: int = 256):
        super().__init__()
        cfg = ARCH_SETTINGS[arch]
        dim = cfg["dim"]
        self.return_indices = tuple(return_indices)
        self.num_channels: Tuple[int, ...] = (out_channels,) * len(self.return_indices)
        self.depth = cfg["depth"]
        self.patch_embed = nn.Conv2d(3, dim, PATCH, PATCH)
        for i in range(self.depth):
            self.add_module(f"block{i}", ViTBlock(
                dim, cfg["num_heads"],
                window_size=0 if i in cfg["global_idx"] else cfg["window_size"],
                mlp_dim=cfg["mlp_dim"], use_rope=cfg["rope"], use_swiglu=cfg["swiglu"]))
        for stage in self.return_indices:
            cin = dim
            if stage <= 1:  # 4x: two transposed convs; 2x: one
                self.add_module(f"fpn{stage}_up1", nn.ConvTranspose2d(dim, dim // 2, 2, 2))
                cin = dim // 2
            if stage == 0:
                self.add_module(f"fpn{stage}_upnorm", nn.LayerNorm(dim // 2, eps=LN_EPS))
                self.add_module(f"fpn{stage}_up2", nn.ConvTranspose2d(dim // 2, dim // 4, 2, 2))
                cin = dim // 4
            self.add_module(f"fpn{stage}_conv1", nn.Conv2d(cin, out_channels, 1, bias=False))
            self.add_module(f"fpn{stage}_norm1", nn.LayerNorm(out_channels, eps=LN_EPS))
            self.add_module(f"fpn{stage}_conv2",
                            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False))
            self.add_module(f"fpn{stage}_norm2", nn.LayerNorm(out_channels, eps=LN_EPS))

    def init_weights(self, generator: torch.Generator) -> None:
        _trunc_normal_02(self.patch_embed.weight, generator)
        nn.init.zeros_(self.patch_embed.bias)
        for name, module in self.named_children():
            if not name.startswith("fpn"):
                continue
            if isinstance(module, nn.ConvTranspose2d):
                _trunc_normal_02(module.weight, generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.Conv2d):
                nn.init.kaiming_normal_(module.weight, mode="fan_out", generator=generator)

    def _stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """Pyramid stage ``stage`` of the NCHW stride-16 map, NCHW."""
        if stage <= 1:
            x = getattr(self, f"fpn{stage}_up1")(x)
        if stage == 0:
            x = F.gelu(getattr(self, f"fpn{stage}_upnorm")(x.permute(0, 2, 3, 1)))
            x = getattr(self, f"fpn{stage}_up2")(x.permute(0, 3, 1, 2))
        elif stage == 3:
            x = F.max_pool2d(x, 2, 2)
        for n in (1, 2):
            x = getattr(self, f"fpn{stage}_conv{n}")(x)
            x = getattr(self, f"fpn{stage}_norm{n}")(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_embed(x).permute(0, 2, 3, 1)  # NHWC tokens
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = x.permute(0, 3, 1, 2)
        return [self._stage(x, stage) for stage in self.return_indices]
