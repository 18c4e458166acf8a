"""FocalNet backbone (focal modulation). Counterpart of
``relation_detr_tpu/models/backbones/focalnet.py``.

state_dict names are the JAX module names, with block j of stage s at
``features.{2s+1}.{j}`` and its MLP at ``mlp.0`` / ``mlp.3``, the names the
weight bridge gives the Swin blocks, whose JAX names these share
(``stage{s}_block{j}``, ``mlp_fc1``, ``mlp_fc2``): ``patch_embed.proj`` /
``.norm``, per block ``modulation.f``, ``modulation.focal.{l}``,
``modulation.h``, ``modulation.proj``, ``norm1``, ``norm2`` and the layer
scales ``gamma_1`` / ``gamma_2``; ``downsample{s}`` after stage s and
``outnorm{s}`` per returned stage.

``focalnet_large_lrf_fl4`` (the 63.5 AP detector's) turns on the conv
patch embeddings, post-LN blocks, layer scale 1e-4 and the normalised
modulator at once. The blocks compute in NHWC, the convolutions on NCHW
views; the backbone takes NCHW and returns NCHW stage outputs, fp32.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from relation_detr_tpu_torch.models.backbones.convnext import trunc_normal_
from relation_detr_tpu_torch.models.backbones.swin import mlp

ARCH_SETTINGS = {
    # name: (embed_dim, depths, focal_levels, focal_windows, conv_embed,
    #        postln, layerscale, normalize_modulator), the JAX table
    "focalnet_tiny_srf": (96, (2, 2, 6, 2), (2,) * 4, (3,) * 4, False, False, False, False),
    "focalnet_small_lrf": (96, (2, 2, 18, 2), (3,) * 4, (3,) * 4, False, False, False, False),
    "focalnet_base_lrf": (128, (2, 2, 18, 2), (3,) * 4, (3,) * 4, False, False, False, False),
    "focalnet_large_lrf_fl4": (192, (2, 2, 18, 2), (4,) * 4, (3,) * 4, True, True, True, True),
}


class FocalModulation(nn.Module):
    """``f`` splits into q, the context and focal_level + 1 gates; level l
    is a bias-free depthwise conv of kernel focal_factor * l + focal_window
    and a GELU; the global context is the GELU of the last level's mean over
    the whole map (padding included); the gated sum (divided by
    focal_level + 1 when ``normalize_modulator``) goes through the 1x1 conv
    ``h`` and multiplies q before ``proj``."""

    def __init__(self, dim: int, focal_level: int, focal_window: int, focal_factor: int = 2,
                 normalize_modulator: bool = False):
        super().__init__()
        self.focal_level, self.normalize_modulator = focal_level, normalize_modulator
        self.f = nn.Linear(dim, 2 * dim + focal_level + 1)
        kernels = [focal_factor * level + focal_window for level in range(focal_level)]
        self.focal = nn.ModuleList(nn.Conv2d(dim, dim, k, padding=k // 2, groups=dim, bias=False)
                                   for k in kernels)
        self.h = nn.Conv2d(dim, dim, 1)
        self.proj = nn.Linear(dim, dim)

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in (self.f, *self.focal, self.h, self.proj):
            trunc_normal_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        q, ctx, gates = torch.split(self.f(x), [c, c, self.focal_level + 1], -1)
        ctx, gates = ctx.permute(0, 3, 1, 2), gates.permute(0, 3, 1, 2)  # NCHW views
        ctx_all = 0.0
        for level, conv in enumerate(self.focal):
            ctx = F.gelu(conv(ctx))
            ctx_all = ctx_all + ctx * gates[:, level:level + 1]
        ctx_global = F.gelu(ctx.mean((2, 3), keepdim=True))
        ctx_all = ctx_all + ctx_global * gates[:, self.focal_level:]
        if self.normalize_modulator:
            ctx_all = ctx_all / (self.focal_level + 1)
        return self.proj(q * self.h(ctx_all).permute(0, 2, 3, 1))


class FocalBlock(nn.Module):
    """Pre-LN (``x + g * mod(norm1(x))``) or post-LN (``x + g *
    norm1(mod(x))``) residuals around the modulation and the 4x MLP, ``g``
    the layer scale ``gamma_1`` / ``gamma_2`` (1e-4) when ``use_layerscale``."""

    def __init__(self, dim: int, focal_level: int, focal_window: int, mlp_ratio: float = 4.0,
                 use_postln: bool = False, use_layerscale: bool = False,
                 normalize_modulator: bool = False):
        super().__init__()
        self.use_postln = use_postln
        self.modulation = FocalModulation(dim, focal_level, focal_window,
                                          normalize_modulator=normalize_modulator)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = mlp(dim, int(dim * mlp_ratio))
        if use_layerscale:
            self.gamma_1 = nn.Parameter(torch.empty(dim))
            self.gamma_2 = nn.Parameter(torch.empty(dim))
        else:
            self.gamma_1 = self.gamma_2 = None

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.mlp[0], generator)
        trunc_normal_(self.mlp[3], generator)
        if self.gamma_1 is not None:
            nn.init.constant_(self.gamma_1, 1e-4)
            nn.init.constant_(self.gamma_2, 1e-4)

    def _scaled(self, gamma, x):
        return x if gamma is None else gamma * x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_postln:
            x = x + self._scaled(self.gamma_1, self.norm1(self.modulation(x)))
            return x + self._scaled(self.gamma_2, self.norm2(self.mlp(x)))
        x = x + self._scaled(self.gamma_1, self.modulation(self.norm1(x)))
        return x + self._scaled(self.gamma_2, self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """NCHW in, NHWC out: a conv embedding (7x7/s4/p2 for the stem, 3x3/s2/p1
    to downsample) with ``use_conv_embed``, else a patch conv; then LN."""

    def __init__(self, in_channels: int, features: int, patch_size: int = 4,
                 use_conv_embed: bool = False, is_stem: bool = False):
        super().__init__()
        if use_conv_embed:
            k, s, p = (7, 4, 2) if is_stem else (3, 2, 1)
        else:
            k, s, p = patch_size, patch_size, 0
        self.proj = nn.Conv2d(in_channels, features, k, s, p)
        self.norm = nn.LayerNorm(features, eps=1e-5)

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.proj, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class FocalNetBackbone(nn.Module):
    """FocalNet feature extractor: (B, 3, H, W) -> the stage outputs of
    ``return_indices`` (default 1-3, strides 8/16/32), each through its
    ``outnorm``, NCHW, fp32."""

    def __init__(self, arch: str = "focalnet_large_lrf_fl4",
                 return_indices: Sequence[int] = (1, 2, 3)):
        super().__init__()
        (embed_dim, depths, focal_levels, focal_windows, conv_embed, postln, layerscale,
         norm_mod) = ARCH_SETTINGS[arch]
        self.return_indices = tuple(return_indices)
        self.num_channels: Tuple[int, ...] = tuple(embed_dim * 2 ** i for i in self.return_indices)
        self.patch_embed = PatchEmbed(3, embed_dim, 4, conv_embed, is_stem=True)
        self.features = nn.ModuleDict()
        for stage, depth in enumerate(depths):
            dim = embed_dim * 2 ** stage
            self.features[str(2 * stage + 1)] = nn.Sequential(*[
                FocalBlock(dim, focal_levels[stage], focal_windows[stage], use_postln=postln,
                           use_layerscale=layerscale, normalize_modulator=norm_mod)
                for _ in range(depth)])
            if stage in self.return_indices:
                self.add_module(f"outnorm{stage}", nn.LayerNorm(dim, eps=1e-5))
            if stage < len(depths) - 1:
                self.add_module(f"downsample{stage}", PatchEmbed(dim, 2 * dim, 2, conv_embed))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_embed(x)
        outputs = []
        for stage in range(len(self.features)):
            x = self.features[str(2 * stage + 1)](x)
            if stage in self.return_indices:
                outputs.append(getattr(self, f"outnorm{stage}")(x).permute(0, 3, 1, 2))
            if stage < len(self.features) - 1:
                x = getattr(self, f"downsample{stage}")(x.permute(0, 3, 1, 2))
        return outputs
