"""Bilinear point sampling of NHWC feature maps. Counterpart of
``relation_detr_tpu/ops/grid_sample.py::bilinear_sample``, the sampler of
the DCN (``models/deform_conv.py``).

Plain PyTorch on whatever device the map is on: one ``torch.gather`` of the
four corners, whose backward autograd computes as a scatter-add. No hand
kernel: ``chip_smoke.py`` phase 12 times it at the DCN ResNet-50's shapes
beside its share of the detect and the step.
"""
from __future__ import annotations

import torch

# (dy, dx) of the four corners, in the JAX function's order
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def bilinear_sample(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample feat (B, H, W, C) at pixel points (B, N, 2) given as (x, y).

    Pixel units with no half-pixel shift (the corner below a point is
    ``floor``); each corner outside the map contributes zero on its own. The
    gradient reaches the points through the bilinear weights only (the
    integer corners carry none). Returns (B, N, C)."""
    b, h, w, c = feat.shape
    n = points.shape[1]
    x, y = points[..., 0], points[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    weights, index = [], []
    for dy, dx in _CORNERS:
        xc, yc = x0 + dx, y0 + dy
        valid = (xc >= 0) & (xc < w) & (yc >= 0) & (yc < h)
        wx = fx if dx else 1 - fx
        wy = fy if dy else 1 - fy
        weights.append(wx * wy * valid)
        index.append(yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1))
    index = torch.cat(index, 1)  # (B, 4N)
    got = torch.gather(feat.reshape(b, h * w, c), 1, index[..., None].expand(-1, -1, c))
    weights = torch.stack(weights, 1)  # (B, 4, N)
    return (got.view(b, 4, n, c) * weights[..., None]).sum(1)
