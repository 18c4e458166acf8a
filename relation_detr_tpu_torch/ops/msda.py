"""Multi-scale deformable attention: CUDA kernel and its plain version.

Counterpart of ``relation_detr_tpu/ops/msda.py::multi_scale_deformable_attention``.
The JAX package writes the op in XLA (tiled one-hot matmuls for the encoder
and a corner-packed gather for the decoder on TPU); the port samples exactly
at every location with one hand-written kernel (``csrc/msda.cu``, whose
header says what bounds it on the card). Both serve the encoder (Q = S) and
the decoder (Q = queries).

``multi_scale_deformable_attention`` is the wrapper: a CPU tensor takes
``msda_reference``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from relation_detr_tpu_torch import _build


def msda_reference(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain version: the gather spec of ``ops/msda.py:440-488``.

    fp32 bilinear sampling, ``align_corners=False`` (pixel = loc * size -
    0.5), zero padding with each corner masked on its own.

    Args:
      value: (B, S, H, D), S = sum(h * w).
      spatial_shapes: (h, w) per level.
      sampling_locations: (B, Q, H, L, P, 2) normalized (x, y).
      attention_weights: (B, Q, H, L, P).
    Returns:
      (B, Q, H * D) in the dtype of ``value``.
    """
    if sum(h * w for h, w in spatial_shapes) != value.shape[1]:
        raise ValueError(f"value has {value.shape[1]} tokens, levels {spatial_shapes}")
    in_dtype = value.dtype
    value = value.float()
    sampling_locations = sampling_locations.float()
    attention_weights = attention_weights.float()
    bs, _, num_heads, head_dim = value.shape
    num_queries = sampling_locations.shape[1]
    b_ix = torch.arange(bs, device=value.device).view(bs, 1, 1, 1)
    h_ix = torch.arange(num_heads, device=value.device).view(1, 1, num_heads, 1)

    out = value.new_zeros(bs, num_queries, num_heads, head_dim)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        value_l = value[:, start:start + h * w]  # (B, hw, H, D)
        start += h * w
        loc = sampling_locations[:, :, :, lvl]  # (B, Q, H, P, 2)
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.long()
        y0i = y0.long()
        sampled = 0.0
        for dy, dx, wgt in (
            (0, 0, (1.0 - fx) * (1.0 - fy)),
            (0, 1, fx * (1.0 - fy)),
            (1, 0, (1.0 - fx) * fy),
            (1, 1, fx * fy),
        ):
            xc = x0i + dx
            yc = y0i + dy
            valid = (xc >= 0) & (xc < w) & (yc >= 0) & (yc < h)
            idx = yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)  # (B, Q, H, P)
            got = value_l[b_ix, idx, h_ix]  # (B, Q, H, P, D)
            sampled = sampled + got * (wgt * valid)[..., None]
        out = out + torch.sum(
            sampled * attention_weights[:, :, :, lvl, :, None], dim=3
        )
    return out.reshape(bs, num_queries, num_heads * head_dim).to(in_dtype)


def _check_cuda_args(value, spatial_shapes, sampling_locations, attention_weights):
    tensors = (value, sampling_locations, attention_weights)
    if any(t.device != value.device for t in tensors):
        raise ValueError("MSDA: all tensors must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("MSDA kernel takes float32 tensors only")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("MSDA kernel takes contiguous tensors only")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "MSDA CUDA kernel is forward only (the backward is ROADMAP "
            "Queue 2 item 0); run under torch.no_grad()/inference_mode()"
        )
    bs, total, num_heads, head_dim = value.shape
    _, num_queries, _, num_levels, num_points, _ = sampling_locations.shape
    if sampling_locations.shape != (bs, num_queries, num_heads, num_levels, num_points, 2):
        raise ValueError(f"MSDA: bad sampling_locations {tuple(sampling_locations.shape)}")
    if attention_weights.shape != sampling_locations.shape[:-1]:
        raise ValueError(f"MSDA: bad attention_weights {tuple(attention_weights.shape)}")
    if len(spatial_shapes) != num_levels:
        raise ValueError("MSDA: spatial_shapes and locations disagree on levels")
    if sum(h * w for h, w in spatial_shapes) != total:
        raise ValueError("MSDA: value tokens != sum of level sizes")


def multi_scale_deformable_attention(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """MSDA core, (B, S, H, D) x (B, Q, H, L, P, 2) x (B, Q, H, L, P) ->
    (B, Q, H * D). CPU tensors take ``msda_reference``; CUDA tensors launch
    ``csrc/msda.cu::msda_fwd`` (forward only) or raise."""
    if value.device.type == "cpu":
        return msda_reference(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"MSDA: no kernel for device {value.device}")
    _check_cuda_args(value, spatial_shapes, sampling_locations, attention_weights)
    lib = _build.load_library()
    bs, total, num_heads, head_dim = value.shape
    _, num_queries, _, num_levels, num_points, _ = sampling_locations.shape
    out = torch.empty(
        bs, num_queries, num_heads * head_dim, device=value.device, dtype=torch.float32
    )
    level_hw = (ctypes.c_int64 * (2 * num_levels))(
        *[int(v) for hw in spatial_shapes for v in hw]
    )
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.msda_fwd(
            value.data_ptr(), ctypes.addressof(level_hw),
            sampling_locations.data_ptr(), attention_weights.data_ptr(),
            out.data_ptr(), bs, total, num_queries, num_heads, head_dim,
            num_levels, num_points, stream,
        )
    _build.check(lib, code, "msda_fwd")
    multi_scale_deformable_attention.launches += 1
    return out


multi_scale_deformable_attention.launches = 0
