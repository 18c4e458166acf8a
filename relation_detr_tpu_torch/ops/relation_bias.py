"""Position-relation bias, v4 math: CUDA kernel and its plain version.

Counterpart of ``relation_detr_tpu/ops/relation_pallas.py`` (the v4 kernel,
``fused_relation_bias_v4``, the TPU default). The kernel
(``csrc/relation_bias.cu``, whose header says what bounds it on the card)
builds the xy pair features per (b, i, j); the separable wh half uses
per-box features folded with the projection weights, computed here in plain
torch exactly as ``_v4_fwd`` computes them outside its Pallas call.

Ratio clamp: the xy ratio ``|c1 - c2| / (w1 + eps)`` is clamped to
[0, 1e8] with NaN going to 1e8 (``relation_pallas.py:198-200``), so a NaN or
Inf box CENTER gives a finite bias here, where the direct embedding
(``models/relation.py::box_rel_encoding``) gives NaN. Kernel and plain
version both keep the clamp. A NaN width or height still gives NaN through
the wh features, as in the JAX kernel.

Gradients: box gradients are zero by contract (the caller detaches the
boxes, ``relation_pallas.py:304-309``). The plain version is differentiable
in ``kernel`` and ``bias``; the CUDA wrapper raises when they need a
gradient (their backward is ROADMAP Queue 2 item 1).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from relation_detr_tpu_torch import _build


def _freqs(embed_dim: int, temperature: float, scale: float) -> np.ndarray:
    """scale / temperature ** (2k / embed_dim), computed in float64 then
    rounded, as ``relation_pallas.py::_freqs``."""
    k = np.arange(embed_dim // 2, dtype=np.float64)
    return (scale / temperature ** (k * 2.0 / embed_dim)).astype(np.float32)


def _box_wh_features(src_boxes, tgt_boxes, kernel, embed_dim, inv, eps):
    """Per-box wh features with the wh projection weights folded in
    (``_v4_fwd`` :236-252): a_feats (B, H, N1, 2E) = alpha|beta interleaved,
    b_feats (B, 2E, N2) = cos|sin interleaved."""
    half = embed_dim // 2
    num_heads = kernel.shape[1]
    bs, n1 = src_boxes.shape[:2]
    n2 = tgt_boxes.shape[1]
    p = torch.log(src_boxes[..., 2:] + eps)[..., None] * inv  # (B, N1, 2, half)
    q = torch.log(tgt_boxes[..., 2:] + eps)[..., None] * inv  # (B, N2, 2, half)
    sp, cp = torch.sin(p), torch.cos(p)
    sq, cq = torch.sin(q), torch.cos(q)
    w_wh = kernel[2 * embed_dim:].reshape(2, half, 2, num_heads)
    ws = w_wh[:, :, 0].permute(2, 0, 1)  # (H, 2, half)
    wc = w_wh[:, :, 1].permute(2, 0, 1)
    alpha = sp[..., None, :, :] * ws + cp[..., None, :, :] * wc  # (B, N1, H, 2, half)
    beta = sp[..., None, :, :] * wc - cp[..., None, :, :] * ws
    a_feats = torch.stack([alpha, beta], dim=-1).reshape(bs, n1, num_heads, 2 * embed_dim)
    b_feats = torch.stack([cq, sq], dim=-1).reshape(bs, n2, 2 * embed_dim)
    return a_feats.permute(0, 2, 1, 3), b_feats.permute(0, 2, 1)


def relation_bias_v4_reference(
    src_boxes: torch.Tensor,
    tgt_boxes: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    embed_dim: int = 16,
    temperature: float = 10000.0,
    scale: float = 100.0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version of the v4 math: (B, N1, 4) x (B, N2, 4) cxcywh boxes,
    kernel (4E, H), bias (H) -> (B, H, N1, N2)."""
    half = embed_dim // 2
    inv = torch.from_numpy(_freqs(embed_dim, temperature, scale)).to(src_boxes.device)
    a_feats, b_feats = _box_wh_features(src_boxes, tgt_boxes, kernel, embed_dim, inv, eps)
    part_wh = torch.einsum("bhif,bfj->bhij", a_feats, b_feats)

    c1, w1 = src_boxes[..., :2], src_boxes[..., 2:]
    c2 = tgt_boxes[..., :2]
    ratio = torch.abs(c1[:, :, None] - c2[:, None]) / (w1[:, :, None] + eps)  # (B,N1,N2,2)
    ratio = torch.where(ratio < 1e8, ratio, torch.full_like(ratio, 1e8))  # NaN -> 1e8
    ratio = torch.where(ratio >= 0.0, ratio, torch.zeros_like(ratio))
    ang = torch.log(ratio + 1.0)[..., None] * inv  # (B, N1, N2, 2, half)
    feats = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        *ang.shape[:3], 4 * half
    )
    part_xy = torch.einsum("bijf,fh->bhij", feats, kernel[: 2 * embed_dim])
    return torch.relu(part_xy + part_wh + bias[None, :, None, None])


def _check_cuda_args(src_boxes, tgt_boxes, kernel, bias, embed_dim):
    tensors = (src_boxes, tgt_boxes, kernel, bias)
    if any(t.device != src_boxes.device for t in tensors):
        raise ValueError("relation bias: all tensors must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("relation bias kernel takes float32 tensors only")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("relation bias kernel takes contiguous tensors only")
    if torch.is_grad_enabled() and (kernel.requires_grad or bias.requires_grad):
        raise NotImplementedError(
            "relation bias CUDA kernel is forward only (kernel/bias grads "
            "are ROADMAP Queue 2 item 1); run under torch.no_grad()"
        )
    bs, n1, _ = src_boxes.shape
    if src_boxes.shape != (bs, n1, 4) or tgt_boxes.shape != (bs, tgt_boxes.shape[1], 4):
        raise ValueError("relation bias: boxes must be (B, N, 4)")
    if embed_dim != 16 or kernel.shape != (4 * embed_dim, bias.shape[0]):
        raise ValueError(
            f"relation bias kernel takes embed_dim 16 and kernel (64, H), got "
            f"{embed_dim} and {tuple(kernel.shape)}"
        )
    if bias.shape[0] not in (4, 8, 16):
        raise ValueError(f"relation bias kernel takes 4, 8 or 16 heads, got {bias.shape[0]}")


def relation_bias_v4(
    src_boxes: torch.Tensor,
    tgt_boxes: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    embed_dim: int = 16,
    temperature: float = 10000.0,
    scale: float = 100.0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Relation bias (B, H, N1, N2). CPU tensors take
    ``relation_bias_v4_reference``; CUDA tensors launch
    ``csrc/relation_bias.cu::relation_bias_v4_fwd`` or raise."""
    if src_boxes.device.type == "cpu":
        return relation_bias_v4_reference(
            src_boxes, tgt_boxes, kernel, bias, embed_dim, temperature, scale, eps
        )
    if src_boxes.device.type != "cuda":
        raise ValueError(f"relation bias: no kernel for device {src_boxes.device}")
    _check_cuda_args(src_boxes, tgt_boxes, kernel, bias, embed_dim)
    lib = _build.load_library()
    bs, n1, _ = src_boxes.shape
    n2 = tgt_boxes.shape[1]
    num_heads = kernel.shape[1]
    freqs = _freqs(embed_dim, temperature, scale)
    inv = torch.from_numpy(freqs).to(src_boxes.device)
    a_feats, b_feats = _box_wh_features(src_boxes, tgt_boxes, kernel, embed_dim, inv, eps)
    a_feats = a_feats.contiguous()
    b_feats = b_feats.contiguous()
    out = torch.empty(bs, num_heads, n1, n2, device=src_boxes.device, dtype=torch.float32)
    freqs_host = (ctypes.c_float * len(freqs))(*freqs.tolist())
    with torch.cuda.device(src_boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.relation_bias_v4_fwd(
            src_boxes.data_ptr(), tgt_boxes.data_ptr(), a_feats.data_ptr(),
            b_feats.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            ctypes.addressof(freqs_host),
            out.data_ptr(), bs, n1, n2, num_heads, embed_dim, eps, stream,
        )
    _build.check(lib, code, "relation_bias_v4_fwd")
    relation_bias_v4.launches += 1
    return out


relation_bias_v4.launches = 0
