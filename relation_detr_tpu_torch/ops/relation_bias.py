"""Position-relation bias: CUDA kernels and their plain versions.

Counterpart of ``relation_detr_tpu/ops/relation_pallas.py``.
``set_fused_relation`` picks the version ``models/relation.py`` runs on
CUDA tensors: 4 (the default) boxes-in, 3 separable in plain torch, 1 and 2
from the relation tensor (``fused_relation_bias``), or the direct
embedding when disabled.

Versions 1 and 2 (``fused_relation_bias``): one kernel
(``csrc/relation_bias_rel.cu``) serves both TPU kernels; its plain version
is ``fused_relation_bias_reference`` (the JAX ``_reference_bias`` with the
kernel's angle rounding). As in the JAX package the relation tensor gets a
zero gradient and the kernel and bias gradients come from the plain
version, recomputed and differentiated.

Version 4 (``relation_bias_v4``, ``fused_relation_bias_v4`` in the JAX
package, the TPU default): one launch of ``csrc/relation_bias.cu`` (whose
header says what bounds it on the card) per call, from the boxes, the
weights read through their strides (the model hands conv's (H, 4E) weight
as its transposed view, no copy) and the bias. The kernel builds the xy
pair features per (b, i, j) and the separable wh half's per-box features
(the projection weights folded in, as ``_v4_fwd`` computes them outside its
Pallas call) itself; the wrapper checks its arguments and allocates the
output, nothing else. The plain version computes the per-box features in
torch (``_box_wh_features``).

Ratio clamp: the xy ratio ``|c1 - c2| / (w1 + eps)`` is clamped to
[0, 1e8] with NaN going to 1e8 (``relation_pallas.py:198-200``), so a NaN or
Inf box CENTER gives a finite bias here, where the direct embedding
(``models/relation.py::box_rel_encoding``) gives NaN. Kernel and plain
version both keep the clamp. A NaN width or height still gives NaN through
the wh features, as in the JAX kernel.

Gradients: box gradients are zero by contract (the caller detaches the
boxes, ``relation_pallas.py:304-309``); both paths of the wrapper treat the
boxes as constants. ``kernel`` and ``bias`` gradients: on CPU autograd
differentiates the plain version; on CUDA ``RelationBiasFunction``'s
forward launches the kernel and its backward (``relation_bias_v4_backward``)
recomputes the plain separable version, clamp included, and differentiates
it, as the JAX package's ``_v4_vjp_bwd`` recomputes through XLA (the TPU
backward is not a Pallas kernel either).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from relation_detr_tpu_torch import _build

# Which bias ``models/relation.py`` computes on CUDA tensors (the JAX
# package's ``_FUSED``; its ``v4_block`` is a TPU block size, not ported).
_FUSED = {"enabled": True, "version": 4}


def set_fused_relation(enabled: bool = None, version: int = None) -> None:
    """``enabled=False``: the direct embedding; else ``version`` 4 (boxes-in
    kernel), 3 (separable plain torch), 1 or 2 (relation-tensor kernel)."""
    if version is not None:
        if int(version) not in (1, 2, 3, 4):
            raise ValueError(f"relation bias version {version}: the port has 1, 2, 3 and 4")
        _FUSED["version"] = int(version)
    if enabled is not None:
        _FUSED["enabled"] = bool(enabled)


def fused_relation_enabled() -> bool:
    return _FUSED["enabled"]


def fused_relation_version() -> int:
    return _FUSED["version"]


def _freqs(embed_dim: int, temperature: float, scale: float) -> np.ndarray:
    """scale / temperature ** (2k / embed_dim), computed in float64 then
    rounded, as ``relation_pallas.py::_freqs``."""
    k = np.arange(embed_dim // 2, dtype=np.float64)
    return (scale / temperature ** (k * 2.0 / embed_dim)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _freqs_host(embed_dim: int, temperature: float, scale: float):
    """``_freqs`` as the host float array the C entries copy by value."""
    freqs = _freqs(embed_dim, temperature, scale)
    return (ctypes.c_float * len(freqs))(*freqs.tolist())


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
    # the kernel reads the weights through their strides (any layout)
    if not (src_boxes.is_contiguous() and tgt_boxes.is_contiguous() and bias.is_contiguous()):
        raise ValueError("relation bias kernel takes contiguous boxes and bias")
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


def _relation_bias_v4_fwd(src_boxes, tgt_boxes, kernel, bias, embed_dim,
                          temperature, scale, eps):
    lib = _build.load_library()
    bs, n1, _ = src_boxes.shape
    n2 = tgt_boxes.shape[1]
    num_heads = kernel.shape[1]
    out = torch.empty(bs, num_heads, n1, n2, device=src_boxes.device, dtype=torch.float32)
    with torch.cuda.device(src_boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.relation_bias_v4_fwd(
            src_boxes.data_ptr(), tgt_boxes.data_ptr(), kernel.data_ptr(), kernel.stride(0),
            kernel.stride(1), bias.data_ptr(),
            ctypes.addressof(_freqs_host(embed_dim, temperature, scale)),
            out.data_ptr(), bs, n1, n2, num_heads, embed_dim, eps, stream,
        )
    _build.check(lib, code, "relation_bias_v4_fwd")
    relation_bias_v4.launches += 1
    return out


def relation_bias_v4_backward(src_boxes, tgt_boxes, kernel, bias, grad_out,
                              embed_dim=16, temperature=10000.0, scale=100.0, eps=1e-5):
    """(d kernel, d bias) of the bias: the plain separable version
    recomputed with the boxes as constants and differentiated."""
    with torch.enable_grad():
        k = kernel.detach().requires_grad_(True)
        b = bias.detach().requires_grad_(True)
        out = relation_bias_v4_reference(
            src_boxes.detach(), tgt_boxes.detach(), k, b, embed_dim, temperature, scale, eps
        )
        return torch.autograd.grad(out, (k, b), grad_out)


class RelationBiasFunction(torch.autograd.Function):
    """The v4 bias on CUDA tensors: forward ``relation_bias_v4_fwd``,
    backward ``relation_bias_v4_backward``; zero box gradients."""

    @staticmethod
    def forward(ctx, src_boxes, tgt_boxes, kernel, bias, embed_dim, temperature, scale, eps):
        ctx.save_for_backward(src_boxes, tgt_boxes, kernel, bias)
        ctx.settings = (embed_dim, temperature, scale, eps)
        return _relation_bias_v4_fwd(src_boxes, tgt_boxes, kernel, bias, embed_dim,
                                     temperature, scale, eps)

    @staticmethod
    def backward(ctx, grad_out):
        src_boxes, tgt_boxes, kernel, bias = ctx.saved_tensors
        d_kernel, d_bias = relation_bias_v4_backward(
            src_boxes, tgt_boxes, kernel, bias, grad_out, *ctx.settings
        )
        d_src = torch.zeros_like(src_boxes) if ctx.needs_input_grad[0] else None
        d_tgt = torch.zeros_like(tgt_boxes) if ctx.needs_input_grad[1] else None
        return d_src, d_tgt, d_kernel, d_bias, None, None, None, None


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
    """Relation bias (B, H, N1, N2), differentiable in ``kernel`` and
    ``bias``. CPU tensors take ``relation_bias_v4_reference`` (boxes
    detached); CUDA tensors go through ``RelationBiasFunction``
    (``csrc/relation_bias.cu``) or raise."""
    if src_boxes.device.type == "cpu":
        return relation_bias_v4_reference(
            src_boxes.detach(), tgt_boxes.detach(), kernel, bias, embed_dim,
            temperature, scale, eps,
        )
    if src_boxes.device.type != "cuda":
        raise ValueError(f"relation bias: no kernel for device {src_boxes.device}")
    _check_cuda_args(src_boxes, tgt_boxes, kernel, bias, embed_dim)
    return RelationBiasFunction.apply(
        src_boxes, tgt_boxes, kernel, bias, embed_dim, temperature, scale, eps
    )


relation_bias_v4.launches = 0


def fused_relation_bias_reference(rel, kernel, bias, embed_dim=16, temperature=10000.0,
                                  scale=100.0):
    """Plain version of the relation-tensor bias: relu(sine_embed(rel) @
    kernel + bias), rel (B, N1, N2, 4), kernel (4E, H), bias (H) ->
    (B, H, N1, N2). The JAX ``_reference_bias`` with the angles as its
    Pallas kernels and ``relation_bias_rel_fwd`` form them, rel * freqs
    (``_freqs``); ``get_sine_pos_embed`` forms rel * scale / dim_t, which
    rounds differently, by up to ~1e-4 rad at the ~1e3 rad the angles
    reach. Features in get_sine_pos_embed's order (coordinate, frequency,
    sin/cos)."""
    inv = torch.from_numpy(_freqs(embed_dim, temperature, scale)).to(rel.device)
    ang = rel[..., None] * inv  # (B, N1, N2, 4, E/2)
    feats = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        *rel.shape[:3], rel.shape[3] * embed_dim)
    return torch.relu(feats @ kernel + bias).permute(0, 3, 1, 2)


def _fused_relation_bias_fwd(rel, kernel, bias, embed_dim, temperature, scale):
    tensors = (rel, kernel, bias)
    if any(t.device != rel.device for t in tensors):
        raise ValueError("relation bias: all tensors must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("relation bias kernel takes float32 tensors only")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("relation bias kernel takes contiguous tensors only")
    if rel.dim() != 4 or rel.shape[3] != 4:
        raise ValueError(f"relation bias: rel must be (B, N1, N2, 4), got {tuple(rel.shape)}")
    num_heads = bias.shape[0]
    if embed_dim != 16 or kernel.shape != (4 * embed_dim, num_heads):
        raise ValueError(f"relation bias kernel takes embed_dim 16 and kernel (64, H), got "
                         f"{embed_dim} and {tuple(kernel.shape)}")
    if num_heads not in (4, 8, 16):
        raise ValueError(f"relation bias kernel takes 4, 8 or 16 heads, got {num_heads}")
    if rel.data_ptr() % 16:
        raise ValueError("relation bias kernel takes a 16-byte aligned rel only")
    lib = _build.load_library()
    bs, n1, n2, _ = rel.shape
    freqs_host = _freqs_host(embed_dim, temperature, scale)
    out = torch.empty(bs, num_heads, n1, n2, device=rel.device, dtype=torch.float32)
    with torch.cuda.device(rel.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.relation_bias_rel_fwd(rel.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                                         ctypes.addressof(freqs_host), out.data_ptr(), bs, n1,
                                         n2, num_heads, embed_dim, stream)
    _build.check(lib, code, "relation_bias_rel_fwd")
    fused_relation_bias.launches += 1
    return out


class RelationBiasRelFunction(torch.autograd.Function):
    """``fused_relation_bias``: forward ``relation_bias_rel_fwd`` (its plain
    version on CPU), backward the plain version recomputed and
    differentiated for kernel and bias; rel gets zero (``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, rel, kernel, bias, embed_dim, temperature, scale):
        ctx.save_for_backward(rel, kernel, bias)
        ctx.settings = (embed_dim, temperature, scale)
        if rel.device.type == "cpu":
            return fused_relation_bias_reference(rel, kernel, bias, embed_dim, temperature,
                                                 scale)
        return _fused_relation_bias_fwd(rel, kernel, bias, embed_dim, temperature, scale)

    @staticmethod
    def backward(ctx, grad_out):
        rel, kernel, bias = ctx.saved_tensors
        with torch.enable_grad():
            k = kernel.detach().requires_grad_(True)
            b = bias.detach().requires_grad_(True)
            out = fused_relation_bias_reference(rel.detach(), k, b, *ctx.settings)
            d_kernel, d_bias = torch.autograd.grad(out, (k, b), grad_out)
        d_rel = torch.zeros_like(rel) if ctx.needs_input_grad[0] else None
        return d_rel, d_kernel, d_bias, None, None, None


def fused_relation_bias(rel: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        embed_dim: int = 16, temperature: float = 10000.0,
                        scale: float = 100.0) -> torch.Tensor:
    """relu(sine_embed(rel) @ kernel + bias) -> (B, H, N1, N2), the bias of
    relation versions 1 and 2, differentiable in ``kernel`` and ``bias``.
    CPU tensors take the plain version inside ``RelationBiasRelFunction``;
    CUDA tensors launch ``csrc/relation_bias_rel.cu`` or raise."""
    if rel.device.type not in ("cpu", "cuda"):
        raise ValueError(f"relation bias: no kernel for device {rel.device}")
    return RelationBiasRelFunction.apply(rel, kernel, bias, embed_dim, temperature, scale)


fused_relation_bias.launches = 0
