"""Attention modules: dense MHA with an additive logit bias, and multi-scale
deformable attention. Counterpart of ``relation_detr_tpu/models/attention.py``.

Under a compute dtype (``layers.set_compute_dtype``) the projections run in
it and the rest keeps the JAX package's fp32 islands: the MHA logits are
fp32 sums of the compute-dtype products, the bias and the softmax fp32, the
probabilities cast back before the product with v; MSDA's offsets and
weights are rounded to the compute dtype by their projections and then
taken in fp32 (locations, softmax), and the sampling core takes the
compute-dtype value and returns its dtype.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from relation_detr_tpu_torch.models.layers import Linear, linear, xavier_
from relation_detr_tpu_torch.ops.msda import multi_scale_deformable_attention


# (module, sampling_locations, attention_weights, spatial_shapes) of every
# MultiScaleDeformableAttention call while ``record_sampling`` is active,
# else None: what the JAX package's ``sow("intermediates", "msda_sampling")``
# keeps for ``utils/clamp_check.py``
_SAMPLING_RECORD = None


@contextlib.contextmanager
def record_sampling():
    """Inside the block every ``MultiScaleDeformableAttention`` call appends
    (module, locations, weights, spatial_shapes) to the yielded list, in
    call order; outside it nothing is kept."""
    global _SAMPLING_RECORD
    saved, _SAMPLING_RECORD = _SAMPLING_RECORD, []
    try:
        yield _SAMPLING_RECORD
    finally:
        _SAMPLING_RECORD = saved


class _Fp32Logits(torch.autograd.Function):
    """(N, Q, D) x (N, D, K) compute-dtype operands -> fp32 (N, Q, K) on the
    tensor cores (``torch.bmm``'s ``out_dtype``, which has no derivative).
    The gradients are JAX's transpose of its einsum: the fp32 cotangent
    times the upcast other operand, in fp32, rounded to the operand's
    dtype."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return torch.bmm(q, k, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        q, k = ctx.saved_tensors
        grad_q = grad_k = None
        if ctx.needs_input_grad[0]:
            grad_q = torch.bmm(grad, k.float().transpose(1, 2)).to(q.dtype)
        if ctx.needs_input_grad[1]:
            grad_k = torch.bmm(q.float().transpose(1, 2), grad).to(k.dtype)
        return grad_q, grad_k


def attention_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, Q, H, D) x (B, K, H, D) -> (B, H, Q, K) in fp32 (JAX's einsum with
    ``preferred_element_type=float32``): for bf16 operands the products are
    exact and summed in fp32. On the card the product stays on the tensor
    cores (``_Fp32Logits``); on the CPU, which has no such kernel, the
    operands are upcast (the same sums, and through autograd the same
    gradients)."""
    if q.dtype == torch.float32:
        return torch.einsum("bqhd,bkhd->bhqk", q, k)
    b, nq, h, d = q.shape
    qt = q.permute(0, 2, 1, 3).reshape(b * h, nq, d)
    kt = k.permute(0, 2, 3, 1).reshape(b * h, d, k.shape[1])
    if q.device.type == "cpu":
        out = torch.bmm(qt.float(), kt.float())
    else:
        out = _Fp32Logits.apply(qt, kt)
    return out.reshape(b, h, nq, k.shape[1])


class MultiheadAttention(nn.Module):
    """Dense multi-head attention with an optional additive (B, H, Q, K)
    bias: plain matmuls and a softmax (``attention.py:36-75``), under a
    compute dtype with fp32 logits and softmax.
    Parameters use torch's ``nn.MultiheadAttention`` names (in_proj_weight
    holds q/k/v stacked, out_proj)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        # xavier over each (C, C) projection, as the JAX q/k/v Dense layers
        for chunk in self.in_proj_weight.data.chunk(3, dim=0):
            nn.init.xavier_uniform_(chunk, generator=generator)
        nn.init.zeros_(self.in_proj_bias)
        xavier_(self.out_proj, generator)

    def forward(self, query, key, value, attn_bias: Optional[torch.Tensor] = None):
        c, h, dt = self.embed_dim, self.num_heads, self.compute_dtype
        w, b = self.in_proj_weight, self.in_proj_bias
        q = linear(query, w[:c], b[:c], dt)
        k = linear(key, w[c:2 * c], b[c:2 * c], dt)
        v = linear(value, w[2 * c:], b[2 * c:], dt)
        q, k, v = (t.reshape(t.shape[0], t.shape[1], h, c // h) for t in (q, k, v))
        logits = attention_logits(q, k) / math.sqrt(c // h)
        if attn_bias is not None:
            logits = logits + attn_bias
        probs = torch.softmax(logits, dim=-1)  # fp32
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], c))


def sampling_offsets_bias(num_heads: int, num_levels: int, num_points: int) -> torch.Tensor:
    """Per-head radial offset bias (``attention.py:92-109``): head h points
    along angle 2*pi*h/H at unit Chebyshev length, tiled over levels, scaled
    by point index + 1."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (2.0 * math.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    grid = grid * torch.arange(1, num_points + 1, dtype=torch.float32)[None, None, :, None]
    return grid.reshape(-1)


class MultiScaleDeformableAttention(nn.Module):
    """Deformable-DETR MSDA module. The sampling core is
    ``ops.msda.multi_scale_deformable_attention`` (CUDA kernel on the card,
    plain version on CPU); the padded value rows are zeroed after the
    projection (``attention.py:159-160``)."""

    def __init__(self, embed_dim: int = 256, num_levels: int = 4,
                 num_heads: int = 8, num_points: int = 4):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_levels = num_levels
        self.num_heads = num_heads
        self.num_points = num_points
        self.sampling_offsets = Linear(embed_dim, num_heads * num_levels * num_points * 2)
        self.attention_weights = Linear(embed_dim, num_heads * num_levels * num_points)
        self.value_proj = Linear(embed_dim, embed_dim)
        self.output_proj = Linear(embed_dim, embed_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(
                sampling_offsets_bias(self.num_heads, self.num_levels, self.num_points)
            )
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        xavier_(self.value_proj, generator)
        xavier_(self.output_proj, generator)

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C)
        reference_points: torch.Tensor,  # (B, Q, L, 2) or (B, Q, L, 4), in [0, 1]
        value: torch.Tensor,  # (B, S, C)
        spatial_shapes: Sequence[Tuple[int, int]],
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
    ) -> torch.Tensor:
        bs, num_queries, _ = query.shape
        h, l, p = self.num_heads, self.num_levels, self.num_points
        value = self.value_proj(value)
        if key_padding_mask is not None:
            value = value.masked_fill(key_padding_mask[..., None], 0.0)
        value = value.reshape(bs, value.shape[1], h, self.embed_dim // h)

        # rounded to the compute dtype by the projections, then fp32: the
        # rounded offsets are what the locations are made of, as in JAX
        offsets = self.sampling_offsets(query).float().reshape(bs, num_queries, h, l, p, 2)
        weights = self.attention_weights(query).float().reshape(bs, num_queries, h, l * p)
        weights = torch.softmax(weights, dim=-1).reshape(bs, num_queries, h, l, p)

        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor(
                [(w_, h_) for h_, w_ in spatial_shapes], dtype=torch.float32,
                device=query.device,
            )
            locations = (
                reference_points[:, :, None, :, None, :]
                + offsets / normalizer[None, None, None, :, None, :]
            )
        elif reference_points.shape[-1] == 4:
            locations = (
                reference_points[:, :, None, :, None, :2]
                + offsets / p * reference_points[:, :, None, :, None, 2:] * 0.5
            )
        else:
            raise ValueError(
                f"reference_points last dim must be 2 or 4, got {reference_points.shape[-1]}"
            )
        if _SAMPLING_RECORD is not None:
            _SAMPLING_RECORD.append((self, locations, weights, tuple(spatial_shapes)))
        output = multi_scale_deformable_attention(
            value.contiguous(), tuple(spatial_shapes), locations.contiguous(),
            weights.contiguous(),
        )
        return self.output_proj(output)
