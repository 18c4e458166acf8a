"""The forward kernels as ``torch.library`` ops, namespace ``relation_detr``.

One op per forward kernel, so that ``torch.export`` can trace the eval
forward (fake tensors have no data pointer for a ``ctypes`` launch) and
``torch.utils.flop_counter.FlopCounterMode`` can count the kernels
(``utils/flops.py``):

- ``msda_fwd(value, spatial_shapes, sampling_locations, attention_weights)``:
  ``csrc/msda.cu::msda_fwd``, or ``msda_fwd_bf16`` on a bf16 value; the
  levels' (h, w) flattened to ``int[]``;
- ``relation_bias_v4_fwd(src_boxes, tgt_boxes, kernel, bias, embed_dim,
  temperature, scale, eps)``: ``csrc/relation_bias.cu``;
- ``relation_bias_rel_fwd(rel, kernel, bias, embed_dim, temperature,
  scale)``: ``csrc/relation_bias_rel.cu``;
- ``tiled_core_fwd(m_all, w_all, patch, num_heads, head_dim)`` and
  ``sep_contract_fwd(oy, ox, patch)``: ``csrc/tiled_msda.cu``;
- ``bilinear_sample_fwd(feat, points)``: ``csrc/grid_sample.cu``.

This module defines the schemas and the fake implementations (output shape
and dtype); the modules that own the kernels register the two device
implementations with ``impl``: on ``CUDA`` the ``ctypes`` launch, which
counts the launch on its wrapper's ``.launches``; on ``CPU`` the plain
version. No other device has an implementation, so the dispatcher raises.
The wrappers (``multi_scale_deformable_attention``, ``relation_bias_v4``,
``fused_relation_bias``, ``tiled_matmul_core``, ``sep_contract_fused``,
``bilinear_sample``) call an op directly when no input needs a gradient, and through their
``autograd.Function``s otherwise, whose forwards call the same op; the
backward kernels stay behind those functions.

The ops are defined with ``Library.define`` and ``Library.impl``, not
``torch.library.custom_op``, whose Python wrapper costs several times the
dispatcher's own per call (this eval forward makes 17 calls). A program
saved by ``torch.export.save`` names the ops; ``load_ops`` registers all of
them before ``torch.export.load``.
"""
from __future__ import annotations

import torch

NAMESPACE = "relation_detr"
LIB = torch.library.Library(NAMESPACE, "DEF")

LIB.define("msda_fwd(Tensor value, int[] spatial_shapes, Tensor sampling_locations, "
           "Tensor attention_weights) -> Tensor")
LIB.define("relation_bias_v4_fwd(Tensor src_boxes, Tensor tgt_boxes, Tensor kernel, "
           "Tensor bias, int embed_dim, float temperature, float scale, float eps) -> Tensor")
LIB.define("relation_bias_rel_fwd(Tensor rel, Tensor kernel, Tensor bias, int embed_dim, "
           "float temperature, float scale) -> Tensor")
LIB.define("tiled_core_fwd(Tensor m_all, Tensor w_all, Tensor patch, int num_heads, "
           "int head_dim) -> Tensor")
LIB.define("sep_contract_fwd(Tensor oy, Tensor ox, Tensor patch) -> Tensor")
LIB.define("bilinear_sample_fwd(Tensor feat, Tensor points) -> Tensor")

OPS = torch.ops.relation_detr
NAMES = ("msda_fwd", "relation_bias_v4_fwd", "relation_bias_rel_fwd", "tiled_core_fwd",
         "sep_contract_fwd", "bilinear_sample_fwd")


def impl(name: str, cpu, cuda) -> None:
    """Register op ``name``'s plain version (``cpu``) and its kernel launch
    (``cuda``)."""
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")


def levels(spatial_shapes) -> tuple:
    """The flat ``int[]`` of an op's ``spatial_shapes`` back to (h, w) pairs."""
    flat = [int(v) for v in spatial_shapes]
    return tuple(zip(flat[0::2], flat[1::2]))


def flat_levels(spatial_shapes) -> list:
    """(h, w) pairs as the ops' flat ``int[]``."""
    return [int(v) for hw in spatial_shapes for v in hw]


def load_ops() -> None:
    """Import the modules that register the implementations (for a loader of
    a saved program that imports nothing else of the package)."""
    from relation_detr_tpu_torch.ops import (  # noqa: F401
        grid_sample,
        msda,
        msda_tiled,
        relation_bias,
    )


@torch.library.register_fake("relation_detr::msda_fwd")
def _msda_fwd_fake(value, spatial_shapes, sampling_locations, attention_weights):
    bs, _, num_heads, head_dim = value.shape
    return value.new_empty(bs, sampling_locations.shape[1], num_heads * head_dim)


@torch.library.register_fake("relation_detr::relation_bias_v4_fwd")
def _relation_bias_v4_fake(src_boxes, tgt_boxes, kernel, bias, embed_dim, temperature, scale,
                           eps):
    return src_boxes.new_empty(src_boxes.shape[0], kernel.shape[1], src_boxes.shape[1],
                               tgt_boxes.shape[1], dtype=torch.float32)


@torch.library.register_fake("relation_detr::relation_bias_rel_fwd")
def _relation_bias_rel_fake(rel, kernel, bias, embed_dim, temperature, scale):
    bs, n1, n2, _ = rel.shape
    return rel.new_empty(bs, bias.shape[0], n1, n2, dtype=torch.float32)


@torch.library.register_fake("relation_detr::tiled_core_fwd")
def _tiled_core_fake(m_all, w_all, patch, num_heads, head_dim):
    bs, nt, _, _, t = m_all.shape
    return patch.new_empty(bs, nt, t, patch.shape[3], dtype=torch.float32)


@torch.library.register_fake("relation_detr::sep_contract_fwd")
def _sep_contract_fake(oy, ox, patch):
    bs, nt = oy.shape[:2]
    return patch.new_empty(bs, nt, oy.shape[5], patch.shape[3], dtype=torch.float32)


@torch.library.register_fake("relation_detr::bilinear_sample_fwd")
def _bilinear_sample_fake(feat, points):
    return feat.new_empty(feat.shape[0], points.shape[1], feat.shape[3])


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``: the wrappers then
    go through their ``autograd.Function``s, else straight to the op."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
