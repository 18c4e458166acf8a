"""Operation counts of the port's kernels for ``FlopCounterMode``.

``torch.utils.flop_counter.FlopCounterMode`` counts the matmuls and
convolutions of a call, and nothing inside a kernel launched through
``ctypes``. The forward kernels are ops of ``ops/library.py``; importing this
module registers one formula per op with ``register_flop_formula``, so the
counter sees them. Each formula is the operation count of the ``bound``
column of PERF.md's kernel table (``chip_smoke.py``'s bounds): an FMA counts
two operations, a sine or a cosine one.

- ``msda_fwd``: 10 B Q H D L P: per (query, head, level, point, channel)
  four corner FMAs and the attention weight's FMA.
- ``relation_bias_v4_fwd``: B N1 N2 (2 E + 8 E H): per box pair 2 E sines
  and cosines (the xy half: 2 coordinates x E / 2 frequencies) and, per
  head, 2 E FMAs for the xy features and 2 E for the wh half's bilinear
  form. The per-box wh features (O(N)) are left out.
- ``relation_bias_rel_fwd``: B N1 N2 (4 E + 8 E H): per pair 4 E sines and
  cosines and 4 E FMAs a head.
- ``tiled_core_fwd``: 2 B nt H E T D: one FMA per (entry, slot, channel).
- ``sep_contract_fwd``: 2 B nt H ph pw T (P + D): per head the A build (P
  FMAs an entry of the ph pw x T matrix) and the contraction (D FMAs an
  entry).

The counts are the arithmetic the function needs, not what a kernel
executes (a masked corner still counts), so they are the numerator of an
MFU as the bench reports it.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from relation_detr_tpu_torch.ops import library


def msda_fwd_flops(value_shape, sampling_locations_shape) -> int:
    bs, _, num_heads, head_dim = value_shape
    _, num_queries, _, num_levels, num_points, _ = sampling_locations_shape
    return 10 * bs * num_queries * num_heads * head_dim * num_levels * num_points


def relation_bias_v4_flops(src_shape, tgt_shape, num_heads: int, embed_dim: int) -> int:
    pairs = src_shape[0] * src_shape[1] * tgt_shape[1]
    return pairs * (2 * embed_dim + 2 * 4 * embed_dim * num_heads)


def relation_bias_rel_flops(rel_shape, num_heads: int, embed_dim: int) -> int:
    pairs = rel_shape[0] * rel_shape[1] * rel_shape[2]
    return pairs * (4 * embed_dim + 2 * 4 * embed_dim * num_heads)


def tiled_core_flops(m_shape, head_dim: int) -> int:
    bs, nt, num_heads, entries, slots = m_shape
    return 2 * bs * nt * num_heads * entries * slots * head_dim


def sep_contract_flops(oy_shape, ox_shape, patch_shape) -> int:
    bs, nt, num_heads, points, ph, slots = oy_shape
    head_dim = patch_shape[3] // num_heads
    return 2 * bs * nt * num_heads * ph * ox_shape[4] * slots * (points + head_dim)


def bilinear_sample_flops(feat_shape, points_shape) -> int:
    return 8 * points_shape[0] * points_shape[1] * feat_shape[3]


@register_flop_formula(library.OPS.msda_fwd)
def _msda_fwd(value, spatial_shapes, sampling_locations, attention_weights, **kwargs):
    return msda_fwd_flops(value, sampling_locations)


@register_flop_formula(library.OPS.relation_bias_v4_fwd)
def _relation_bias_v4_fwd(src, tgt, kernel, bias, embed_dim, *args, **kwargs):
    return relation_bias_v4_flops(src, tgt, kernel[1], embed_dim)


@register_flop_formula(library.OPS.relation_bias_rel_fwd)
def _relation_bias_rel_fwd(rel, kernel, bias, embed_dim, *args, **kwargs):
    return relation_bias_rel_flops(rel, bias[0], embed_dim)


@register_flop_formula(library.OPS.tiled_core_fwd)
def _tiled_core_fwd(m_all, w_all, patch, num_heads, head_dim, **kwargs):
    return tiled_core_flops(m_all, head_dim)


@register_flop_formula(library.OPS.sep_contract_fwd)
def _sep_contract_fwd(oy, ox, patch, **kwargs):
    return sep_contract_flops(oy, ox, patch)


@register_flop_formula(library.OPS.bilinear_sample_fwd)
def _bilinear_sample_fwd(feat, points, **kwargs):
    return bilinear_sample_flops(feat, points)


OP_PACKETS = tuple(getattr(library.OPS, name) for name in library.NAMES)


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[object, int, Dict[str, int]]:
    """Run ``fn(*args, **kwargs)`` without gradients under
    ``FlopCounterMode``: (its result, the total count, the count of each op
    of ``ops/library.py`` that ran, by name). A model's parameters must not
    require gradients (``model.requires_grad_(False)``): the counter's module
    tracker hooks every input that does."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    counts = counter.get_flop_counts()["Global"]
    ops = {packet._qualified_op_name.split("::")[1]: int(counts[packet])
           for packet in OP_PACKETS if packet in counts}
    return out, int(counter.get_total_flops()), ops
