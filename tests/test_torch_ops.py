"""Port ops (relation_detr_tpu_torch.ops / position_encoding) against the JAX
package on the same numpy inputs. On CPU the port's kernel wrappers take
their plain versions; the JAX relation kernel runs in Pallas interpret mode.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relation_detr_tpu.models import position_encoding as jpe
from relation_detr_tpu.models.relation import box_rel_encoding as j_box_rel
from relation_detr_tpu.ops import boxes as jboxes
from relation_detr_tpu.ops.msda import multi_scale_deformable_attention as j_msda
from relation_detr_tpu.ops.relation_pallas import _reference_bias, fused_relation_bias_v4
from relation_detr_tpu_torch.models import position_encoding as tpe
from relation_detr_tpu_torch.models.relation import box_rel_encoding as t_box_rel
from relation_detr_tpu_torch.ops import boxes as tboxes
from relation_detr_tpu_torch.ops.msda import msda_reference, multi_scale_deformable_attention
from relation_detr_tpu_torch.ops.relation_bias import relation_bias_v4, relation_bias_v4_reference


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_boxes_and_sine_embeddings_match_jax():
    rng = np.random.RandomState(0)
    boxes = rng.rand(2, 7, 4).astype(np.float32)
    np.testing.assert_allclose(
        tboxes.box_cxcywh_to_xyxy(_t(boxes)).numpy(),
        np.asarray(jboxes.box_cxcywh_to_xyxy(jnp.asarray(boxes))), atol=1e-6)
    x = rng.uniform(-0.2, 1.2, (3, 50)).astype(np.float32)
    np.testing.assert_allclose(
        tboxes.inverse_sigmoid(_t(x)).numpy(),
        np.asarray(jboxes.inverse_sigmoid(jnp.asarray(x))), atol=1e-6)

    mask = np.zeros((2, 9, 13), bool)
    mask[1, 6:] = True
    mask[1, :, 10:] = True
    np.testing.assert_allclose(
        tpe.position_embedding_sine(_t(mask), num_pos_feats=32).numpy(),
        np.asarray(jpe.position_embedding_sine(jnp.asarray(mask), num_pos_feats=32)),
        atol=1e-6)
    for exchange_xy in (True, False):
        np.testing.assert_allclose(
            tpe.get_sine_pos_embed(_t(boxes), 64, exchange_xy=exchange_xy).numpy(),
            np.asarray(jpe.get_sine_pos_embed(jnp.asarray(boxes), 64, exchange_xy=exchange_xy)),
            atol=1e-6)
    src, tgt = boxes[:, :5] * 0.9 + 0.01, boxes[:, 2:] * 0.9 + 0.01
    np.testing.assert_allclose(
        t_box_rel(_t(src), _t(tgt)).numpy(),
        np.asarray(j_box_rel(jnp.asarray(src), jnp.asarray(tgt))), atol=1e-5)


SHAPES = ((13, 17), (7, 9), (4, 5), (2, 3))


def _msda_inputs(seed, num_queries, bs=2, num_heads=4, head_dim=8, num_points=4):
    """Locations in [-0.3, 1.3] (out of range on every side) plus exact
    border and pixel-center points."""
    rng = np.random.RandomState(seed)
    total = sum(h * w for h, w in SHAPES)
    value = rng.randn(bs, total, num_heads, head_dim).astype(np.float32)
    locs = rng.uniform(-0.3, 1.3, (bs, num_queries, num_heads, len(SHAPES), num_points, 2))
    locs[:, 0, :, :, 0] = 0.0
    locs[:, 0, :, :, 1] = 1.0
    locs[:, 1, :, 0, 0] = (1.5 / 17, 0.5 / 13)  # a pixel centre of level 0
    locs[:, 1, :, 0, 1] = (-0.5 / 17, 1.0)  # pixel x = -1: a zero-weight corner
    attn = rng.rand(bs, num_queries, num_heads, len(SHAPES), num_points)
    attn /= attn.reshape(bs, num_queries, num_heads, -1).sum(-1)[..., None, None]
    return value, locs.astype(np.float32), attn.astype(np.float32)


@pytest.mark.parametrize("layout", ["encoder", "decoder"])
def test_msda_reference_matches_jax_gather(layout):
    num_queries = sum(h * w for h, w in SHAPES) if layout == "encoder" else 23
    value, locs, attn = _msda_inputs(3, num_queries)
    want = np.asarray(j_msda(jnp.asarray(value), SHAPES, jnp.asarray(locs),
                             jnp.asarray(attn), impl="gather"))
    got = msda_reference(_t(value), SHAPES, _t(locs), _t(attn)).numpy()
    assert got.shape == (2, num_queries, 32)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the wrapper takes the plain version on CPU and launches nothing
    launches = multi_scale_deformable_attention.launches
    np.testing.assert_array_equal(
        multi_scale_deformable_attention(_t(value), SHAPES, _t(locs), _t(attn)).numpy(), got)
    assert multi_scale_deformable_attention.launches == launches


def _relation_inputs(seed, b, n1, n2, extreme=False):
    rng = np.random.RandomState(seed)
    if extreme:  # tiny w/h: large log-ratio angles
        src = np.concatenate([rng.rand(b, n1, 2), 10 ** rng.uniform(-4.5, 0, (b, n1, 2))], -1)
        tgt = np.concatenate([rng.rand(b, n2, 2), 10 ** rng.uniform(-4.5, 0, (b, n2, 2))], -1)
    else:
        src = rng.rand(b, n1, 4) * 0.9 + 0.01
        tgt = rng.rand(b, n2, 4) * 0.9 + 0.01
    kernel = rng.randn(64, 8) * 0.1
    bias = rng.randn(8) * 0.1
    return [a.astype(np.float32) for a in (src, tgt, kernel, bias)]


@pytest.mark.parametrize("case", ["1x60x60", "2x33x47", "extreme", "nan_box"])
def test_relation_bias_v4_reference_matches_jax_kernel(case):
    if case in ("extreme", "nan_box"):
        src, tgt, kernel, bias = _relation_inputs(5, 1, 24, 17, extreme=True)
    else:
        b, n1, n2 = (int(v) for v in case.split("x"))
        src, tgt, kernel, bias = _relation_inputs(4, b, n1, n2)
    if case == "nan_box":
        src[0, 3, :2] = np.nan  # NaN centre: the ratio clamp makes it finite
        tgt[0, 5, 0] = np.inf
    want = np.asarray(fused_relation_bias_v4(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(kernel), jnp.asarray(bias)))
    got = relation_bias_v4_reference(_t(src), _t(tgt), _t(kernel), _t(bias)).numpy()
    assert got.shape == want.shape == (src.shape[0], 8, src.shape[1], tgt.shape[1])
    if case == "nan_box":
        assert np.isfinite(got).all() and np.isfinite(want).all()
    # same math, same clamp. Normal boxes: fp32 summation order only. Tiny
    # w/h: angles reach ~1e3 rad, where XLA's log (up to 1.06 ulp, measured)
    # and torch's (0.53 ulp) differ by one ulp on ~4% of inputs, which moves
    # the bias by ~1e-5
    atol = 5e-5 if case in ("extreme", "nan_box") else 1e-5
    np.testing.assert_allclose(got, want, atol=atol)
    launches = relation_bias_v4.launches
    np.testing.assert_array_equal(
        relation_bias_v4(_t(src), _t(tgt), _t(kernel), _t(bias)).numpy(), got)
    assert relation_bias_v4.launches == launches


@pytest.mark.parametrize("shape", [(1, 60, 60), (2, 33, 47)])
def test_relation_bias_v4_reference_matches_direct_path(shape):
    src, tgt, kernel, bias = _relation_inputs(6, *shape)
    rel = j_box_rel(jnp.asarray(src), jnp.asarray(tgt))
    want = np.asarray(_reference_bias(rel, jnp.asarray(kernel), jnp.asarray(bias),
                                      16, 10000.0, 100.0))
    got = relation_bias_v4_reference(_t(src), _t(tgt), _t(kernel), _t(bias)).numpy()
    # separable wh regrouping at large angles: the JAX tests' tolerance
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert math.isfinite(float(got.sum()))
