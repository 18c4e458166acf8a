"""Port ops (relation_detr_tpu_torch.ops / position_encoding) against the JAX
package on the same numpy inputs, forward and backward. On CPU the port's
kernel wrappers take their plain versions; the JAX Pallas kernels (relation
bias, window accumulate) run in interpret mode.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relation_detr_tpu.models import position_encoding as jpe
from relation_detr_tpu.models.relation import box_rel_encoding as j_box_rel
from relation_detr_tpu.ops import boxes as jboxes
from relation_detr_tpu.ops import msda as j_msda_mod
from relation_detr_tpu.ops.hungarian import hungarian_assignment as j_hungarian
from relation_detr_tpu.ops.msda import multi_scale_deformable_attention as j_msda
from relation_detr_tpu.ops.patch_scatter import window_accumulate as j_window_accumulate
from relation_detr_tpu.ops.relation_pallas import _reference_bias, fused_relation_bias_v4
from relation_detr_tpu_torch.models import position_encoding as tpe
from relation_detr_tpu_torch.models.relation import box_rel_encoding as t_box_rel
from relation_detr_tpu_torch.ops import boxes as tboxes
from relation_detr_tpu_torch.ops import hungarian, patch_scatter
from relation_detr_tpu_torch.ops.msda import (
    msda_backward,
    msda_backward_reference,
    msda_reference,
    multi_scale_deformable_attention,
)
from relation_detr_tpu_torch.ops.relation_bias import (
    relation_bias_v4,
    relation_bias_v4_backward,
    relation_bias_v4_reference,
)


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


def test_box_iou_family_matches_jax():
    """Pairwise GIoU and the elementwise IoU/GIoU, with disjoint, nested and
    degenerate (zero-area) boxes: atol 1e-6."""
    rng = np.random.RandomState(1)
    a = jboxes.box_cxcywh_to_xyxy(jnp.asarray(rng.rand(3, 9, 4).astype(np.float32) * 0.6 + 0.05))
    b = jboxes.box_cxcywh_to_xyxy(jnp.asarray(rng.rand(3, 9, 4).astype(np.float32) * 0.6 + 0.05))
    a = a.at[0, 0].set(jnp.asarray([0.1, 0.1, 0.1, 0.3]))  # zero width
    b = b.at[0, 1].set(a[0, 1] * 0.5 + 0.25)  # overlapping, shifted
    ta, tb = _t(a), _t(b)
    for name in ("generalized_box_iou", "elementwise_box_iou", "elementwise_generalized_box_iou"):
        got = getattr(tboxes, name)(ta, tb).numpy()
        want = np.asarray(getattr(jboxes, name)(a, b))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tboxes.box_xyxy_to_cxcywh(ta).numpy(),
                               np.asarray(jboxes.box_xyxy_to_cxcywh(a)), atol=1e-6)


@pytest.mark.parametrize("layout", ["encoder", "decoder"])
def test_msda_grads_match_jax(layout):
    """Gradients of the MSDA core for value, locations and weights: the
    port's plain backward (``msda_backward_reference``, autograd through
    ``msda_reference``; the CUDA ``msda_bwd`` is held against it on the
    card) vs jax.vjp of the JAX gather spec, with locations out of range on
    every side, on the borders and on a zero-weight corner: atol 1e-5."""
    num_queries = sum(h * w for h, w in SHAPES) if layout == "encoder" else 23
    value, locs, attn = _msda_inputs(5, num_queries)
    cot = np.random.RandomState(6).randn(2, num_queries, 32).astype(np.float32)
    _, vjp = jax.vjp(lambda v, l, a: j_msda(v, SHAPES, l, a, impl="gather"),
                     jnp.asarray(value), jnp.asarray(locs), jnp.asarray(attn))
    want = vjp(jnp.asarray(cot))
    got = msda_backward_reference(_t(value), SHAPES, _t(locs), _t(attn), _t(cot))
    for name, g, w in zip(("value", "locations", "weights"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    # the wrapper's CPU path is differentiable and launches nothing
    v, l, a = (_t(x).requires_grad_(True) for x in (value, locs, attn))
    launches = (multi_scale_deformable_attention.launches, msda_backward.launches)
    multi_scale_deformable_attention(v, SHAPES, l, a).backward(_t(cot))
    for t, w in zip((v, l, a), got):  # the scatter-add's order may vary: 1 ulp
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), rtol=0, atol=1e-6)
    assert (multi_scale_deformable_attention.launches, msda_backward.launches) == launches


@pytest.mark.parametrize("case", ["2x33x47", "extreme"])
def test_relation_bias_grads_match_jax(case):
    """kernel/bias gradients of the v4 bias vs jax.vjp through
    ``fused_relation_bias_v4`` (Pallas interpret mode forward, its XLA
    separable backward): rtol 1e-4 on each leaf's max |grad|; box gradients
    are zero on both sides. The CUDA path's backward
    (``relation_bias_v4_backward``) must give the plain path's gradients."""
    if case == "extreme":
        src, tgt, kernel, bias = _relation_inputs(8, 1, 24, 17, extreme=True)
    else:
        src, tgt, kernel, bias = _relation_inputs(7, 2, 33, 47)
    cot = np.random.RandomState(9).randn(src.shape[0], 8, src.shape[1], tgt.shape[1])
    cot = cot.astype(np.float32)
    _, vjp = jax.vjp(fused_relation_bias_v4, *(jnp.asarray(x) for x in (src, tgt, kernel, bias)))
    want = vjp(jnp.asarray(cot))
    assert not np.asarray(want[0]).any() and not np.asarray(want[1]).any()
    ts, tt, tk, tb = (_t(x).requires_grad_(True) for x in (src, tgt, kernel, bias))
    relation_bias_v4(ts, tt, tk, tb).backward(_t(cot))
    assert ts.grad is None and tt.grad is None  # boxes are constants
    for name, g, w in (("kernel", tk.grad, want[2]), ("bias", tb.grad, want[3])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), err_msg=name)
    dk, db = relation_bias_v4_backward(_t(src), _t(tgt), _t(kernel), _t(bias), _t(cot))
    np.testing.assert_array_equal(dk.numpy(), tk.grad.numpy())
    np.testing.assert_array_equal(db.numpy(), tb.grad.numpy())


def _window_loop(g, y0s, x0s, h, w):
    out = np.zeros((h, w, g.shape[-1]), np.float32)
    for k in range(g.shape[0]):
        out[y0s[k]:y0s[k] + g.shape[1], x0s[k]:x0s[k] + g.shape[2]] += g[k]
    return out


@pytest.mark.parametrize("case", ["random", "level0", "stacked"])
def test_window_accumulate_matches_jax_kernel(case):
    """The plain window_accumulate vs the Pallas kernel (interpret mode) and
    the numpy loop: bit for bit, since all three add the windows in
    ascending order. ``level0`` is the flagship's encoder level-0 window
    grid (stored in the port as constants) with fewer channels; ``stacked``
    puts most windows on two origins, with values of mixed magnitude, so
    any other addition order rounds differently."""
    rng = np.random.RandomState(10)
    if case == "level0":
        y0s, x0s = patch_scatter.level0_origins()
        (h, w), (ph, pw), c = patch_scatter.LEVEL0_CANVAS, patch_scatter.LEVEL0_WINDOW, 8
    elif case == "stacked":
        (h, w), (ph, pw), c = (9, 11), (5, 4), 16
        y0s = np.array([0, 2, 0, 2, 0, 4, 2, 0, 2, 0], np.int32)
        x0s = np.array([0, 3, 0, 3, 0, 7, 3, 0, 3, 1], np.int32)
        g = rng.randn(len(y0s), ph, pw, c) * 10.0 ** rng.randint(-4, 5, (len(y0s), 1, 1, 1))
        g = g.astype(np.float32)
    else:
        (h, w), (ph, pw), c = (20, 25), (7, 6), 256
        y0s = rng.randint(0, h - ph + 1, 12).astype(np.int32)
        x0s = rng.randint(0, w - pw + 1, 12).astype(np.int32)
    if case != "stacked":
        g = rng.randn(len(y0s), ph, pw, c).astype(np.float32)
    got = patch_scatter.window_accumulate(_t(g), y0s, x0s, h, w).numpy()
    np.testing.assert_array_equal(got, _window_loop(g, y0s, x0s, h, w))
    np.testing.assert_array_equal(got, np.asarray(j_window_accumulate(jnp.asarray(g), y0s, x0s, h, w)))
    assert patch_scatter.window_accumulate.launches == 0


def test_level0_window_grid_matches_jax_geometry():
    """The stored level-0 origins and window size are what the JAX tiled
    MSDA's geometry gives for the flagship's levels at the default settings
    (tiled_tile_tokens (12, 8), tiled_margin 1, halos "auto" = P + 1)."""
    levels = ((100, 168), (50, 84), (25, 42), (13, 21))
    defaults = j_msda_mod._MSDA_DEFAULTS
    assert defaults["tiled_tile_tokens"] == (12, 8) and defaults["tiled_margin"] == 1
    assert defaults["tiled_halos"] == "auto"
    geo = j_msda_mod._tile_geometry(levels, (12, 8), (4 + 1,) * 4, 1)
    y0s, x0s, ph, pw = geo.patches[0]
    assert (ph, pw) == patch_scatter.LEVEL0_WINDOW
    assert geo.patch_grid[0] == (patch_scatter.LEVEL0_ROWS, patch_scatter.LEVEL0_COLS)
    got = patch_scatter.level0_origins()
    np.testing.assert_array_equal(got[0], y0s)
    np.testing.assert_array_equal(got[1], x0s)


def test_hungarian_matches_scipy_and_jax_solver():
    """The host solver over the valid rows reaches the JAX on-device
    solver's optimal cost (padded rows carry no cost there): rtol 1e-6."""
    rng = np.random.RandomState(11)
    cost = rng.rand(9, 30).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 1, 0], bool)
    got = hungarian.hungarian_assignment(cost, mask)
    assert (got[~mask] == -1).all() and len(set(got[mask])) == mask.sum()
    want = np.asarray(j_hungarian(jnp.asarray(cost), jnp.asarray(mask)))
    rows = np.flatnonzero(mask)
    np.testing.assert_allclose(cost[rows, got[rows]].sum(), cost[rows, want[rows]].sum(),
                               rtol=1e-6)
