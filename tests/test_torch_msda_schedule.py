"""The gather MSDA kernels' schedules (``csrc/msda.cu``: ``msda_fwd``,
``msda_bwd``), emulated on the CPU from what their wrappers hand them,
against the plain versions and the JAX gather.

What is emulated, step by step, with the kernels' own block size (read
from the source): the lanes per item and channels per lane; the items each
block takes, (b, q, head) in memory order; the coalesced location loads,
two samples per lane in chunks that cross levels, and their broadcast;
each corner's value gradient sent as one vector atomic per lane; the
reduce-scatter that sums the location and weight gradients over an item's
lanes. The emulations run in float64 (the schedule, not fp32 rounding, is
under test: the card holds the kernels' rounding against the plain
versions, ``chip_smoke.py`` phase 3 and the card-only tests in
``test_torch_no_jax.py``).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relation_detr_tpu.ops.msda import multi_scale_deformable_attention as j_msda
from relation_detr_tpu_torch.ops import msda

from msda_inputs import close_where_finite, encoder_like

SOURCE = Path(msda.__file__).resolve().parent.parent / "csrc" / "msda.cu"
K = {name: int(v) for name, v in
     re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}
assert "kThreads" in K
FLAGSHIP_TOKENS = 100 * 168 + 50 * 84 + 25 * 42 + 13 * 21  # the encoder's Q = S
SMALL_LEVELS = ((19, 21), (10, 11), (5, 6), (3, 3))


def _lanes(d, itemsize=4, backward=False):
    """(channels per lane kV, lanes per item G) as the C entries pick them
    for 16-byte aligned tensors of ``itemsize``-byte values (4: fp32, 2: the
    bf16-value forms); the backward takes at most 4 channels a lane."""
    kv = min(16 // itemsize, 4) if backward else 16 // itemsize
    while d % kv:
        kv //= 2
    g = 1
    while g < -(-d // kv) and g < 32:
        g *= 2
    return kv, g


def _starts(levels):
    return np.concatenate([[0], np.cumsum([h * w for h, w in levels])])


def _block_items(batch, num_queries, heads, g):
    """Both kernels' blocks: kThreads / G consecutive (b, q, head) items
    each; returns per block the (b, q, head) of each lane group, -1 past
    the last item."""
    per = K["kThreads"] // g
    total = batch * num_queries * heads
    blocks = []
    for start in range(0, total, per):
        i = np.arange(start, start + per)
        valid = i < total
        i = np.minimum(i, total - 1)
        bq, h = np.divmod(i, heads)
        blocks.append((np.where(valid, bq // num_queries, -1), np.where(valid, bq % num_queries, -1),
                       np.where(valid, h, -1)))
    return blocks


def _chunk_samples(loc, attn, lvl, num_levels, num_points, g):
    """The level's samples of n items (loc (n, L*P, 2), attn (n, L*P)) as
    the lanes see them: the item's L*P samples in chunks of 2G across level
    boundaries; lane j of an item's group loads samples s0 + 2j and
    s0 + 2j + 1 of each chunk (those below L*P), and sample r of the chunk
    is read from lane r // 2, slot r % 2."""
    xs, ys, ws = [], [], []
    for p in range(num_points):
        r = (lvl * num_points + p) % (2 * g)
        s0 = lvl * num_points + p - r  # the chunk's first sample
        lane, slot = r >> 1, r & 1
        s = s0 + 2 * lane + slot
        assert s < num_levels * num_points
        xs.append(loc[:, s, 0])
        ys.append(loc[:, s, 1])
        ws.append(attn[:, s])
    return np.stack(xs, 1), np.stack(ys, 1), np.stack(ws, 1)


def _pixel(loc, size):
    """``pixel_coord``: loc * size - 0.5, rounded after each operation."""
    return (np.float32(loc) * np.float32(size)).astype(np.float32) - np.float32(0.5)


def _corners(x, y, h, w):
    """The four corners (dy, dx, row y, col x, bilinear weight, in level)
    of samples at pixel coordinates x, y; empty where the sample is
    outside [-1, w) x [-1, h) (the backward's test)."""
    inside = (x >= -1) & (y >= -1) & (x < w) & (y < h)
    x0f, y0f = np.floor(x), np.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)
    out = []
    for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                        (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        cy, cx = y0 + dy, x0 + dx
        ok = inside & (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        out.append((cy, cx, wgt, ok))
    return out, fx, fy


def _store_sample_grads(ga, gx, gy):
    """``store_sample_grads`` over the G lanes of an item (last axis): the
    reduce-scatter's rounds on lane bits 0 and 1, then full rounds on the
    higher bits; returns what the storing lanes write (ga, gx, gy)."""
    g = ga.shape[-1]
    if g == 1:
        return ga[..., 0], gx[..., 0], gy[..., 0]
    j = np.arange(g)
    b0 = (j & 1).astype(bool)
    zero = np.zeros_like(ga)
    ka = np.where(b0, gy, ga) + np.where(b0, ga, gy)[..., j ^ 1]
    kb = np.where(b0, zero, gx) + np.where(b0, gx, zero)[..., j ^ 1]
    if g == 2:
        return ka[..., 0], kb[..., 0], ka[..., 1]
    b1 = (j & 2).astype(bool)
    v = np.where(b1, kb, ka) + np.where(b1, ka, kb)[..., j ^ 2]
    off = 4
    while off < g:
        v = v + v[..., j ^ off]
        off *= 2
    return v[..., 0], v[..., 2], v[..., 1]


def _sample_grads(value, levels, lvl, b, q, h, sx, sy, a, g, kv, gl_, ga_, gv, p, num_points):
    """One sample of n lane groups (arrays over n): the corner weights and
    rows, the output term, and the location and weight gradients through
    the lanes' partial sums and the reduce-scatter, stored into gl_ / ga_;
    a NaN location adds NaN to the level's first value row. Returns
    (present, y0, x0, corner contributions (n, 4, D), has (n, 4), s (n, D))."""
    hl, wl = levels[lvl]
    start = int(_starts(levels)[lvl])
    x, y = _pixel(sx, wl), _pixel(sy, hl)
    bad = np.isnan(x) | np.isnan(y)
    corners, fx, fy = _corners(np.where(bad, -8.0, x), np.where(bad, -8.0, y), hl, wl)
    vals = []
    for cy, cx, _, ok in corners:
        rows = start + np.where(ok, cy * wl + cx, 0)
        vals.append(np.where(ok[:, None], value[b, rows, h], 0.0))
    v00, v01, v10, v11 = vals
    s = sum(v * wgt[:, None] for v, (_, _, wgt, _) in zip(vals, corners))

    def part(t):  # each lane's sum over its kv channels
        return (g * t).reshape(len(t), -1, kv).sum(-1)

    p_a = part(s)
    p_x = part((v01 - v00) * (1 - fy[:, None]) + (v11 - v10) * fy[:, None]) * (a * wl)[:, None]
    p_y = part((v10 - v00) * (1 - fx[:, None]) + (v11 - v01) * fx[:, None]) * (a * hl)[:, None]
    s_a, s_x, s_y = _store_sample_grads(p_a, p_x, p_y)
    o = lvl * num_points + p
    ga_[b, q, h, o // num_points, o % num_points] = np.where(bad, np.nan, s_a)
    gl_[b, q, h, o // num_points, o % num_points, 0] = np.where(bad, np.nan, s_x)
    gl_[b, q, h, o // num_points, o % num_points, 1] = np.where(bad, np.nan, s_y)
    for n_ in np.nonzero(bad)[0]:
        gv[b[n_], start, h[n_]] += np.nan
    present = ~bad & (x >= -1) & (y >= -1) & (x < wl) & (y < hl)
    contrib = np.stack([(g * a[:, None]) * wgt[:, None] for _, _, wgt, _ in corners], 1)
    has = np.stack([ok for *_, ok in corners], 1) & present[:, None]
    y0 = corners[0][0]
    x0 = corners[0][1]
    return present, y0, x0, contrib, has, s


def _emulate(value, levels, locs, attn, grad_out, itemsize=4):
    """Both kernels' schedules -> (out, grad_value, grad_loc, grad_attn),
    float64, with the lanes of ``itemsize``-byte values."""
    bs, _, heads, d = value.shape
    num_queries, num_levels, num_points = locs.shape[1], locs.shape[3], locs.shape[4]
    kv, g = _lanes(d, itemsize)
    starts = _starts(levels)
    value = value.astype(np.float64)
    gout = grad_out.astype(np.float64).reshape(bs, num_queries, heads, d)
    flat_loc = locs.reshape(bs, num_queries, heads, -1, 2)
    flat_attn = attn.reshape(bs, num_queries, heads, -1)
    out = np.full((bs, num_queries, heads, d), np.inf)
    gv = np.zeros(value.shape)
    gl = np.full(locs.shape, np.inf)
    ga = np.full(attn.shape, np.inf)
    for b, q, h in _block_items(bs, num_queries, heads, g):
        ok = q >= 0
        b, q, h = b[ok], q[ok], h[ok]
        assert np.isinf(out[b, q, h]).all(), "an item written twice"
        acc = np.zeros((len(q), d))
        for lvl, (hl, wl) in enumerate(levels):
            sx, sy, a = _chunk_samples(flat_loc[b, q, h], flat_attn[b, q, h], lvl,
                                       num_levels, num_points, g)
            for p in range(num_points):
                present, y0, x0, contrib, has, s = _sample_grads(
                    value, levels, lvl, b, q, h, sx[:, p], sy[:, p], a[:, p].astype(np.float64),
                    gout[b, q, h], kv, gl, ga, gv, p, num_points)
                bad = np.isnan(_pixel(sx[:, p], wl)) | np.isnan(_pixel(sy[:, p], hl))
                acc = np.where(bad[:, None], np.nan, acc + s * a[:, p, None])
                for c in range(4):  # one vector atomic per corner and lane
                    hit = has[:, c]
                    rows = starts[lvl] + (y0 + (c >> 1)) * wl + x0 + (c & 1)
                    np.add.at(gv, (b[hit], rows[hit], h[hit]), contrib[hit, c])
        out[b, q, h] = acc
    assert not np.isinf(out).any() and not np.isinf(gl).any() and not np.isinf(ga).any()
    return out.reshape(bs, num_queries, heads * d), gv, gl, ga


@jax.jit
def _jax_gather_vjp(value, locs, attn, grad_out):
    """The JAX gather's output and its vjp at grad_out, at SMALL_LEVELS."""
    out, vjp = jax.vjp(lambda v, l, a: j_msda(v, SMALL_LEVELS, l, a, impl="gather"),
                       value, locs, attn)
    return (out, *vjp(grad_out))


@pytest.mark.parametrize("batch,num_queries,heads,head_dim", [
    (1, FLAGSHIP_TOKENS, 8, 32), (2, 548, 3, 16), (2, 41, 3, 8), (1, 5, 1, 1)])
def test_items_cover_every_query_head_once(batch, num_queries, heads, head_dim):
    """The blocks' items cover every (b, q, head) exactly once, at the
    flagship's encoder shape and at ragged ones, for 8, 4, 2 and 1 lanes
    per item."""
    _, g = _lanes(head_dim)
    seen = np.zeros((batch, num_queries, heads), np.int64)
    for b, q, h in _block_items(batch, num_queries, heads, g):
        ok = q >= 0
        np.add.at(seen, (b[ok], q[ok], h[ok]), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("levels,num_points,g", [
    (4, 4, 8), (3, 4, 8), (3, 4, 1), (3, 5, 2), (3, 3, 4), (3, 40, 8), (3, 17, 1)])
def test_chunks_read_every_sample_once(levels, num_points, g):
    """The location chunks: each sample of an item is read once, from the
    lane and slot that loaded it, for item sample counts below, at and
    above the 2G samples of a chunk, with chunks that cross levels."""
    n = levels * num_points
    loc = np.arange(2 * n, dtype=np.float64).reshape(1, n, 2)
    attn = np.arange(n, dtype=np.float64).reshape(1, n) + 0.5
    for lvl in range(levels):
        sx, sy, a = _chunk_samples(loc, attn, lvl, levels, num_points, g)
        want = np.arange(lvl * num_points, (lvl + 1) * num_points)
        np.testing.assert_array_equal(sx[0], 2 * want)
        np.testing.assert_array_equal(sy[0], 2 * want + 1)
        np.testing.assert_array_equal(a[0], want + 0.5)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_sample_grad_reduce_scatter(g):
    """``store_sample_grads``: the storing lanes hold the sums over the
    item's G lanes of the weight and the two location gradients."""
    rng = np.random.RandomState(g)
    ga, gx, gy = (rng.randn(5, g) for _ in range(3))
    got = _store_sample_grads(ga, gx, gy)
    for a, b in zip(got, (ga, gx, gy)):
        np.testing.assert_allclose(a, b.sum(-1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("layout,batch,heads,head_dim", [
    ("encoder", 1, 2, 32), ("encoder", 2, 3, 8), ("decoder", 2, 3, 16)])
def test_schedules_match_plain_versions_and_jax(layout, batch, heads, head_dim):
    """Both kernels' schedules on encoder-like samples with far points,
    borders, pixel centres and a NaN location at the small ragged levels:
    output, grad_value, grad_locations and grad_weights against the plain
    versions (``msda_reference``, ``msda_backward_reference``) and
    ``jax.vjp`` of the JAX gather (jitted; location gradients of samples on
    a pixel centre against the plain version only), within 1e-5 of each
    max where both are finite; NaN where the kernels put it."""
    rng = np.random.RandomState(head_dim)
    total = sum(h * w for h, w in SMALL_LEVELS)
    num_queries = total if layout == "encoder" else 41
    value, locs, attn, grad_out = encoder_like(rng, SMALL_LEVELS, batch, num_queries, heads,
                                                head_dim)
    got = _emulate(value, SMALL_LEVELS, locs, attn, grad_out)
    tv, tl, ta, tg = (torch.from_numpy(t) for t in (value, locs, attn, grad_out))
    want = (msda.msda_reference(tv, SMALL_LEVELS, tl, ta),
            *msda.msda_backward_reference(tv, SMALL_LEVELS, tl, ta, tg))
    jax_want = _jax_gather_vjp(*(jnp.asarray(t) for t in (value, locs, attn, grad_out)))
    # under jit XLA may fuse loc * size - 0.5 into one rounding, so a
    # sample exactly on a pixel centre can take the other side of the
    # bilinear kink there; those location gradients are held against the
    # plain version only, which rounds as the kernels do
    size = np.array([(w, h) for h, w in SMALL_LEVELS], np.float32)[:, None]
    pixel = (locs * size).astype(np.float32) - np.float32(0.5)
    kink = np.broadcast_to((pixel == np.floor(pixel)).any(-1, keepdims=True), locs.shape)
    assert kink.any()
    for name, a, b, c in zip(("out", "grad_value", "grad_loc", "grad_attn"), got, want,
                             jax_want):
        close_where_finite(a, b.numpy(), 1e-5, f"{name} vs plain")
        c = np.where(kink, a, np.asarray(c)) if name == "grad_loc" else np.asarray(c)
        close_where_finite(a, c, 1e-5, f"{name} vs jax")
    # the NaN sample (image 0, query 3, head 0, level 1): NaN output, NaN
    # weight and location gradients, NaN on the level's first value row
    start1 = SMALL_LEVELS[0][0] * SMALL_LEVELS[0][1]
    assert np.isnan(got[0][0, 3, :head_dim]).all()
    assert np.isnan(got[3][0, 3, 0, 1, 2]) and np.isnan(got[2][0, 3, 0, 1, 2]).all()
    assert np.isnan(got[1][0, start1, 0]).all()
    assert np.isnan(want[0].numpy()[0, 3, :head_dim]).all()


@pytest.mark.parametrize("layout,batch,heads,head_dim", [
    ("encoder", 1, 2, 32), ("decoder", 2, 3, 16), ("decoder", 1, 2, 8)])
def test_bf16_lane_schedules_match_plain_versions(layout, batch, heads, head_dim):
    """The bf16-value forward's schedule: 8 channels a lane (one 16-byte
    load of bf16), so 4 / 2 / 1 lanes an item and the 16 samples in 2 / 4 /
    8 chunks, against the plain version within 1e-5 of the max where both
    are finite (the schedule, in float64; the card holds the bf16
    roundings, ``chip_smoke.py`` phase 3). The bf16 backward takes the fp32
    form's lanes, which the tests above emulate."""
    assert [_lanes(d, 2) for d in (32, 16, 8)] == [(8, 4), (8, 2), (8, 1)]
    assert [_lanes(d, 2, backward=True) for d in (32, 16, 8)] == [_lanes(d) for d in (32, 16, 8)]
    rng = np.random.RandomState(head_dim + 50)
    total = sum(h * w for h, w in SMALL_LEVELS)
    num_queries = total if layout == "encoder" else 41
    value, locs, attn, grad_out = encoder_like(rng, SMALL_LEVELS, batch, num_queries, heads,
                                                head_dim)
    out = _emulate(value, SMALL_LEVELS, locs, attn, grad_out, itemsize=2)[0]
    want = msda.msda_reference(torch.from_numpy(value), SMALL_LEVELS, torch.from_numpy(locs),
                               torch.from_numpy(attn))
    close_where_finite(out, want.numpy(), 1e-5, "out vs plain")
    assert np.isnan(out[0, 3, :head_dim]).all()
