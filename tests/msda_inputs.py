"""Kernel inputs shared by the CPU schedule tests and the card-only kernel
tests, numpy only (the card's machine has no jax), from a seeded
``np.random.RandomState``: the MSDA's encoder-like and scattered sets of
``chip_smoke.py`` at small sizes, the relation bias's boxes and the
separable contraction's operands."""
import numpy as np

from relation_detr_tpu_torch.models.attention import sampling_offsets_bias


def encoder_like(rng, levels, batch, num_queries, heads, head_dim):
    """Every query a token at its own cell centre (random tokens unless
    Q = S), the radial offset initialisation plus N(0, 1.5 px) at every
    level; every 7th query's point 3 anywhere over the image and past it
    (far from its own reference point), every 5th query's point 0 exactly on a pixel
    centre (no jitter), point 1 of every 11th on the left and top borders
    and of every 13th on the right and bottom ones, one NaN location."""
    num_levels, num_points = len(levels), 4
    total = sum(h * w for h, w in levels)
    refs = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w,
                                                (np.arange(h) + 0.5) / h), -1).reshape(-1, 2)
                           for h, w in levels])
    if num_queries != total:
        refs = refs[rng.permutation(total)[:num_queries]]
    size = np.array([(w, h) for h, w in levels], np.float64)[:, None]
    offs = sampling_offsets_bias(heads, num_levels, num_points).numpy().reshape(
        heads, num_levels, num_points, 2)
    noise = rng.randn(batch, num_queries, heads, num_levels, num_points, 2) * 1.5
    noise[:, ::5, :, :, 0] = 0.0
    locs = refs[None, :, None, None, None] + (offs + noise) / size
    locs[:, ::7, :, :, 3] = rng.rand(batch, len(range(0, num_queries, 7)), heads,
                                     num_levels, 2) * 1.4 - 0.2
    locs[:, ::11, :, :, 1] = 0.0
    locs[:, ::13, :, :, 1] = 1.0
    locs = locs.astype(np.float32)
    locs[0, 3, 0, 1, 2, 0] = np.nan
    value = rng.randn(batch, total, heads, head_dim).astype(np.float32)
    attn = rng.rand(batch, num_queries, heads, num_levels, num_points).astype(np.float32)
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    grad_out = rng.randn(batch, num_queries, heads * head_dim).astype(np.float32)
    return value, locs, attn, grad_out


def scattered(rng, levels, batch, num_queries, heads, head_dim):
    """Locations uniform over the image and past it, whatever the query,
    with points on the borders and one NaN location."""
    total = sum(h * w for h, w in levels)
    locs = rng.rand(batch, num_queries, heads, len(levels), 4, 2) * 1.4 - 0.2
    locs[:, ::5, :, :, 1] = 0.0
    locs[:, ::7, :, :, 2] = 1.0
    locs = locs.astype(np.float32)
    locs[0, 3, 0, 1, 2, 0] = np.nan
    value = rng.randn(batch, total, heads, head_dim).astype(np.float32)
    attn = rng.rand(batch, num_queries, heads, len(levels), 4).astype(np.float32)
    grad_out = rng.randn(batch, num_queries, heads * head_dim).astype(np.float32)
    return value, locs, attn, grad_out


def close_where_finite(got, want, tol, what):
    """Entries finite on both sides within tol of want's max."""
    both = np.isfinite(got) & np.isfinite(want)
    scale = np.abs(want[both]).max()
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=tol * scale, err_msg=what)


# edge shapes of the relation bias (B, N1, N2, H, weight layout) and of the
# separable contraction (B, nt, H, D, P, ph, pw, T, dense), held on the card
# (test_torch_no_jax.py) and by the CPU schedule tests
# (test_torch_kernel_schedule.py; the last relation shape only on the card)
V4_CASES = [(1, 1, 1, 8, "rows"), (2, 37, 300, 4, "conv"), (1, 130, 33, 8, "conv"),
            (3, 9, 129, 16, "rows"), (1, 900, 900, 8, "conv")]
# edge shapes of tiled_core_fwd (B, nt, H, D, E, T, M) and of
# relation_bias_rel_fwd (B, N1, N2, H), held the same way (the last relation
# shape only on the card): the flagship's level-0 item (E = 16, T = 128,
# M = 437), M = 1, T not a multiple of 32, D 4 to 32; H 4 to 16, N1 != N2;
# B up to 3
TILED_FWD_CASES = [(1, 2, 2, 32, 16, 128, 437), (2, 3, 2, 16, 8, 45, 60),
                   (3, 2, 2, 8, 8, 20, 1), (1, 2, 4, 4, 4, 33, 30)]
REL_CASES = [(1, 1, 1, 8), (2, 37, 300, 4), (3, 9, 129, 16), (1, 130, 33, 8), (1, 900, 900, 8)]
SEP_CASES = [(1, 3, 2, 32, 4, 23, 19, 128, False), (2, 2, 4, 16, 3, 7, 20, 131, True),
             (1, 2, 8, 8, 1, 5, 1, 13, False), (1, 1, 1, 4, 2, 1, 5, 4, True),
             (1, 2, 2, 32, 4, 13, 11, 100, True),
             # wider than 20: the kernel's form with 16 columns a build thread
             (1, 2, 2, 32, 4, 9, 25, 70, False)]


def relation_boxes(rng, batch, n1, n2, heads):
    """cxcywh boxes (B, N1, 4) and (B, N2, 4) with w/h from 10**-4.5 to 1
    (xy angles up to ~1.2e3 rad), a zero width, a NaN and an Inf centre
    (clamped: finite biases) and a NaN width and an Inf height (NaN
    biases along that row or column); kernel (64, H) and bias (H)."""
    def boxes(n):
        return np.concatenate([rng.rand(batch, n, 2), 10 ** rng.uniform(-4.5, 0, (batch, n, 2))],
                              -1).astype(np.float32)

    src, tgt = boxes(n1), boxes(n2)
    src[0, 1 % n1, 2] = 0.0
    src[0, 3 % n1, :2] = np.nan
    tgt[0, 5 % n2, 0] = np.inf
    if n1 > 2:
        src[-1, n1 - 1, 2] = np.nan
    if n2 > 2:
        tgt[-1, n2 - 2, 3] = np.inf
    kernel = (rng.randn(64, heads) * 0.1).astype(np.float32)
    bias = (rng.randn(heads) * 0.1).astype(np.float32)
    return src, tgt, kernel, bias


def sep_operands(rng, batch, nt, heads, head_dim, points, ph, pw, tokens, dense):
    """oy (B, nt, H, P, ph, T), ox (B, nt, H, P, pw, T) and patch (B, nt,
    ph * pw, H * D): per (point, token) soft one-hot rows as ``_axis_soft``
    builds them (two taps, the first one row or column before the patch
    or on it, attention folded into oy), or with ``dense`` every entry
    drawn, U(0, 1) / ph and / pw."""
    shape = (batch, nt, heads, points)
    if dense:
        oy = rng.rand(*shape, ph, tokens) / ph
        ox = rng.rand(*shape, pw, tokens) / pw
    else:
        def soft(size, fold):
            out = np.zeros((*shape, size, tokens))
            c0 = rng.randint(-1, size, (*shape, tokens))
            frac = rng.rand(*shape, tokens)
            for d, wgt in ((0, 1.0 - frac), (1, frac)):
                c = c0 + d
                hot = (c[..., None, :] == np.arange(size)[:, None])
                out += hot * (wgt * fold)[..., None, :]
            return out

        oy = soft(ph, rng.rand(*shape, tokens))
        ox = soft(pw, 1.0)
    patch = rng.randn(batch, nt, ph * pw, heads * head_dim)
    return [a.astype(np.float32) for a in (oy, ox, patch)]


def tiled_fwd_operands(rng, batch, nt, heads, head_dim, entries, tokens, rows):
    """m, w (B, nt, H, E, T) and patch (B, nt, M, H * D) for tiled_core_fwd:
    rows drawn from [-2, M + 2) (some outside the patch) plus -1, M, 10**6
    and -10**6 on entry 0, NaN weights on entries outside [0, M) (dropped:
    finite outputs) and on one entry inside it (item (-1, -1, -1), token
    T - 1: that token's head slice NaN)."""
    shape = (batch, nt, heads, entries, tokens)
    m = rng.randint(-2, rows + 2, shape).astype(np.int32)
    m[..., 0, ::4] = np.array([-1, rows, 10 ** 6, -10 ** 6], np.int32)[
        np.arange(len(range(0, tokens, 4))) % 4]
    w = rng.rand(*shape).astype(np.float32)
    w[..., 0, ::4] = np.nan
    outside = (m < 0) | (m >= rows)
    w[0, 0, 0][outside[0, 0, 0]] = np.nan
    m[-1, -1, -1, -1, -1] = rows - 1
    w[-1, -1, -1, -1, -1] = np.nan
    patch = rng.randn(batch, nt, rows, heads * head_dim).astype(np.float32)
    return m, w, patch


def relation_rel(rng, batch, n1, n2, heads):
    """rel (B, N1, N2, 4) as box_rel_encoding gives it (coordinates 0-1
    in [0, 18.4], 2-3 in [-10.4, 10.4]: angles up to ~1.8e3 rad) with some
    |rel| up to 90 (9e3 rad), a NaN and an Inf (NaN biases for that pair);
    kernel (64, H) and bias (H)."""
    rel = np.concatenate([rng.uniform(0, 18.4, (batch, n1, n2, 2)),
                          rng.uniform(-10.4, 10.4, (batch, n1, n2, 2))], -1)
    rel[:, ::7, ::5] = rng.uniform(-90, 90, rel[:, ::7, ::5].shape)
    rel = rel.astype(np.float32)
    rel[0, n1 // 2, n2 // 3, 1] = np.nan
    rel[-1, n1 - 1, n2 - 1, 3] = np.inf
    kernel = (rng.randn(64, heads) * 0.1).astype(np.float32)
    bias = (rng.randn(heads) * 0.1).astype(np.float32)
    return rel, kernel, bias
