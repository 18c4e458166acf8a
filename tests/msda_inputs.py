"""MSDA inputs shared by the CPU schedule tests and the card-only kernel
tests, numpy only (the card's machine has no jax): the encoder-like and the
scattered sets of ``chip_smoke.py`` at small sizes, from a seeded
``np.random.RandomState``."""
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
