"""Static tiling of the multi-level token raster for the tiled encoder MSDA.

Numpy copy of ``relation_detr_tpu/ops/msda.py::_TileGeometry`` and
``_tile_geometry``: tokens of every level go to a (gy, gx) grid of tiles by
their normalised raster position, each tile holds T slots (padded to a
multiple of 8), and per (tile, level) a (ph, pw) value patch covers the
tile's footprint plus a halo of ``halos[level]`` texels and ``margin``
extra rows and columns, clamped to the level's interior. Everything is
computed once per (spatial_shapes, tile_tokens, halos, margin) and cached.
"""
from __future__ import annotations

import numpy as np

# The JAX package's default tiling (``_MSDA_DEFAULTS``: tiled_tile_tokens,
# tiled_margin; ``ops/msda_settings.py`` sets the tiling the tiled forms
# take); halos "auto" are num_points + 1 texels on every level.
TILE_TOKENS = (12, 8)
MARGIN = 1


class _TileGeometry:
    __slots__ = ("grid", "ntiles", "T", "perm", "slot_valid", "inv", "patches",
                 "patch_grid", "M")

    def __init__(self, spatial_shapes, tile_tokens, halos, margin=2):
        h0, w0 = spatial_shapes[0]
        gy = max(1, -(-h0 // tile_tokens[0]))
        gx = max(1, -(-w0 // tile_tokens[1]))
        self.grid = (gy, gx)
        nt = gy * gx
        self.ntiles = nt

        tile_of = []  # token -> tile by normalised raster position
        for h, w in spatial_shapes:
            ty = np.minimum(((np.arange(h) + 0.5) / h * gy).astype(np.int64), gy - 1)
            tx = np.minimum(((np.arange(w) + 0.5) / w * gx).astype(np.int64), gx - 1)
            tile_of.append((ty[:, None] * gx + tx[None, :]).ravel())
        tile_of = np.concatenate(tile_of)
        total = tile_of.shape[0]

        counts = np.bincount(tile_of, minlength=nt)
        t_slots = int(-(-int(counts.max()) // 8) * 8)
        self.T = t_slots
        perm = np.zeros((nt, t_slots), np.int32)  # padding slots point at token 0
        slot_valid = np.zeros((nt, t_slots), bool)
        order = np.argsort(tile_of, kind="stable")
        tiles_sorted = tile_of[order]
        # slot within a tile = running count (a tile's tokens are contiguous
        # in the stable sort)
        boundaries = np.flatnonzero(np.diff(tiles_sorted, prepend=-1))
        seg_start = np.repeat(boundaries, np.diff(np.append(boundaries, total)))
        slots = np.arange(total) - seg_start
        perm[tiles_sorted, slots] = order.astype(np.int32)
        slot_valid[tiles_sorted, slots] = True
        self.perm = perm
        self.slot_valid = slot_valid
        inv = np.zeros(total, np.int32)
        inv[order] = (tiles_sorted * t_slots + slots).astype(np.int32)
        self.inv = inv

        patches = []  # per level: (y0s, x0s) per tile, uniform (ph, pw)
        patch_grid = []  # per level: the separable (row, column) origins
        for lvl, (h, w) in enumerate(spatial_shapes):
            r = halos[min(lvl, len(halos) - 1)]
            th, tw = h / gy, w / gx
            ph = min(h, int(np.ceil(th)) + 2 * r + margin)
            pw = min(w, int(np.ceil(tw)) + 2 * r + margin)
            y0 = np.clip(np.floor(np.arange(gy) * th).astype(np.int64) - r, 0, h - ph)
            x0 = np.clip(np.floor(np.arange(gx) * tw).astype(np.int64) - r, 0, w - pw)
            patches.append((np.repeat(y0, gx).astype(np.int32),
                            np.tile(x0, gy).astype(np.int32), ph, pw))
            patch_grid.append((tuple(int(v) for v in y0), tuple(int(v) for v in x0)))
        self.patches = patches
        self.patch_grid = patch_grid
        self.M = sum(ph * pw for _, _, ph, pw in patches)


_TILE_GEO_CACHE = {}


def _tile_geometry(spatial_shapes, tile_tokens, halos, margin=2):
    key = (tuple(spatial_shapes), tuple(tile_tokens), tuple(halos), margin)
    geo = _TILE_GEO_CACHE.get(key)
    if geo is None:
        geo = _TileGeometry(spatial_shapes, tile_tokens, halos, margin)
        _TILE_GEO_CACHE[key] = geo
    return geo
