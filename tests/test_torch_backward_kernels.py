"""The schedules of the tiled encoder's two backward kernels, emulated on
the CPU from what their wrappers hand them, against the plain versions.

``window_accumulate`` (csrc/patch_scatter.cu) walks the covering-window
table that ``ops/patch_scatter.py::covering_windows`` builds; the walk is
emulated in torch and must equal the ascending slice-add loop (and the JAX
Pallas kernel in interpret mode) bit for bit. ``tiled_core_bwd``
(csrc/tiled_msda.cu) is emulated in numpy step by step: operands staged in
XOR-swizzled 16-byte chunks, the counting sort by patch row over 16 warp
partitions (histogram, exclusive scan, 32-lane rounds ranked as
``__match_any_sync`` ranks them), dw by thread per entry, and dpatch
summed per row in sorted order; it must match
``tiled_core_backward_reference``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relation_detr_tpu.ops.patch_scatter import window_accumulate as j_window_accumulate
from relation_detr_tpu_torch.ops import msda_tiled, patch_scatter
from relation_detr_tpu_torch.ops.tile_geometry import MARGIN, TILE_TOKENS, _tile_geometry

FLAGSHIP_LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21))


def _walk_table(g, y0s, x0s, h, w):
    """The kernel's walk: each canvas position adds, from 0, the window
    rows its CSR slice lists, in the listed order (one vectorised step per
    slice position)."""
    _, ph, pw, c = g.shape
    offsets, rows = (torch.from_numpy(a).long() for a in patch_scatter.covering_windows(
        tuple(int(v) for v in y0s), tuple(int(v) for v in x0s), ph, pw, h, w))
    flat = g.reshape(-1, c)
    out = torch.zeros(h * w, c, dtype=g.dtype)
    counts = offsets[1:] - offsets[:-1]
    for step in range(int(counts.max())):
        pos = torch.nonzero(counts > step).squeeze(1)
        out[pos] += flat[rows[offsets[pos] + step]]
    return out.reshape(h, w, c)


@pytest.mark.parametrize("level", range(4))
def test_window_table_walk_matches_reference_at_flagship_levels(level):
    """The flagship's window grids (``_tile_geometry`` of the 800x1344
    canvas at the default tiling), C = 8: bit for bit, and every window
    element listed once."""
    geo = _tile_geometry(FLAGSHIP_LEVELS, TILE_TOKENS, (5,) * 4, MARGIN)
    y0s, x0s, ph, pw = geo.patches[level]
    h, w = FLAGSHIP_LEVELS[level]
    g = torch.from_numpy(np.random.RandomState(level).randn(len(y0s), ph, pw, 8)
                         .astype(np.float32))
    got = _walk_table(g, y0s, x0s, h, w)
    assert torch.equal(got, patch_scatter.window_accumulate_reference(g, y0s, x0s, h, w))
    _, rows = patch_scatter.covering_windows(tuple(y0s.tolist()), tuple(x0s.tolist()), ph, pw,
                                             h, w)
    np.testing.assert_array_equal(np.sort(rows), np.arange(len(y0s) * ph * pw))


def test_window_table_walk_random_origins_matches_reference_and_jax():
    """Random in-canvas origins, repeated ones among them, values of mixed
    magnitude (another addition order rounds differently): the walk equals
    the slice-add loop and the JAX Pallas kernel (interpret mode) bit for
    bit, and the wrapper on CPU tensors launches nothing."""
    rng = np.random.RandomState(7)
    (h, w), (ph, pw), c = (14, 17), (5, 6), 16
    y0s = rng.randint(0, h - ph + 1, 30)
    x0s = rng.randint(0, w - pw + 1, 30)
    y0s[10:14], x0s[10:14] = y0s[3], x0s[3]
    g = (rng.randn(30, ph, pw, c) * 10.0 ** rng.randint(-4, 5, (30, 1, 1, 1))).astype(np.float32)
    tg = torch.from_numpy(g)
    got = _walk_table(tg, y0s, x0s, h, w)
    assert torch.equal(got, patch_scatter.window_accumulate_reference(tg, y0s, x0s, h, w))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_window_accumulate(jnp.asarray(g), y0s, x0s, h, w)))
    launches = patch_scatter.window_accumulate.launches
    assert torch.equal(patch_scatter.window_accumulate(tg, y0s, x0s, h, w), got)
    assert patch_scatter.window_accumulate.launches == launches


WARPS = 16  # kBwdWarps: the sort's partitions


def _swizzled(rows_d, d):
    """Stages a (rows, D) slice as the kernel does: 16-byte chunk a at
    a ^ ((a >> 3) & 7), the slice padded to whole 128-byte lines; returns
    a reader (row, col) -> value."""
    n = rows_d.shape[0] * d // 4
    staged = np.zeros(-(-n // 8) * 8 * 4, rows_d.dtype)
    slots = [a ^ ((a >> 3) & 7) for a in range(n)]
    assert len(set(slots)) == n and max(slots) * 4 < len(staged)
    for a, slot in enumerate(slots):
        staged[slot * 4:slot * 4 + 4] = rows_d.reshape(-1)[a * 4:a * 4 + 4]

    def read(row, col):
        a = row * d // 4 + col // 4
        return staged[(a ^ ((a >> 3) & 7)) * 4 + col % 4]
    return read


def _emulate_item(m, w, patch, g):
    """One (image, tile, head) item: m, w (E, T), patch (M, D), g (T, D) ->
    (dw (E, T), dpatch (M, D)) by the kernel's schedule, in the inputs'
    float type."""
    n_e, n_t = m.shape
    rows, d = patch.shape
    et = n_e * n_t
    ms, ws = m.reshape(-1), w.reshape(-1)
    ps, gs = _swizzled(patch, d), _swizzled(g, d)
    part = -(-et // WARPS)
    inside = (ms >= 0) & (ms < rows)
    hist = np.zeros((rows, WARPS), np.int64)
    for j in np.flatnonzero(inside):
        hist[ms[j], j // part] += 1
    flat = hist.reshape(-1)
    cursor = (np.cumsum(flat) - flat).reshape(rows, WARPS)  # exclusive, (row, partition)
    sorted_t = np.full(et, -1)
    sorted_w = np.zeros(et, w.dtype)
    for warp in range(WARPS):
        j1 = min(et, (warp + 1) * part)
        for base in range(warp * part, j1, 32):
            lanes = [j if j < j1 and inside[j] else None for j in range(base, base + 32)]
            keys = [ms[j] if j is not None else -1 for j in lanes]
            for lane, j in enumerate(lanes):
                if j is None:
                    continue
                rank = keys[:lane].count(keys[lane])  # popc(peers & lanemask_lt)
                slot = cursor[ms[j], warp] + rank
                assert sorted_t[slot] == -1
                sorted_t[slot], sorted_w[slot] = j % n_t, ws[j]
            for r in set(k for k in keys if k >= 0):
                cursor[r, warp] += keys.count(r)
    ends = cursor[:, -1]
    begins = np.concatenate([[0], ends[:-1]])
    assert ends[-1] == inside.sum() and (sorted_t[:ends[-1]] >= 0).all()

    dw = np.zeros(et, patch.dtype)
    for j in np.flatnonzero(inside):
        for col in range(d):
            dw[j] += ps(ms[j], col) * gs(j % n_t, col)
    dpatch = np.zeros((rows, d), patch.dtype)
    for r in range(rows):
        # the row's entries lie in ascending (e, t): the kernel's sum order
        want = [j for j in range(et) if ms[j] == r]
        got = list(range(begins[r], ends[r]))
        assert [sorted_t[k] for k in got] == [j % n_t for j in want]
        for k in got:
            dpatch[r] = dpatch[r] + sorted_w[k] * np.array([gs(sorted_t[k], c) for c in range(d)])
    return dw.reshape(n_e, n_t), dpatch


def test_tiled_core_bwd_schedule_matches_reference():
    """B=1, two tiles, two heads, E=16, T=64 (two 32-lane rounds per
    partition), M=12, D=8: entries outside [0, M), a row (5) that no entry
    hits and, in one item, every entry on one row (3). In float64 on both
    sides (the schedule, not fp32 rounding, is under test: the card holds
    the kernel's rounding), dw and dpatch within 1e-6 of each gradient's
    max; rows and entries that take nothing are exactly 0."""
    rng = np.random.RandomState(3)
    heads, d, rows, n_e, n_t = 2, 8, 12, 16, 64
    m = rng.randint(-2, rows + 2, (1, 2, heads, n_e, n_t)).astype(np.int32)
    m[m == 5] = 6
    m[0, 0, 1] = 3
    m[0, 1, 0, :2, ::7] = 10 ** 6
    w = rng.randn(*m.shape)
    patch = rng.randn(1, 2, rows, heads * d)
    g = rng.randn(1, 2, n_t, heads * d)
    want_dw, want_dp = (t.numpy() for t in msda_tiled.tiled_core_backward_reference(
        torch.from_numpy(m), torch.from_numpy(w), torch.from_numpy(patch), torch.from_numpy(g),
        (heads, d)))
    got_dw = np.zeros_like(want_dw)
    got_dp = np.zeros_like(want_dp)
    for n in range(2):
        for h in range(heads):
            cols = slice(h * d, (h + 1) * d)
            got_dw[0, n, h], got_dp[0, n, :, cols] = _emulate_item(
                m[0, n, h], w[0, n, h], patch[0, n, :, cols], g[0, n, :, cols])
    np.testing.assert_allclose(got_dw, want_dw, rtol=0, atol=1e-6 * np.abs(want_dw).max())
    np.testing.assert_allclose(got_dp, want_dp, rtol=0, atol=1e-6 * np.abs(want_dp).max())
    outside = (m < 0) | (m >= rows)
    assert (got_dw[outside] == 0).all() and (want_dw[outside] == 0).all()
    assert (got_dp[:, :, 5] == 0).all()
    assert (got_dp[0, 0, [r for r in range(rows) if r != 3], d:] == 0).all()


def test_tiled_core_bwd_wrapper_checks():
    """The CUDA wrapper's checks, run on CPU tensors: the flagship's four
    levels fit the kernel's shared memory, a head dim the kernel does not
    take and a patch too large for it raise."""
    geo = _tile_geometry(FLAGSHIP_LEVELS, TILE_TOKENS, (5,) * 4, MARGIN)
    for _, _, ph, pw in geo.patches:
        assert msda_tiled._bwd_smem_bytes(ph * pw, 32, 16, geo.T) <= 232448
    assert msda_tiled._bwd_smem_bytes(437, 32, 16, 128) == 221888

    def check(rows, heads, head_dim, t=8):
        m = torch.zeros(1, 2, heads, 16, t, dtype=torch.int32)
        w = torch.zeros(1, 2, heads, 16, t)
        patch = torch.zeros(1, 2, rows, heads * head_dim)
        g = torch.zeros(1, 2, t, heads * head_dim)
        msda_tiled._check_core_args(m, w, patch, (heads, head_dim), g)

    check(437, 8, 32)
    with pytest.raises(ValueError, match="head dim"):
        check(20, 2, 64)
    with pytest.raises(ValueError, match="shared memory"):
        check(1500, 8, 32)
