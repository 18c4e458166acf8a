"""Windowed accumulate: CUDA kernel and its plain version.

Counterpart of ``relation_detr_tpu/ops/patch_scatter.py::window_accumulate``
(Pallas kernel ``_accum_kernel``): the sum of ``nt`` (ph, pw, C) windows
placed at origins (y0, x0) on an (h, w, C) canvas, added in ascending window
order. It is the backward of the tiled encoder MSDA's patch extraction
(``ops/msda_tiled.py::SlicePatchesFunction``, the counterpart of
``relation_detr_tpu/ops/msda.py::_slice_patches_bwd``), so the train step
runs it once per image, encoder layer and level under
``set_msda_defaults(impl="tiled")`` or ``"tiled_xla"``.

``window_accumulate`` is the wrapper: a CPU tensor takes
``window_accumulate_reference``; a CUDA tensor launches
``csrc/patch_scatter.cu::window_accumulate`` or raises. The kernel walks a
covering-window table (``covering_windows``) that is built with numpy and
put on the device once per geometry and device (``window_table``), so a
launch copies nothing to the card and does not synchronise.
"""
from __future__ import annotations

import numpy as np
import torch

from relation_detr_tpu_torch import _build
from relation_detr_tpu_torch.ops.tile_geometry import MARGIN, TILE_TOKENS, _tile_geometry

# The flagship encoder's level 0 (100 x 168 on the 800x1344 canvas) cut into
# windows by the default tiling (halos "auto" = num_points + 1 = 5): a 9 x 21
# grid of 23 x 19 windows.
_FLAGSHIP_LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21))
_LEVEL0 = _tile_geometry(_FLAGSHIP_LEVELS, TILE_TOKENS, (5,) * 4, MARGIN)
LEVEL0_CANVAS = _FLAGSHIP_LEVELS[0]
LEVEL0_WINDOW = tuple(_LEVEL0.patches[0][2:])
LEVEL0_ROWS, LEVEL0_COLS = _LEVEL0.patch_grid[0]


def level0_origins():
    """(y0s, x0s) int32 of the level-0 windows, in the JAX window order
    (row-major over the grid, as ``_slice_patches_bwd`` builds them)."""
    return _LEVEL0.patches[0][0], _LEVEL0.patches[0][1]


def _check_count(g, y0s, x0s):
    if len(y0s) != g.shape[0] or len(x0s) != g.shape[0]:
        raise ValueError(f"window_accumulate: {g.shape[0]} windows, {len(y0s)}/{len(x0s)} "
                         "origins")


def _check_inside(y0s, x0s, ph, pw, h, w):
    if len(y0s) and (min(y0s) < 0 or min(x0s) < 0 or max(y0s) + ph > h or max(x0s) + pw > w):
        raise ValueError("window_accumulate: a window leaves the canvas")


def window_accumulate_reference(g: torch.Tensor, y0s, x0s, h: int, w: int) -> torch.Tensor:
    """Plain version: slice-adds in ascending window order."""
    _, ph, pw, c = g.shape
    _check_count(g, y0s, x0s)
    _check_inside(y0s, x0s, ph, pw, h, w)
    out = g.new_zeros(h, w, c)
    for k, (y0, x0) in enumerate(zip(y0s, x0s)):
        out[y0:y0 + ph, x0:x0 + pw] += g[k]
    return out


def covering_windows(y0s, x0s, ph: int, pw: int, h: int, w: int):
    """The kernel's covering-window table, CSR over the h * w canvas
    positions: ``rows[offsets[p]:offsets[p + 1]]`` are the rows
    ((k * ph + dy) * pw + dx) of the windows viewed as (nt * ph * pw, C)
    that land on position p, in ascending k. int32 numpy arrays
    (offsets (h * w + 1,), rows (nt * ph * pw,))."""
    y0 = np.asarray(y0s, np.int64)
    x0 = np.asarray(x0s, np.int64)
    pos = ((y0[:, None, None] + np.arange(ph)[:, None]) * w
           + x0[:, None, None] + np.arange(pw)).reshape(-1)
    rows = np.argsort(pos, kind="stable").astype(np.int32)  # within a position: k ascending
    offsets = np.zeros(h * w + 1, np.int32)
    np.cumsum(np.bincount(pos, minlength=h * w), out=offsets[1:])
    return offsets, rows


_DEVICE_TABLES = {}


def window_table(key, y0s, x0s, ph: int, pw: int, h: int, w: int, device):
    """``covering_windows`` on ``device`` as (offsets, rows) int32 tensors,
    checked and made once per ``key`` (which names the origins), window,
    canvas and device (``window_table.builds`` counts the makings), outside
    inference mode as ``msda_tiled._device_index``."""
    full_key = (key, ph, pw, h, w, device)
    table = _DEVICE_TABLES.get(full_key)
    if table is None:
        _check_inside(y0s, x0s, ph, pw, h, w)
        with torch.inference_mode(False):
            table = tuple(torch.from_numpy(a).to(device)
                          for a in covering_windows(y0s, x0s, ph, pw, h, w))
        _DEVICE_TABLES[full_key] = table
        window_table.builds += 1
    return table


window_table.builds = 0


def window_accumulate(g: torch.Tensor, y0s, x0s, h: int, w: int, grid=None) -> torch.Tensor:
    """g (nt, ph, pw, C) fp32 window values, int origins y0s/x0s (nt,) ->
    (h, w, C) canvas sum. CPU tensors take ``window_accumulate_reference``;
    CUDA tensors launch the kernel or raise. ``grid``, where the origins
    are the row-major product of band origins (y0u, x0u), is that pair: it
    keys the device table in place of the nt origins
    (``SlicePatchesFunction`` passes it)."""
    if g.device.type == "cpu":
        return window_accumulate_reference(g, y0s, x0s, h, w)
    if g.device.type != "cuda":
        raise ValueError(f"window_accumulate: no kernel for device {g.device}")
    if g.dtype != torch.float32 or not g.is_contiguous() or g.dim() != 4:
        raise TypeError("window_accumulate kernel takes a contiguous fp32 (nt, ph, pw, C)")
    _check_count(g, y0s, x0s)
    _, ph, pw, c = g.shape
    if grid is None:
        key = ("origins", tuple(int(v) for v in y0s), tuple(int(v) for v in x0s))
    else:
        key = ("grid", tuple(grid[0]), tuple(grid[1]))
    lib = _build.load_library()
    offsets, rows = window_table(key, y0s, x0s, ph, pw, h, w, g.device)
    out = torch.empty(h, w, c, device=g.device, dtype=torch.float32)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.window_accumulate(g.data_ptr(), offsets.data_ptr(), rows.data_ptr(),
                                     out.data_ptr(), h * w, c, stream)
    _build.check(lib, code, "window_accumulate")
    window_accumulate.launches += 1
    return out


window_accumulate.launches = 0
