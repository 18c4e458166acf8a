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
``csrc/patch_scatter.cu::window_accumulate`` or raises.
"""
from __future__ import annotations

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


def _check_args(g, y0s, x0s, h, w):
    nt, ph, pw, _ = g.shape
    if len(y0s) != nt or len(x0s) != nt:
        raise ValueError(f"window_accumulate: {nt} windows, {len(y0s)}/{len(x0s)} origins")
    if nt and (min(y0s) < 0 or min(x0s) < 0 or max(y0s) + ph > h or max(x0s) + pw > w):
        raise ValueError("window_accumulate: a window leaves the canvas")


def window_accumulate_reference(g: torch.Tensor, y0s, x0s, h: int, w: int) -> torch.Tensor:
    """Plain version: slice-adds in ascending window order."""
    _check_args(g, y0s, x0s, h, w)
    _, ph, pw, c = g.shape
    out = g.new_zeros(h, w, c)
    for k, (y0, x0) in enumerate(zip(y0s, x0s)):
        out[y0:y0 + ph, x0:x0 + pw] += g[k]
    return out


def window_accumulate(g: torch.Tensor, y0s, x0s, h: int, w: int) -> torch.Tensor:
    """g (nt, ph, pw, C) fp32 window values, int origins y0s/x0s (nt,) ->
    (h, w, C) canvas sum. CPU tensors take ``window_accumulate_reference``;
    CUDA tensors launch the kernel or raise."""
    y0s = [int(v) for v in y0s]
    x0s = [int(v) for v in x0s]
    if g.device.type == "cpu":
        return window_accumulate_reference(g, y0s, x0s, h, w)
    if g.device.type != "cuda":
        raise ValueError(f"window_accumulate: no kernel for device {g.device}")
    if g.dtype != torch.float32 or not g.is_contiguous() or g.dim() != 4:
        raise TypeError("window_accumulate kernel takes a contiguous fp32 (nt, ph, pw, C)")
    _check_args(g, y0s, x0s, h, w)
    nt, ph, pw, c = g.shape
    lib = _build.load_library()
    origins = torch.tensor([y0s, x0s], dtype=torch.int32).to(g.device)
    out = torch.empty(h, w, c, device=g.device, dtype=torch.float32)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.window_accumulate(
            g.data_ptr(), origins[0].data_ptr(), origins[1].data_ptr(), out.data_ptr(),
            nt, ph, pw, c, h, w, stream,
        )
    _build.check(lib, code, "window_accumulate")
    window_accumulate.launches += 1
    return out


window_accumulate.launches = 0

