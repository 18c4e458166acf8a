"""Tiled encoder MSDA: CUDA kernels and their plain versions.

Counterpart of ``relation_detr_tpu/ops/msda.py::_msda_tiled`` and the
Pallas kernels it reaches (``ops/msda_pallas.py::tiled_matmul_core``,
``ops/msda_sep_pallas.py::sep_contract_fused``), with its helpers under
their JAX names. ``ops/msda.py::multi_scale_deformable_attention`` sends an
encoder-layout call (Q == S, queries in raster order) here under
``set_msda_defaults(impl="tiled")`` or ``impl="tiled_xla"``.

Per level the tokens' samples are gathered by tile (``_perm_take``), a
value patch is sliced per tile (``SlicePatchesFunction``, whose backward is
``window_accumulate``), and the bilinear samples become a contraction of
the patch with a per-tile weight matrix A (T slots x M patch rows):

- ``impl="tiled"``: A from E = 4 P (row, weight) entries per slot
  (``_tiled_entries``), contracted by ``tiled_matmul_core``: kernel
  ``tiled_core_fwd`` forward, ``tiled_core_bwd`` backward
  (``csrc/tiled_msda.cu``);
- ``impl="tiled_xla"``: A = sum_p oy_p (x) ox_p from per-axis soft one-hot
  vectors (``_axis_soft``), contracted by ``_sep_contract`` (plain torch,
  as it is XLA in the JAX package) or, with ``tiled_sep_kernel``, by
  ``sep_contract_fused``: kernel ``sep_contract_fwd`` forward, plain
  ``_fused_bwd`` backward (the JAX package's backward is XLA too).

The levels' contributions are summed and the slots untiled
(``_perm_untile``). Exact against the gather wherever every sampled corner
lies in its tile's patch (offsets within the halo of num_points + 1
texels); a corner beyond it reads the patch border, as in the JAX package.

Every kernel wrapper takes its plain version on CPU tensors, launches its
kernel on CUDA tensors, or raises; each counts its launches.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from relation_detr_tpu_torch import _build
from relation_detr_tpu_torch.ops.patch_scatter import window_accumulate
from relation_detr_tpu_torch.ops.tile_geometry import MARGIN, TILE_TOKENS, _tile_geometry

_DEVICE_INDEX = {}


def _device_index(geo, key, device):
    """The geometry's index constants on ``device``, made once per device:
    perm/inv/valid of the slots and each level's (by, bx) patch origins.
    Made outside inference mode, so that a train step may save them after
    an eval forward cached them."""
    cached = _DEVICE_INDEX.get((key, device))
    if cached is None:
        def put(a):
            with torch.inference_mode(False):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        origins = [(put(y0s.astype(np.int64)).reshape(1, -1, 1, 1, 1),
                    put(x0s.astype(np.int64)).reshape(1, -1, 1, 1, 1))
                   for y0s, x0s, _, _ in geo.patches]
        cached = (put(geo.perm.reshape(-1).astype(np.int64)), put(geo.inv.astype(np.int64)),
                  put(geo.slot_valid.reshape(-1)), origins)
        _DEVICE_INDEX[(key, device)] = cached
    return cached


class _PermTake(torch.autograd.Function):
    """take(x, perm) along dim 1 whose backward is take(g, inv), not a
    scatter. Padding slots (perm points them at token 0) get no gradient
    back: only the untiled outputs leave the op."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.index_select(1, perm)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g.index_select(1, inv), None, None


class _PermUntile(torch.autograd.Function):
    """take(x, inv) along dim 1 (tile slots -> tokens); backward
    take(g, perm) with the padding slots zeroed."""

    @staticmethod
    def forward(ctx, x, inv, perm, valid):
        ctx.save_for_backward(perm, valid)
        return x.index_select(1, inv)

    @staticmethod
    def backward(ctx, g):
        perm, valid = ctx.saved_tensors
        d = g.index_select(1, perm)
        shape = [1] * d.dim()
        shape[1] = valid.shape[0]
        return d * valid.reshape(shape).to(d.dtype), None, None, None


def _perm_take(x, perm, inv):
    return _PermTake.apply(x, perm, inv)


def _perm_untile(x, inv, perm, valid):
    return _PermUntile.apply(x, inv, perm, valid)


@functools.lru_cache(maxsize=None)
def _window_origins(y0u, x0u):
    """(y0s, x0s) tuples of a band grid's windows in row-major tile order,
    made once per grid."""
    return tuple(y for y in y0u for _ in x0u), tuple(x for _ in y0u for x in x0u)


class SlicePatchesFunction(torch.autograd.Function):
    """``_slice_patches`` (order "yx"): vl (B, h, w, C) -> the patch slab
    (B, nt, ph, pw, C), nt = len(y0u) * len(x0u) windows in row-major tile
    order, cut as row bands then column windows. Backward: the windows'
    gradients summed onto the canvas by ``window_accumulate``, once per
    image."""

    @staticmethod
    def forward(ctx, vl, y0u, x0u, ph, pw):
        ctx.grid = (y0u, x0u)
        ctx.canvas = vl.shape[1:3]
        bs, _, _, c = vl.shape
        rows = torch.stack([vl[:, y0:y0 + ph] for y0 in y0u], dim=1)  # (B, gy, ph, w, C)
        cols = torch.stack([rows[:, :, :, x0:x0 + pw] for x0 in x0u], dim=2)  # (B,gy,gx,ph,pw,C)
        return cols.reshape(bs, len(y0u) * len(x0u), ph, pw, c)

    @staticmethod
    def backward(ctx, g):
        y0s, x0s = _window_origins(*ctx.grid)
        h, w = ctx.canvas
        d = torch.stack([window_accumulate(g[b].float().contiguous(), y0s, x0s, h, w,
                                           grid=ctx.grid) for b in range(g.shape[0])])
        return d.to(g.dtype), None, None, None, None


# --- tiled_matmul_core: kernels tiled_core_fwd / tiled_core_bwd ---------------


def _dense_a_t(m_all, w_all, rows):
    """A_t (B, nt, H, M, T) = sum_e one-hot(m[e]) * w[e], entries outside
    [0, M) dropped (no row matches them), as the Pallas ``_build_a_t``."""
    iota = torch.arange(rows, device=m_all.device).reshape(rows, 1)
    a_t = None
    for e in range(m_all.shape[3]):
        term = torch.where(iota == m_all[:, :, :, e, None, :], w_all[:, :, :, e, None, :], 0.0)
        a_t = term if a_t is None else a_t + term
    return a_t


def tiled_core_reference(m_all, w_all, patch, dims):
    """Plain version of ``tiled_core_fwd``: the dense one-hot A_t built per
    (b, tile, head) and contracted with ``torch.einsum``; autograd gives
    its backward. m_all, w_all (B, nt, H, E, T), patch (B, nt, M, C) ->
    (B, nt, T, C)."""
    num_heads, head_dim = dims
    bs, nt, _, _, t = m_all.shape
    rows = patch.shape[2]
    a_t = _dense_a_t(m_all, w_all, rows)
    out = torch.einsum("bnhmt,bnmhd->bnthd", a_t,
                       patch.reshape(bs, nt, rows, num_heads, head_dim))
    return out.reshape(bs, nt, t, num_heads * head_dim)


def tiled_core_backward_reference(m_all, w_all, patch, g, dims):
    """Plain version of ``tiled_core_bwd``: (dw (B, nt, H, E, T), dpatch
    (B, nt, M, C)) with dpatch = A_t g and dw[e, t] = (patch g^T)[m[e, t], t]
    (0 for an entry outside [0, M))."""
    num_heads, head_dim = dims
    bs, nt, _, _, t = m_all.shape
    rows = patch.shape[2]
    g5 = g.reshape(bs, nt, t, num_heads, head_dim)
    p5 = patch.reshape(bs, nt, rows, num_heads, head_dim)
    dpatch = torch.einsum("bnhmt,bnthd->bnmhd", _dense_a_t(m_all, w_all, rows), g5)
    da_t = torch.einsum("bnmhd,bnthd->bnhmt", p5, g5)
    idx = m_all.long()
    inside = (idx >= 0) & (idx < rows)
    dw = torch.where(inside, torch.gather(da_t, 3, idx.clamp(0, rows - 1)), 0.0)
    return dw, dpatch.reshape(bs, nt, rows, num_heads * head_dim)


_MAX_SMEM = 232448  # bytes of shared memory a Hopper block may use


def _bwd_smem_bytes(rows, head_dim, e, t):
    """Dynamic shared memory of ``tiled_core_bwd`` (csrc/tiled_msda.cu::
    bwd_smem_bytes): two stages of the swizzled patch and g slices (whole
    128-byte lines), m and w; a (row, warp) histogram of 16 warps, 32 ints
    of scan scratch; one (weight, slot) pair per entry."""
    def lines(n):
        return -(-n // 32) * 32

    stage = lines(rows * head_dim) + lines(t * head_dim) + 2 * e * t
    return (2 * stage + -(-rows * 16 // 4) * 4 + 32) * 4 + e * t * 8


def _fwd_smem_bytes(rows, head_dim, e, t):
    """Dynamic shared memory of ``tiled_core_fwd`` (csrc/tiled_msda.cu::
    fwd_smem_bytes): two stages of the patch slice, m and w."""
    return 2 * (-(-rows * head_dim // 4) * 4 + 2 * e * t) * 4


def _check_core_args(m_all, w_all, patch, dims, g=None):
    tensors = (m_all, w_all, patch) if g is None else (m_all, w_all, patch, g)
    if any(t.device != patch.device for t in tensors):
        raise ValueError("tiled core: all tensors must be on one device")
    if m_all.dtype != torch.int32 or any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("tiled core kernels take int32 m_all and float32 w_all/patch/g")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("tiled core kernels take contiguous tensors only")
    num_heads, head_dim = dims
    bs, nt, h, e, t = m_all.shape
    if h != num_heads or w_all.shape != m_all.shape:
        raise ValueError(f"tiled core: m_all {tuple(m_all.shape)}, w_all {tuple(w_all.shape)}, "
                         f"heads {num_heads}")
    if patch.dim() != 4 or patch.shape[:2] != (bs, nt) or patch.shape[3] != num_heads * head_dim:
        raise ValueError(f"tiled core: bad patch {tuple(patch.shape)}")
    if g is not None and g.shape != (bs, nt, t, num_heads * head_dim):
        raise ValueError(f"tiled core backward: bad g {tuple(g.shape)}")
    if head_dim not in (4, 8, 16, 32) or (e * t) % 4:
        raise ValueError(f"tiled core kernels take a head dim of 4, 8, 16 or 32 and E * T a "
                         f"multiple of 4, got {head_dim} and {e} * {t}")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("tiled core kernels take 16-byte aligned tensors only")
    rows = patch.shape[2]
    smem = (_fwd_smem_bytes if g is None else _bwd_smem_bytes)(rows, head_dim, e, t)
    if smem > _MAX_SMEM:
        raise ValueError(f"tiled core: a {rows}-row patch needs {smem} bytes of shared "
                         "memory, more than a Hopper block has")


def _tiled_core_fwd(m_all, w_all, patch, dims):
    _check_core_args(m_all, w_all, patch, dims)
    lib = _build.load_library()
    bs, nt, num_heads, e, t = m_all.shape
    rows, c = patch.shape[2:]
    out = torch.empty(bs, nt, t, c, device=patch.device, dtype=torch.float32)
    with torch.cuda.device(patch.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.tiled_core_fwd(m_all.data_ptr(), w_all.data_ptr(), patch.data_ptr(),
                                  out.data_ptr(), bs, nt, num_heads, e, t, rows, c, stream)
    _build.check(lib, code, "tiled_core_fwd")
    tiled_matmul_core.launches += 1
    return out


def tiled_core_backward(m_all, w_all, patch, g, dims):
    """(dw, dpatch) of ``tiled_matmul_core`` for the cotangent g
    (B, nt, T, C): ``tiled_core_backward_reference`` on CPU tensors, kernel
    ``tiled_core_bwd`` on CUDA tensors (head dim 4, 8, 16 or 32), or
    raises. The kernel sums each dpatch row's entries in ascending (e, t)
    and dw's channels in order: two launches give the same bits."""
    if patch.device.type == "cpu":
        return tiled_core_backward_reference(m_all, w_all, patch, g, dims)
    if patch.device.type != "cuda":
        raise ValueError(f"tiled core: no kernel for device {patch.device}")
    _check_core_args(m_all, w_all, patch, dims, g)
    lib = _build.load_library()
    bs, nt, num_heads, e, t = m_all.shape
    rows, c = patch.shape[2:]
    dw = torch.empty_like(w_all)
    dpatch = torch.empty_like(patch)
    with torch.cuda.device(patch.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.tiled_core_bwd(m_all.data_ptr(), w_all.data_ptr(), patch.data_ptr(),
                                  g.data_ptr(), dw.data_ptr(), dpatch.data_ptr(), bs, nt,
                                  num_heads, e, t, rows, c, stream)
    _build.check(lib, code, "tiled_core_bwd")
    tiled_core_backward.launches += 1
    return dw, dpatch


tiled_core_backward.launches = 0


class TiledCoreFunction(torch.autograd.Function):
    """``tiled_matmul_core``: forward ``tiled_core_fwd`` (or its plain
    version on CPU), backward ``tiled_core_backward``; m_all gets no
    gradient."""

    @staticmethod
    def forward(ctx, m_all, w_all, patch, dims):
        ctx.dims = dims
        ctx.save_for_backward(m_all, w_all, patch)
        if patch.device.type == "cpu":
            return tiled_core_reference(m_all, w_all, patch, dims)
        return _tiled_core_fwd(m_all, w_all, patch, dims)

    @staticmethod
    def backward(ctx, g):
        m_all, w_all, patch = ctx.saved_tensors
        dw, dpatch = tiled_core_backward(m_all, w_all, patch, g.contiguous(), ctx.dims)
        return None, dw, dpatch, None


def tiled_matmul_core(m_all, w_all, patch, dims: Tuple[int, int]):
    """out (B, nt, T, C) = per-(b, tile, head) A @ patch, A from the entries
    m_all (int32) and w_all (B, nt, H, E, T); dims = (H, D)."""
    if patch.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tiled core: no kernel for device {patch.device}")
    return TiledCoreFunction.apply(m_all, w_all, patch, tuple(dims))


tiled_matmul_core.launches = 0


# --- separable contraction: _sep_contract and kernel sep_contract_fwd ---------


def _sep_a(oy, ox):
    """A (B, nt, H, ph, pw, T) = sum_p oy_p (x) ox_p."""
    return torch.sum(oy[..., :, None, :] * ox[..., None, :, :], dim=3)


class _SepContract(torch.autograd.Function):
    """``_sep_contract`` (order "yx"), plain torch: out (B, nt, H, D, T) =
    sum_{p,y,x} oy[p,y,t] ox[p,x,t] patch[y,x,d] for oy (B,nt,H,P,ph,T), ox
    (B,nt,H,P,pw,T), patch (B,nt,ph,pw,H,D). The backward is two A-sized
    einsums and two broadcast reductions, as ``_sep_contract_bwd`` (autograd
    of the P-sum would hold (B,nt,H,P,ph,pw,T) products)."""

    @staticmethod
    def forward(ctx, oy, ox, patch6):
        ctx.save_for_backward(oy, ox, patch6)
        return torch.einsum("bnhyxt,bnyxhd->bnhdt", _sep_a(oy, ox), patch6)

    @staticmethod
    def backward(ctx, g):
        oy, ox, patch6 = ctx.saved_tensors
        da = torch.einsum("bnhdt,bnyxhd->bnhyxt", g, patch6)
        d_oy = torch.sum(da[:, :, :, None] * ox[..., None, :, :], dim=-2)
        d_ox = torch.sum(da[:, :, :, None] * oy[..., :, None, :], dim=-3)
        d_patch = torch.einsum("bnhyxt,bnhdt->bnyxhd", _sep_a(oy, ox), g)
        return d_oy, d_ox, d_patch


def _sep_contract(oy, ox, patch6):
    return _SepContract.apply(oy, ox, patch6)


def sep_contract_reference(oy, ox, patch):
    """Plain version of ``sep_contract_fwd``: A = sum_p oy_p (x) ox_p, then
    per head out = A^T patch. oy (B,nt,H,P,ph,T), ox (B,nt,H,P,pw,T), patch
    (B,nt,ph*pw,C) -> (B,nt,T,C)."""
    bs, nt, num_heads, _, ph, t = oy.shape
    pw = ox.shape[4]
    c = patch.shape[3]
    a = _sep_a(oy, ox).reshape(bs, nt, num_heads, ph * pw, t)
    out = torch.einsum("bnhmt,bnmhd->bnthd", a,
                       patch.reshape(bs, nt, ph * pw, num_heads, c // num_heads))
    return out.reshape(bs, nt, t, c)


def _fused_bwd(oy, ox, patch, g):
    """(d_oy, d_ox, d_patch) of ``sep_contract_fused`` for g (B,nt,T,C):
    the A-sized einsums of ``msda_sep_pallas.py::_fused_bwd``."""
    bs, nt, num_heads, _, ph, t = oy.shape
    pw = ox.shape[4]
    c = patch.shape[3]
    head_dim = c // num_heads
    g5 = g.reshape(bs, nt, t, num_heads, head_dim).permute(0, 1, 3, 2, 4)  # (B,nt,H,T,D)
    patch6 = patch.reshape(bs, nt, ph, pw, num_heads, head_dim)
    da = torch.einsum("bnhtd,bnyxhd->bnhyxt", g5, patch6)
    d_oy = torch.sum(da[:, :, :, None] * ox[..., None, :, :], dim=-2)
    d_ox = torch.sum(da[:, :, :, None] * oy[..., :, None, :], dim=-3)
    d_patch = torch.einsum("bnhyxt,bnhtd->bnyxhd", _sep_a(oy, ox), g5)
    return d_oy, d_ox, d_patch.reshape(bs, nt, ph * pw, c)


# csrc/tiled_msda.cu's sep_contract_fwd: kSepMaxP, 2 x kSepXSlots, and its
# two A chunks (2 x kSepChunkRows x kSepTokens floats) beside the patch slice
_SEP_MAX_POINTS = 4
_SEP_MAX_PW = 20
_SEP_A_FLOATS = 2 * 40 * 128


def _sep_contract_fwd(oy, ox, patch):
    tensors = (oy, ox, patch)
    if any(t.device != patch.device for t in tensors):
        raise ValueError("sep_contract_fused: all tensors must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("sep_contract_fwd takes float32 tensors only")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("sep_contract_fwd takes contiguous tensors only")
    bs, nt, num_heads, points, ph, t = oy.shape
    pw = ox.shape[4]
    if ox.shape != (bs, nt, num_heads, points, pw, t):
        raise ValueError(f"sep_contract_fused: oy {tuple(oy.shape)}, ox {tuple(ox.shape)}")
    if patch.dim() != 4 or patch.shape[:3] != (bs, nt, ph * pw) or patch.shape[3] % num_heads:
        raise ValueError(f"sep_contract_fused: bad patch {tuple(patch.shape)}")
    c = patch.shape[3]
    head_dim = c // num_heads
    if head_dim not in (4, 8, 16, 32) or points > _SEP_MAX_POINTS or pw > _SEP_MAX_PW:
        raise ValueError(f"sep_contract_fwd takes D = C / H of 4, 8, 16 or 32, at most "
                         f"{_SEP_MAX_POINTS} points and patches at most {_SEP_MAX_PW} wide; "
                         f"got D={head_dim}, P={points}, pw={pw}")
    if (-(-ph * pw * head_dim // 4) * 4 + _SEP_A_FLOATS) * 4 > _MAX_SMEM:
        raise ValueError(f"sep_contract_fwd: a {ph}x{pw} patch needs more shared memory "
                         "than a Hopper block has")
    if patch.data_ptr() % 16:
        raise ValueError("sep_contract_fwd takes a 16-byte aligned patch")
    lib = _build.load_library()
    out = torch.empty(bs, nt, t, c, device=patch.device, dtype=torch.float32)
    with torch.cuda.device(patch.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sep_contract_fwd(oy.data_ptr(), ox.data_ptr(), patch.data_ptr(),
                                    out.data_ptr(), bs, nt, num_heads, points, ph, pw, t, c,
                                    stream)
    _build.check(lib, code, "sep_contract_fwd")
    sep_contract_fused.launches += 1
    return out


class SepContractFunction(torch.autograd.Function):
    """``sep_contract_fused``: forward ``sep_contract_fwd`` (or its plain
    version on CPU), backward ``_fused_bwd`` in plain torch."""

    @staticmethod
    def forward(ctx, oy, ox, patch):
        ctx.save_for_backward(oy, ox, patch)
        if patch.device.type == "cpu":
            return sep_contract_reference(oy, ox, patch)
        return _sep_contract_fwd(oy, ox, patch)

    @staticmethod
    def backward(ctx, g):
        oy, ox, patch = ctx.saved_tensors
        return _fused_bwd(oy, ox, patch, g)


def sep_contract_fused(oy, ox, patch):
    """out (B, nt, T, C) = per-(b, tile, head) [sum_p oy_p (x) ox_p]^T patch."""
    if patch.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sep_contract_fused: no kernel for device {patch.device}")
    return SepContractFunction.apply(oy, ox, patch)


sep_contract_fused.launches = 0


# --- the op --------------------------------------------------------------------


def _tiled_entries(x0i, y0i, fx, fy, attn, bx, by, ph, pw, h, w):
    """Per-entry patch row (int32) and folded weight (fp32), (B, nt, H, E, T)
    with entry e = corner * P + point, corners (0,0), (0,1), (1,0), (1,1):
    the ``need_entries`` branch of ``_msda_tiled``. Corners off the level
    weigh 0; corners off the patch read its border row or column."""
    ms, ws = [], []
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        cy = y0i + dy
        ly = torch.clamp(cy - by, 0, ph - 1)
        vy = (cy >= 0) & (cy < h)
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            cx = x0i + dx
            lx = torch.clamp(cx - bx, 0, pw - 1)
            in_level = (cx >= 0) & (cx < w) & vy
            ms.append(ly * pw + lx)
            ws.append(attn * wy * wx * in_level)
    return (torch.cat(ms, dim=-2).to(torch.int32).contiguous(),
            torch.cat(ws, dim=-2).contiguous())


def _axis_soft(c0, frac, base, psize, lim, fold):
    """(B, nt, H, P, psize, T) soft one-hot over one patch axis: the two
    taps' weights (times ``fold``) at their clamped patch slots, zero off
    the level."""
    iota = torch.arange(psize, device=c0.device).reshape(psize, 1)
    acc = None
    for d, wgt in ((0, 1.0 - frac), (1, frac)):
        c = c0 + d
        slot = torch.clamp(c - base, 0, psize - 1)
        w_c = (wgt if fold is None else fold * wgt) * ((c >= 0) & (c < lim))
        term = w_c[..., None, :] * (slot[..., None, :] == iota)
        acc = term if acc is None else acc + term
    return acc


def tiled_level_operands(value, spatial_shapes, sampling_locations, attention_weights):
    """What the tiled contraction takes: (consts, levels). consts holds the
    geometry's nt, T and untile indices; levels, per level, a dict of the
    patch (B, nt, M, C), the sample (x0i, y0i, fx, fy, attn, bx, by), each
    (B, nt, H, P, T) but the (1, nt, 1, 1, 1) patch origins, and ph, pw, h,
    w."""
    bs, total, num_heads, head_dim = value.shape
    _, num_queries, _, num_levels, num_points, _ = sampling_locations.shape
    if num_queries != total or sum(h * w for h, w in spatial_shapes) != total:
        raise ValueError("tiled MSDA takes queries == raster tokens (encoder layout); got "
                         f"Q={num_queries}, S={total}, levels {tuple(spatial_shapes)}")
    key = (tuple(spatial_shapes), TILE_TOKENS, (num_points + 1,) * num_levels, MARGIN)
    geo = _tile_geometry(*key)
    nt, t = geo.ntiles, geo.T
    perm, inv, valid, origins = _device_index(geo, key, value.device)
    loc_t = _perm_take(sampling_locations.float().reshape(bs, num_queries, -1), perm, inv)
    loc_t = loc_t.reshape(bs, nt, t, num_heads, num_levels, num_points, 2)
    loc_t = loc_t.permute(0, 1, 3, 4, 5, 6, 2)  # (B, nt, H, L, P, 2, T)
    attn_t = _perm_take(attention_weights.float().reshape(bs, num_queries, -1), perm, inv)
    attn_t = attn_t.reshape(bs, nt, t, num_heads, num_levels, num_points)
    attn_t = attn_t.permute(0, 1, 3, 4, 5, 2)  # (B, nt, H, L, P, T)
    vflat = value.float().reshape(bs, total, num_heads * head_dim)
    levels, start = [], 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        _, _, ph, pw = geo.patches[lvl]
        y0u, x0u = geo.patch_grid[lvl]
        vl = vflat[:, start:start + h * w].reshape(bs, h, w, num_heads * head_dim)
        start += h * w
        patch = SlicePatchesFunction.apply(vl, y0u, x0u, ph, pw)
        loc = loc_t[:, :, :, lvl]  # (B, nt, H, P, 2, T)
        x = loc[:, :, :, :, 0] * w - 0.5  # two roundings, as the JAX package
        y = loc[:, :, :, :, 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        by, bx = origins[lvl]
        levels.append(dict(
            patch=patch.reshape(bs, nt, ph * pw, num_heads * head_dim),
            sample=(x0.long(), y0.long(), x - x0, y - y0, attn_t[:, :, :, lvl], bx, by),
            ph=ph, pw=pw, h=h, w=w))
    return dict(nt=nt, T=t, perm=perm, inv=inv, valid=valid), levels


def msda_tiled(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    use_pallas: bool,
    sep_kernel: bool = False,
) -> torch.Tensor:
    """``_msda_tiled``: (B, S, H, D) x (B, S, H, L, P, 2) x (B, S, H, L, P)
    -> (B, S, H * D), any batch size. ``use_pallas`` selects the entry
    route (``tiled_matmul_core``), else the separable build, contracted by
    ``sep_contract_fused`` if ``sep_kernel`` else by ``_sep_contract``."""
    in_dtype = value.dtype
    bs, _, num_heads, head_dim = value.shape
    consts, levels = tiled_level_operands(value, spatial_shapes, sampling_locations,
                                          attention_weights)
    parts = []
    for lvl in levels:
        x0i, y0i, fx, fy, attn, bx, by = lvl["sample"]
        ph, pw, h, w = lvl["ph"], lvl["pw"], lvl["h"], lvl["w"]
        if use_pallas:
            m_all, w_all = _tiled_entries(x0i, y0i, fx, fy, attn, bx, by, ph, pw, h, w)
            parts.append(tiled_matmul_core(m_all, w_all, lvl["patch"], (num_heads, head_dim)))
            continue
        oy = _axis_soft(y0i, fy, by, ph, h, attn)
        ox = _axis_soft(x0i, fx, bx, pw, w, None)
        if sep_kernel:
            parts.append(sep_contract_fused(oy.contiguous(), ox.contiguous(), lvl["patch"]))
        else:
            patch6 = lvl["patch"].reshape(bs, consts["nt"], ph, pw, num_heads, head_dim)
            parts.append(_sep_contract(oy, ox, patch6))  # (B, nt, H, D, T)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    if not use_pallas and not sep_kernel:
        out = out.permute(0, 1, 4, 2, 3)  # (B, nt, T, H, D)
    out = out.reshape(bs, consts["nt"] * consts["T"], num_heads * head_dim)
    return _perm_untile(out, consts["inv"], consts["perm"], consts["valid"]).to(in_dtype)
