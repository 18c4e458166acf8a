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
kernel on CUDA tensors, or raises; each counts its launches. The two
forward kernels are ops of ``ops/library.py`` (``relation_detr::
tiled_core_fwd``, ``::sep_contract_fwd``), called directly when no input
needs a gradient.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from relation_detr_tpu_torch import _build
from relation_detr_tpu_torch.ops import library
from relation_detr_tpu_torch.ops.msda_settings import (
    _MSDA_DEFAULTS,
    dot_bf16_enabled,
    resolve_tiled_dtype,
)
from relation_detr_tpu_torch.ops.patch_scatter import window_accumulate
from relation_detr_tpu_torch.ops.tile_geometry import _tile_geometry

_DEVICE_INDEX = {}


def _device_index(geo, key, device):
    """The geometry's index constants on ``device``, made once per device:
    perm/inv/valid of the slots and each level's (by, bx) patch origins.
    Made outside inference mode, so that a train step may save them after
    an eval forward cached them. While ``torch.export`` traces, they are made
    anew (the trace's constants) and not cached: they would be fake."""
    tracing = torch.compiler.is_compiling()
    cached = None if tracing else _DEVICE_INDEX.get((key, device))
    if cached is None:
        def put(a):
            with torch.inference_mode(False):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        origins = [(put(y0s.astype(np.int64)).reshape(1, -1, 1, 1, 1),
                    put(x0s.astype(np.int64)).reshape(1, -1, 1, 1, 1))
                   for y0s, x0s, _, _ in geo.patches]
        cached = (put(geo.perm.reshape(-1).astype(np.int64)), put(geo.inv.astype(np.int64)),
                  put(geo.slot_valid.reshape(-1)), origins)
        if not tracing:
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
    """``_slice_patches``: vl (B, h, w, C) -> the patch slab of nt =
    len(y0u) * len(x0u) windows in row-major tile order, cut as row bands
    then column windows, in the element order ``order`` (the JAX package's
    ``tiled_slab_order``): "yx" (B, nt, ph, pw, C), "xy" (B, nt, pw, ph, C)
    or "bm" (nt, ph, pw, B, C). Backward: the gradient back in "yx" order,
    the windows' gradients summed onto the canvas in fp32 by
    ``window_accumulate``, once per image, and rounded to the slab's dtype."""

    @staticmethod
    def forward(ctx, vl, y0u, x0u, ph, pw, order="yx"):
        ctx.grid = (y0u, x0u)
        ctx.canvas = vl.shape[1:3]
        ctx.order = order
        bs, _, _, c = vl.shape
        rows = torch.stack([vl[:, y0:y0 + ph] for y0 in y0u], dim=1)  # (B, gy, ph, w, C)
        cols = torch.stack([rows[:, :, :, x0:x0 + pw] for x0 in x0u], dim=2)  # (B,gy,gx,ph,pw,C)
        slab = cols.reshape(bs, len(y0u) * len(x0u), ph, pw, c)
        if order == "xy":
            return slab.transpose(2, 3).contiguous()
        if order == "bm":
            return slab.permute(1, 2, 3, 0, 4).contiguous()
        return slab

    @staticmethod
    def backward(ctx, g):
        if ctx.order == "xy":
            g = g.transpose(2, 3)
        elif ctx.order == "bm":
            g = g.permute(3, 0, 1, 2, 4)
        y0s, x0s = _window_origins(*ctx.grid)
        h, w = ctx.canvas
        d = torch.stack([window_accumulate(g[b].float().contiguous(), y0s, x0s, h, w,
                                           grid=ctx.grid) for b in range(g.shape[0])])
        return d.to(g.dtype), None, None, None, None, None


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
    128-byte lines), m and w, or one where two exceed ``_MAX_SMEM``; a
    (row, warp) histogram of 16 warps, 32 ints of scan scratch; one
    (weight, slot) pair per entry."""
    def lines(n):
        return -(-n // 32) * 32

    stage = lines(rows * head_dim) + lines(t * head_dim) + 2 * e * t
    for stages in (2, 1):
        smem = (stages * stage + -(-rows * 16 // 4) * 4 + 32) * 4 + e * t * 8
        if smem <= _MAX_SMEM:
            break
    return smem


def _fwd_smem_bytes(rows, head_dim, e, t):
    """Dynamic shared memory of ``tiled_core_fwd`` (csrc/tiled_msda.cu::
    fwd_smem_bytes): two stages of the patch slice, m and w, or one where
    two exceed ``_MAX_SMEM``."""
    stage = (-(-rows * head_dim // 4) * 4 + 2 * e * t) * 4
    return 2 * stage if 2 * stage <= _MAX_SMEM else stage


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
        raise ValueError(f"tiled core: a {rows}-row patch with {t} token slots needs {smem} "
                         f"bytes of shared memory, more than the {_MAX_SMEM} a Hopper block "
                         "may use")


def _tiled_core_fwd(m_all, w_all, patch, num_heads, head_dim):
    """The op's CUDA implementation."""
    dims = (num_heads, head_dim)
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


library.impl("tiled_core_fwd",
             cpu=lambda m_all, w_all, patch, num_heads, head_dim: tiled_core_reference(
                 m_all, w_all, patch, (num_heads, head_dim)),
             cuda=_tiled_core_fwd)
_TILED_CORE_FWD = library.OPS.tiled_core_fwd.default


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
    """``tiled_matmul_core``: forward the op ``tiled_core_fwd`` (its plain
    version on CPU), backward ``tiled_core_backward``; m_all gets no
    gradient."""

    @staticmethod
    def forward(ctx, m_all, w_all, patch, dims):
        ctx.dims = dims
        ctx.save_for_backward(m_all, w_all, patch)
        return _TILED_CORE_FWD(m_all, w_all, patch, *dims)

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
    if not library.needs_grad(w_all, patch):
        return _TILED_CORE_FWD(m_all, w_all, patch, *dims)
    return TiledCoreFunction.apply(m_all, w_all, patch, tuple(dims))


tiled_matmul_core.launches = 0


# --- separable contraction: _sep_contract and kernel sep_contract_fwd ---------


def _sep_a(oy, ox):
    """A (B, nt, H, ph, pw, T) = sum_p oy_p (x) ox_p, in the operands' dtype."""
    return torch.sum(oy[..., :, None, :] * ox[..., None, :, :], dim=3)


# einsum subscripts per slab order (``_SEP_SUBS``): (forward, d_A from g, d_patch)
_SEP_SUBS = {
    "yx": ("bnhyxt,bnyxhd->bnhdt", "bnhdt,bnyxhd->bnhyxt", "bnhyxt,bnhdt->bnyxhd"),
    "xy": ("bnhyxt,bnxyhd->bnhdt", "bnhdt,bnxyhd->bnhyxt", "bnhyxt,bnhdt->bnxyhd"),
    "bm": ("bnhyxt,nyxbhd->bnhdt", "bnhdt,nyxbhd->bnhyxt", "bnhyxt,bnhdt->nyxbhd"),
}


def _boundary_cast(*ops):
    """fp32 contraction operands to bf16 where ``tiled_dot_bf16`` resolves
    on (``_boundary_cast``)."""
    if dot_bf16_enabled():
        return tuple(o.to(torch.bfloat16) if o.dtype == torch.float32 else o for o in ops)
    return ops


def _dot(subs, a, b):
    """``einsum(subs)`` of two operands as JAX's ``preferred_element_type=
    float32``: the operands upcast to fp32 (exactly), the sums fp32."""
    return torch.einsum(subs, a.float(), b.float())


class _SepContract(torch.autograd.Function):
    """``_sep_contract``, plain torch: out (B, nt, H, D, T) fp32 =
    sum_{p,y,x} oy[p,y,t] ox[p,x,t] patch[y,x,d] for oy (B,nt,H,P,ph,T), ox
    (B,nt,H,P,pw,T) and the patch slab in ``order``'s layout
    ((B,nt,ph,pw,H,D), (B,nt,pw,ph,H,D) or (nt,ph,pw,B,H,D)); A is built in
    the operands' dtype (bf16 under ``tiled_dtype`` bf16). The backward is
    two A-sized contractions and two broadcast reductions, as
    ``_sep_contract_bwd`` (autograd of the P-sum would hold (B,nt,H,P,ph,pw,T)
    products); its gradients come back in the operands' dtypes."""

    @staticmethod
    def forward(ctx, oy, ox, patch6, order):
        ctx.order = order
        ctx.save_for_backward(oy, ox, patch6)
        return _dot(_SEP_SUBS[order][0], *_boundary_cast(_sep_a(oy, ox), patch6))

    @staticmethod
    def backward(ctx, g):
        oy, ox, patch6 = ctx.saved_tensors
        subs = _SEP_SUBS[ctx.order]
        da = _dot(subs[1], *_boundary_cast(g, patch6))
        d_oy = torch.sum(da[:, :, :, None] * ox.float()[..., None, :, :], dim=-2)
        d_ox = torch.sum(da[:, :, :, None] * oy.float()[..., :, None, :], dim=-3)
        d_patch = _dot(subs[2], *_boundary_cast(_sep_a(oy, ox), g))
        return d_oy.to(oy.dtype), d_ox.to(ox.dtype), d_patch.to(patch6.dtype), None


def _sep_contract(oy, ox, patch6, order="yx"):
    return _SepContract.apply(oy, ox, patch6, order)


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
    the A-sized einsums of ``msda_sep_pallas.py::_fused_bwd``, in fp32 on the
    operands as they are (bf16 under ``tiled_dtype`` bf16), each gradient
    in its operand's dtype."""
    bs, nt, num_heads, _, ph, t = oy.shape
    pw = ox.shape[4]
    c = patch.shape[3]
    head_dim = c // num_heads
    g5 = g.reshape(bs, nt, t, num_heads, head_dim).permute(0, 1, 3, 2, 4)  # (B,nt,H,T,D)
    patch6 = patch.reshape(bs, nt, ph, pw, num_heads, head_dim)
    da = _dot("bnhtd,bnyxhd->bnhyxt", g5, patch6)
    d_oy = torch.sum(da[:, :, :, None] * ox.float()[..., None, :, :], dim=-2)
    d_ox = torch.sum(da[:, :, :, None] * oy.float()[..., :, None, :], dim=-3)
    d_patch = _dot("bnhyxt,bnhtd->bnyxhd", _sep_a(oy, ox), g5)
    return (d_oy.to(oy.dtype), d_ox.to(ox.dtype),
            d_patch.reshape(bs, nt, ph * pw, c).to(patch.dtype))


# csrc/tiled_msda.cu's sep_contract_fwd: kSepMaxP, 2 x kSepXSlotsWide, and its
# two A chunks (2 x kSepChunkRows x kSepTokens floats) beside the patch slice
_SEP_MAX_POINTS = 4
_SEP_MAX_PW = 32
_SEP_A_FLOATS = 2 * 40 * 128


def _sep_contract_fwd(oy, ox, patch):
    """The op's CUDA implementation."""
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
    smem = (-(-ph * pw * head_dim // 4) * 4 + _SEP_A_FLOATS) * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"sep_contract_fwd: a {ph}x{pw} patch needs {smem} bytes of shared "
                         f"memory, more than the {_MAX_SMEM} a Hopper block may use")
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


library.impl("sep_contract_fwd", cpu=sep_contract_reference, cuda=_sep_contract_fwd)
_SEP_FWD = library.OPS.sep_contract_fwd.default


class SepContractFunction(torch.autograd.Function):
    """``sep_contract_fused``: forward the op ``sep_contract_fwd`` (its
    plain version on CPU), backward ``_fused_bwd`` in plain torch."""

    @staticmethod
    def forward(ctx, oy, ox, patch):
        ctx.save_for_backward(oy, ox, patch)
        return _SEP_FWD(oy.float(), ox.float(), patch.float())

    @staticmethod
    def backward(ctx, g):
        oy, ox, patch = ctx.saved_tensors
        return _fused_bwd(oy, ox, patch, g)


def sep_contract_fused(oy, ox, patch):
    """out (B, nt, T, C) = per-(b, tile, head) [sum_p oy_p (x) ox_p]^T patch;
    the kernel takes fp32 of bf16 operands, as the JAX entry feeds its
    Pallas kernel."""
    if patch.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sep_contract_fused: no kernel for device {patch.device}")
    if not library.needs_grad(oy, ox, patch):
        return _SEP_FWD(oy.float(), ox.float(), patch.float())
    return SepContractFunction.apply(oy, ox, patch)


sep_contract_fused.launches = 0


# --- the op --------------------------------------------------------------------


def _tiled_entries(x0i, y0i, fx, fy, attn, bx, by, ph, pw, h, w, overflow=False):
    """Per-entry patch row (int32) and folded weight (fp32), (B, nt, H, E, T)
    with entry e = corner * P + point, corners (0,0), (0,1), (1,0), (1,1):
    the ``need_entries`` branch of ``_msda_tiled``. Corners off the level
    weigh 0; corners off the patch read its border row or column. With
    ``overflow`` also, per entry, whether it lies on the level but off the
    patch, its level row, and the level row of the border slot it reads."""
    ms, ws, bads, gids, gclamps = [], [], [], [], []
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        cy = y0i + dy
        ly = torch.clamp(cy - by, 0, ph - 1)
        vy = (cy >= 0) & (cy < h)
        off_y = (cy - by < 0) | (cy - by > ph - 1)
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            cx = x0i + dx
            lx = torch.clamp(cx - bx, 0, pw - 1)
            in_level = (cx >= 0) & (cx < w) & vy
            ms.append(ly * pw + lx)
            ws.append(attn * wy * wx * in_level)
            if overflow:
                bads.append(in_level & (off_y | (cx - bx < 0) | (cx - bx > pw - 1)))
                gids.append(torch.clamp(cy, 0, h - 1) * w + torch.clamp(cx, 0, w - 1))
                gclamps.append((ly + by) * w + (lx + bx))
    m_all = torch.cat(ms, dim=-2).to(torch.int32).contiguous()
    w_all = torch.cat(ws, dim=-2).contiguous()
    if not overflow:
        return m_all, w_all
    return m_all, w_all, (torch.cat(bads, dim=-2), torch.cat(gids, dim=-2),
                          torch.cat(gclamps, dim=-2))


def overflow_capacity(halos_auto: bool) -> int:
    """The overflow capacity K per (tile, head, level) under the settings:
    ``tiled_overflow``, "auto" = 0 under auto halos, else 8; 0 under
    t_major (``_msda_tiled``'s rule)."""
    d = _MSDA_DEFAULTS
    if d["tiled_layout"] == "t_major":
        return 0
    k = d["tiled_overflow"]
    return (0 if halos_auto else 8) if k == "auto" else k


def _overflow_ranks(bad):
    """Each entry's rank among the off-patch entries ``bad`` (B, nt, H, E,
    T) of its (image, tile, head): token-major, then by entry e within the
    token (a cumsum in place of the JAX package's triangular matmuls: the
    same ranks). int64, meaningful where ``bad``."""
    bad_i = bad.to(torch.int64)
    count_t = bad_i.sum(dim=-2)  # (B, nt, H, T)
    base_t = torch.cumsum(count_t, dim=-1) - count_t  # exclusive prefix over tokens
    return base_t[..., None, :] + torch.cumsum(bad_i, dim=-2) - bad_i  # then over entries


def _overflow_residual(w_all, bad, gid, gclamp, vl, k, dims):
    """The exact side channel for corners off their tile's patch
    (``_msda_tiled``'s ``overflow_k > 0`` branch), plain torch: per (image,
    tile, head) the first ``k`` such entries by ``_overflow_ranks`` fetch
    the true corner and the border slot the clamped contraction read from
    the level map ``vl`` (B, h, w, C) and add w * (v[true] - v[border]), the
    difference in ``vl``'s dtype. Entries past ``k`` keep the border clamp.
    The index buffers get no gradient; the weights and the fetched values
    do. Returns (B, nt, H, T, D) fp32."""
    num_heads, head_dim = dims
    bs, nt, _, _, t = w_all.shape
    pos = _overflow_ranks(bad)
    handled = bad & (pos < k)
    items = bs * nt * num_heads
    dev = w_all.device
    item_ix = torch.arange(items, device=dev).reshape(bs, nt, num_heads, 1, 1)
    slot = (item_ix * k + pos)[handled]  # distinct: ranks are distinct within an item
    t_ix = torch.arange(t, device=dev).expand(w_all.shape)

    def buffer(x):
        return torch.zeros(items * k, dtype=torch.int64, device=dev).index_put(
            (slot,), x[handled].to(torch.int64)).reshape(bs, nt, num_heads, k)

    row_buf, border_buf, t_buf = buffer(gid), buffer(gclamp), buffer(t_ix)
    w_buf = w_all.new_zeros(items * k).index_put((slot,), w_all[handled]).reshape(
        bs, nt, num_heads, k)
    vhw = vl.reshape(bs, -1, num_heads, head_dim)
    b_ix = torch.arange(bs, device=dev).reshape(bs, 1, 1, 1)
    h_ix = torch.arange(num_heads, device=dev).reshape(1, 1, num_heads, 1)
    both = vhw[b_ix, torch.cat([row_buf, border_buf], dim=-1), h_ix]  # (B, nt, H, 2K, D)
    vals = (both[..., :k, :] - both[..., k:, :]).float()
    wv = w_buf[..., None] * vals  # (B, nt, H, K, D)
    residual = wv.new_zeros(bs, nt, num_heads, t, head_dim)
    return residual.scatter_add(3, t_buf[..., None].expand(wv.shape), wv)


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


def tiled_geometry(spatial_shapes, num_points, tile_tokens=None, halos=None, margin=None):
    """(geometry, key, halos_auto) for these levels: the settings'
    ``tiled_tile_tokens``, ``tiled_halos`` ("auto" = num_points + 1 texels on
    every level) and ``tiled_margin`` where an argument is None."""
    d = _MSDA_DEFAULTS
    halos = d["tiled_halos"] if halos is None else halos
    halos_auto = halos == "auto"
    if halos_auto:
        halos = (num_points + 1,) * len(spatial_shapes)
    tile_tokens = d["tiled_tile_tokens"] if tile_tokens is None else tile_tokens
    margin = d["tiled_margin"] if margin is None else margin
    key = (tuple(spatial_shapes), tuple(tile_tokens), tuple(halos), int(margin))
    return _tile_geometry(*key), key, halos_auto


def _check_encoder_layout(value, spatial_shapes, sampling_locations):
    total, num_queries = value.shape[1], sampling_locations.shape[1]
    if num_queries != total or sum(h * w for h, w in spatial_shapes) != total:
        raise ValueError("tiled MSDA takes queries == raster tokens (encoder layout); got "
                         f"Q={num_queries}, S={total}, levels {tuple(spatial_shapes)}")


def _tile_samples(spatial_shapes, sampling_locations, attention_weights, geo, key):
    """The tokens' samples gathered by tile: (consts, per level (sample,
    ph, pw, h, w)), sample = (x0i, y0i, fx, fy, attn, bx, by), each
    (B, nt, H, P, T) but the (1, nt, 1, 1, 1) patch origins."""
    bs, num_queries, num_heads, num_levels, num_points, _ = sampling_locations.shape
    nt, t = geo.ntiles, geo.T
    perm, inv, valid, origins = _device_index(geo, key, sampling_locations.device)
    loc_t = _perm_take(sampling_locations.float().reshape(bs, num_queries, -1), perm, inv)
    loc_t = loc_t.reshape(bs, nt, t, num_heads, num_levels, num_points, 2)
    loc_t = loc_t.permute(0, 1, 3, 4, 5, 6, 2)  # (B, nt, H, L, P, 2, T)
    attn_t = _perm_take(attention_weights.float().reshape(bs, num_queries, -1), perm, inv)
    attn_t = attn_t.reshape(bs, nt, t, num_heads, num_levels, num_points)
    attn_t = attn_t.permute(0, 1, 3, 4, 5, 2)  # (B, nt, H, L, P, T)
    levels = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        _, _, ph, pw = geo.patches[lvl]
        loc = loc_t[:, :, :, lvl]  # (B, nt, H, P, 2, T)
        x = loc[:, :, :, :, 0] * w - 0.5  # two roundings, as the JAX package
        y = loc[:, :, :, :, 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        by, bx = origins[lvl]
        levels.append(((x0.long(), y0.long(), x - x0, y - y0, attn_t[:, :, :, lvl], bx, by),
                       ph, pw, h, w))
    return dict(nt=nt, T=t, perm=perm, inv=inv, valid=valid), levels


def tiled_level_operands(value, spatial_shapes, sampling_locations, attention_weights):
    """What the tiled contraction takes at the settings' geometry: (consts,
    levels). consts holds the geometry's nt, T and untile indices; levels,
    per level, a dict of the fp32 patch (B, nt, M, C) in "yx" order, the
    sample (x0i, y0i, fx, fy, attn, bx, by), each (B, nt, H, P, T) but the
    (1, nt, 1, 1, 1) patch origins, and ph, pw, h, w."""
    _check_encoder_layout(value, spatial_shapes, sampling_locations)
    bs, total, num_heads, head_dim = value.shape
    geo, key, _ = tiled_geometry(spatial_shapes, sampling_locations.shape[4])
    consts, samples = _tile_samples(spatial_shapes, sampling_locations, attention_weights,
                                    geo, key)
    vflat = value.float().reshape(bs, total, num_heads * head_dim)
    levels, start = [], 0
    for lvl, (sample, ph, pw, h, w) in enumerate(samples):
        y0u, x0u = geo.patch_grid[lvl]
        vl = vflat[:, start:start + h * w].reshape(bs, h, w, num_heads * head_dim)
        start += h * w
        patch = SlicePatchesFunction.apply(vl, y0u, x0u, ph, pw)
        levels.append(dict(patch=patch.reshape(bs, consts["nt"], ph * pw, num_heads * head_dim),
                           sample=sample, ph=ph, pw=pw, h=h, w=w))
    return consts, levels


def _gather_patches(vl, patches, device):
    """``tiled_patch_mode="gather"``: the nt (ph, pw) windows at the tiles'
    origins by one indexing of vl (B, h, w, C) -> (B, nt, ph, pw, C); its
    backward is autograd's scatter-add."""
    y0s, x0s, ph, pw = patches
    rows = torch.from_numpy(y0s.astype(np.int64)).to(device)[:, None] + torch.arange(
        ph, device=device)
    cols = torch.from_numpy(x0s.astype(np.int64)).to(device)[:, None] + torch.arange(
        pw, device=device)
    return vl[:, rows[:, :, None], cols[:, None, :]]


def msda_tiled(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    use_pallas: bool,
) -> torch.Tensor:
    """``_msda_tiled``: (B, S, H, D) x (B, S, H, L, P, 2) x (B, S, H, L, P)
    -> (B, S, H * D), any batch size, under the settings of
    ``ops/msda_settings.py`` as the JAX package reads them: the geometry
    (``tiled_tile_tokens``, ``tiled_halos``, ``tiled_margin``), the overflow
    side channel (``tiled_overflow``: "auto" = 0 under auto halos, else 8;
    0 under t_major), ``tiled_batch_unroll``, ``tiled_patch_mode``,
    ``tiled_slab_order`` ("auto": xy at B = 1, bm above; yx under the entry
    route, t_major, the sep kernel or gather patches), ``tiled_layout``,
    ``tiled_dtype`` / ``tiled_dot_bf16`` (the kernels take fp32 of the
    rounded operands) and ``tiled_int8_slab`` (eval only: the separable
    slices branch with overflow 0). ``use_pallas`` selects the entry route
    (``tiled_matmul_core``), else t_major's dense one-hot contraction, else
    the separable build, contracted by ``sep_contract_fused`` under
    ``tiled_sep_kernel``, else by ``_sep_contract``."""
    d = _MSDA_DEFAULTS
    sep_kernel = d["tiled_sep_kernel"]
    bs, total, num_heads, head_dim = value.shape
    if bs > 1 and d["tiled_batch_unroll"]:
        return torch.cat([msda_tiled(value[b:b + 1], spatial_shapes, sampling_locations[b:b + 1],
                                     attention_weights[b:b + 1], use_pallas)
                          for b in range(bs)])
    in_dtype = value.dtype
    c = num_heads * head_dim
    dims = (num_heads, head_dim)
    geo, key, halos_auto = tiled_geometry(spatial_shapes, sampling_locations.shape[4])
    t_major = d["tiled_layout"] == "t_major"
    overflow = overflow_capacity(halos_auto)
    tiled_dtype = resolve_tiled_dtype()
    slices = d["tiled_patch_mode"] == "slices"
    order = d["tiled_slab_order"]
    if order == "auto":
        order = "xy" if bs == 1 else "bm"
    if use_pallas or t_major or sep_kernel or not slices:
        order = "yx"
    int8 = (d["tiled_int8_slab"] and not use_pallas and not t_major and not sep_kernel
            and slices and overflow == 0)
    _check_encoder_layout(value, spatial_shapes, sampling_locations)
    consts, samples = _tile_samples(spatial_shapes, sampling_locations, attention_weights,
                                    geo, key)
    nt, t = consts["nt"], consts["T"]
    vgather = value.to(d["gather_dtype"]).reshape(bs, total, c)
    out, parts, start = None, [], 0
    for lvl, (sample, ph, pw, h, w) in enumerate(samples):
        x0i, y0i, fx, fy, attn, bx, by = sample
        vl_g = vgather[:, start:start + h * w].reshape(bs, h, w, c)
        vl = vl_g.float()
        start += h * w
        y0u, x0u = geo.patch_grid[lvl]
        scale = None
        if not slices:
            patch = _gather_patches(vl, geo.patches[lvl], value.device)
        elif int8:
            # per-channel absmax over (B, h, w); dequantised on the
            # contraction's output (round half to even, clip to +-127)
            scale = torch.clamp(vl.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
            q = torch.clamp(torch.round(vl / scale), -127.0, 127.0).to(torch.int8)
            patch = SlicePatchesFunction.apply(q, y0u, x0u, ph, pw, order)
        else:
            patch = SlicePatchesFunction.apply(vl.to(tiled_dtype), y0u, x0u, ph, pw, order)
        residual = None
        if use_pallas or t_major or overflow > 0:
            m_all, w_all, *extra = _tiled_entries(x0i, y0i, fx, fy, attn, bx, by, ph, pw, h,
                                                  w, overflow=overflow > 0)
            if overflow > 0:
                residual = _overflow_residual(w_all, *extra[0], vl_g, overflow, dims)
        if use_pallas:
            contrib = tiled_matmul_core(m_all, w_all,
                                        patch.float().reshape(bs, nt, ph * pw, c), dims)
        elif t_major:
            # A (B, nt, H, M, T) from the entries, built in tiled_dtype
            a_t = _dense_a_t(m_all, w_all.to(tiled_dtype).float(), ph * pw).to(tiled_dtype)
            contrib = _dot("bnhmt,bnmhd->bnthd", *_boundary_cast(
                a_t, patch.to(tiled_dtype).reshape(bs, nt, ph * pw, num_heads, head_dim)))
            contrib = contrib.reshape(bs, nt, t, c)
        else:
            oy = _axis_soft(y0i, fy, by, ph, h, attn).to(tiled_dtype)
            ox = _axis_soft(x0i, fx, bx, pw, w, None).to(tiled_dtype)
            if sep_kernel:
                contrib = sep_contract_fused(
                    oy.contiguous(), ox.contiguous(),
                    patch.to(tiled_dtype).reshape(bs, nt, ph * pw, c))
            else:
                patch6 = patch.to(tiled_dtype).reshape(patch.shape[:-1] + dims)
                part = _sep_contract(oy, ox, patch6, order)  # (B, nt, H, D, T)
                if scale is not None:
                    part = part * scale.reshape(num_heads, head_dim, 1)
                parts.append(part)
                if residual is not None:
                    parts.append(residual.transpose(3, 4))
                continue
        if residual is not None:
            contrib = contrib + residual.permute(0, 1, 3, 2, 4).reshape(bs, nt, t, c)
        out = contrib if out is None else out + contrib
    if parts:  # summed in the (B, nt, H, D, T) layout, transposed once
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        acc = acc.permute(0, 1, 4, 2, 3).reshape(bs, nt, t, c)
        out = acc if out is None else out + acc
    out = out.reshape(bs, nt * t, c)
    return _perm_untile(out, consts["inv"], consts["perm"], consts["valid"]).to(in_dtype)


def off_patch_entries(spatial_shapes, sampling_locations, attention_weights=None,
                      tile_tokens=None, halos=None, margin=None):
    """The entries the tiled forms read off their tile's patch, at the
    settings' geometry where an argument is None: (valid, per level (bad,
    rank, attn)). ``bad`` (B, nt, H, 4 P, T) flags the corners on the level
    but off the patch (``_tiled_entries``), ``rank`` their overflow ranks
    (``_overflow_ranks``; padding slots rank as they do in the op), ``attn``
    (B, nt, H, P, T) the tokens' attention weights (1 without
    ``attention_weights``) and ``valid`` (1, nt, 1, 1, T) the slots that
    hold a token."""
    locs = sampling_locations.float()
    geo, key, _ = tiled_geometry(spatial_shapes, locs.shape[-2], tile_tokens, halos, margin)
    if attention_weights is None:
        attention_weights = torch.ones(locs.shape[:-1], device=locs.device)
    consts, samples = _tile_samples(spatial_shapes, locs, attention_weights, geo, key)
    levels = []
    for sample, ph, pw, h, w in samples:
        _, _, (bad, _, _) = _tiled_entries(*sample, ph, pw, h, w, overflow=True)
        levels.append((bad, _overflow_ranks(bad), sample[4]))
    return consts["valid"].reshape(1, consts["nt"], 1, 1, consts["T"]), levels


def tiled_clamp_fraction(spatial_shapes, sampling_locations, attention_weights=None,
                         tile_tokens=None, halos=None, margin=None) -> torch.Tensor:
    """The share of sample points the tiled forms would read in part off
    their tile's patch (a corner border-clamped, or sent to the overflow
    channel), weighted by attention weight when ``attention_weights`` is
    given: the JAX package's ``tiled_clamp_fraction``. Corners off the
    level count as exact. The geometry is the settings' where an argument
    is None. Returns an fp32 scalar tensor in [0, 1] (0: the tiled output
    is exact)."""
    valid, levels = off_patch_entries(spatial_shapes, sampling_locations, attention_weights,
                                      tile_tokens, halos, margin)
    clamped = total = 0.0
    for bad, _, attn in levels:
        point_bad = bad.unflatten(-2, (4, -1)).any(dim=-3)  # any of the 4 corners
        clamped = clamped + torch.sum(point_bad * attn * valid)
        total = total + torch.sum(attn * valid)
    return clamped / torch.clamp(total, min=1e-9)
