"""Bilinear point sampling of NHWC feature maps: CUDA kernels and their plain
versions. Counterpart of ``relation_detr_tpu/ops/grid_sample.py::bilinear_sample``,
the sampler of the DCN (``models/deform_conv.py``).

``bilinear_sample`` is the wrapper. A call that needs no gradient goes to
the op ``relation_detr::bilinear_sample_fwd`` (``ops/library.py``): on CUDA
tensors it launches ``csrc/grid_sample.cu::bilinear_sample_fwd`` (whose
header says what bounds it on the card), on CPU tensors it computes
``bilinear_sample_reference``. A call that needs a gradient goes through
``BilinearSampleFunction``, whose forward calls the same op and whose
backward is ``bilinear_sample_backward``: on CUDA tensors one call of the C
entry ``csrc/grid_sample.cu::bilinear_sample_bwd`` (it zeroes the map
gradient and launches the kernel that computes both gradients), on CPU
tensors ``bilinear_sample_backward_reference``, the backward written out.
The card's kernels take fp32 only; another dtype there raises, and nothing
on a CUDA tensor moves to the plain version or the CPU. A launch checks its
arguments once, takes the raw handle of the current stream, and enters a
device context only where the tensors' card is not the current one.
"""
from __future__ import annotations

import torch

from relation_detr_tpu_torch import _build
from relation_detr_tpu_torch.ops import library

# (dy, dx) of the four corners, in the JAX function's order
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))
_INT32 = 2 ** 31


def _floor_int32(t: torch.Tensor) -> torch.Tensor:
    """floor(t) converted to int32 as XLA converts it (and the kernels):
    NaN to 0, out-of-range values saturated."""
    f = torch.floor(t).nan_to_num(0.0).clamp(-_INT32, _INT32).long()
    return f.clamp(-_INT32, _INT32 - 1).int()


def _corners(points: torch.Tensor, h: int, w: int):
    """Per corner, in ``_CORNERS`` order, of points (B, N, 2): the clamped
    flat index (B, 4, N), the weight where the corner is valid and 0 where
    it is not, the validity (B, 4, N, bool), and fx, fy (B, N). Corner
    coordinates are int32 sums that wrap, as XLA's. A masked corner's weight
    is 0 even where the bilinear weight is NaN: the JAX function's ``wgt *
    valid`` compiles (jitted) to a select, so a NaN point whose corners all
    lie off the map samples 0."""
    x, y = points[..., 0], points[..., 1]
    x0, y0 = _floor_int32(x), _floor_int32(y)
    fx, fy = x - x0.to(x.dtype), y - y0.to(y.dtype)
    index, weights, valid = [], [], []
    for dy, dx in _CORNERS:
        xc, yc = x0 + dx, y0 + dy
        ok = (xc >= 0) & (xc < w) & (yc >= 0) & (yc < h)
        wx = fx if dx else 1 - fx
        wy = fy if dy else 1 - fy
        weights.append(torch.where(ok, wx * wy, 0.0))
        valid.append(ok)
        index.append(yc.clamp(0, h - 1).long() * w + xc.clamp(0, w - 1))
    return torch.stack(index, 1), torch.stack(weights, 1), torch.stack(valid, 1), fx, fy


def _gather(feat: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The (B, 4, N, C) corner rows of feat (B, H, W, C) at index (B, 4, N)."""
    b, h, w, c = feat.shape
    got = torch.gather(feat.reshape(b, h * w, c), 1, index.reshape(b, -1, 1).expand(-1, -1, c))
    return got.view(*index.shape, c)


def bilinear_sample_reference(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: feat (B, H, W, C) sampled at pixel
    points (B, N, 2) given as (x, y) -> (B, N, C).

    Pixel units with no half-pixel shift (the corner below a point is
    ``floor``); each corner is read at its index clamped into the map and
    weighted by its bilinear weight where it is valid, 0 where it is not,
    so a corner outside the map contributes zero on its own and a NaN point
    with a corner on the map gives NaN."""
    index, weights, _, _, _ = _corners(points, feat.shape[1], feat.shape[2])
    return (_gather(feat, index) * weights[..., None]).sum(1)


def bilinear_sample_backward_reference(feat, points, grad_out):
    """Plain version of the backward, written out: grad_out (B, N, C) ->
    (grad_feat (B, H, W, C), grad_points (B, N, 2)). The map gradient adds
    grad_out times each corner's weight at the corner's clamped index; the
    point gradient reaches the points through the weights only: per valid
    corner sum_c grad_out * value (0 for a corner off the map), times the
    derivative of its weight in x and in y."""
    b, h, w, c = feat.shape
    index, weights, valid, fx, fy = _corners(points, h, w)
    grad_feat = torch.zeros(b, h * w, c, dtype=feat.dtype, device=feat.device)
    grad_feat.scatter_add_(1, index.reshape(b, -1, 1).expand(-1, -1, c),
                           (grad_out[:, None] * weights[..., None]).reshape(b, -1, c))
    a = torch.where(valid, (_gather(feat, index) * grad_out[:, None]).sum(-1), 0.0)
    ux, uy = 1 - fx, 1 - fy
    grad_x = -uy * a[:, 0] + uy * a[:, 1] - fy * a[:, 2] + fy * a[:, 3]
    grad_y = -ux * a[:, 0] - fx * a[:, 1] + ux * a[:, 2] + fx * a[:, 3]
    return grad_feat.view(b, h, w, c), torch.stack([grad_x, grad_y], -1)


def _check_cuda_args(feat: torch.Tensor, points: torch.Tensor, grad_out=None) -> None:
    """Raise unless feat (B, H, W, C), points (B, N, 2) and grad_out (B, N,
    C) are contiguous fp32 tensors on feat's card."""
    dev, f32 = feat.device, torch.float32
    if not (feat.dim() == 4 and points.dim() == 3 and feat.dtype == f32 and points.dtype == f32
            and points.device == dev and feat.is_contiguous() and points.is_contiguous()
            and points.shape[0] == feat.shape[0] and points.shape[2] == 2
            and (grad_out is None
                 or (grad_out.dtype == f32 and grad_out.device == dev and grad_out.is_contiguous()
                     and grad_out.shape == (feat.shape[0], points.shape[1], feat.shape[3])))):
        shapes = [tuple(t.shape) for t in (feat, points, grad_out) if t is not None]
        raise ValueError("bilinear_sample's kernels take contiguous fp32 tensors on one card: "
                         f"feat (B, H, W, C), points (B, N, 2), grad_out (B, N, C); got {shapes}")


def _launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream (its raw handle,
    as ``torch.cuda.current_stream(index).cuda_stream`` gives it without
    building a ``Stream``), under a device context only where ``device`` is
    not the current card."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _bilinear_sample_fwd(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: one ``bilinear_sample_fwd`` launch on
    the current stream."""
    _check_cuda_args(feat, points)
    b, h, w, c = feat.shape
    n = points.shape[1]
    lib = _build.load_library()
    out = torch.empty(b, n, c, dtype=feat.dtype, device=feat.device)
    code = _launch(lib.bilinear_sample_fwd, feat.device, feat.data_ptr(), points.data_ptr(),
                   out.data_ptr(), b, h, w, c, n)
    _build.check(lib, code, "bilinear_sample_fwd")
    bilinear_sample.launches += 1
    return out


library.impl("bilinear_sample_fwd", cpu=bilinear_sample_reference, cuda=_bilinear_sample_fwd)
_FWD = library.OPS.bilinear_sample_fwd.default


def bilinear_sample_backward(feat, points, grad_out):
    """grad_out (B, N, C) -> (grad_feat (B, H, W, C), grad_points (B, N, 2)):
    on CUDA tensors one ``csrc/grid_sample.cu::bilinear_sample_bwd`` call
    (which zeroes the map gradient itself), on CPU tensors
    ``bilinear_sample_backward_reference``."""
    if feat.device.type == "cpu":
        return bilinear_sample_backward_reference(feat, points, grad_out)
    grad_out = grad_out.contiguous()
    _check_cuda_args(feat, points, grad_out)
    b, h, w, c = feat.shape
    n = points.shape[1]
    lib = _build.load_library()
    grad_feat = torch.empty_like(feat)
    grad_points = torch.empty_like(points)
    code = _launch(lib.bilinear_sample_bwd, feat.device, feat.data_ptr(), points.data_ptr(),
                   grad_out.data_ptr(), grad_feat.data_ptr(), grad_points.data_ptr(), b, h, w,
                   c, n)
    _build.check(lib, code, "bilinear_sample_bwd")
    bilinear_sample_backward.launches += 1
    return grad_feat, grad_points


bilinear_sample_backward.launches = 0


class BilinearSampleFunction(torch.autograd.Function):
    """``bilinear_sample`` with its gradient: forward the op
    ``relation_detr::bilinear_sample_fwd``, backward
    ``bilinear_sample_backward`` (the kernel on CUDA tensors, the written-out
    plain backward on CPU tensors)."""

    @staticmethod
    def forward(ctx, feat, points):
        ctx.save_for_backward(feat, points)
        return _FWD(feat, points)

    @staticmethod
    def backward(ctx, grad_out):
        feat, points = ctx.saved_tensors
        grad_feat, grad_points = bilinear_sample_backward(feat, points, grad_out)
        return (grad_feat if ctx.needs_input_grad[0] else None,
                grad_points if ctx.needs_input_grad[1] else None)


def bilinear_sample(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample feat (B, H, W, C) at pixel points (B, N, 2) given as (x, y) ->
    (B, N, C), as ``bilinear_sample_reference`` defines it.

    Without a gradient the op ``relation_detr::bilinear_sample_fwd``
    (``bilinear_sample_reference`` on CPU tensors, the kernel on CUDA
    tensors, or raises); with one, ``BilinearSampleFunction``.
    ``bilinear_sample.launches`` counts the forward kernel's launches,
    ``bilinear_sample_backward.launches`` the backward's."""
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bilinear_sample: no kernel for device {feat.device}")
    feat, points = feat.contiguous(), points.contiguous()
    if not library.needs_grad(feat, points):
        return _FWD(feat, points)
    return BilinearSampleFunction.apply(feat, points)


bilinear_sample.launches = 0

