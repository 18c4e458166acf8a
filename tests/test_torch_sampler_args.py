"""The DCN sampler's CUDA launch checks its arguments on the host, once,
before any launch (``ops/grid_sample.py::_check_cuda_args``): contiguous
fp32 feat (B, H, W, C), points (B, N, 2) and grad_out (B, N, C) on one
device, else ``ValueError`` naming the shapes. The check is plain Python,
so it runs here on CPU tensors; the kernels behind it are held against the
plain versions on the card by ``tests/test_torch_no_jax.py``.
"""
import pytest
import torch

from relation_detr_tpu_torch.ops import grid_sample


def _inputs():
    gen = torch.Generator().manual_seed(0)
    return (torch.randn(2, 5, 6, 8, generator=gen), torch.rand(2, 7, 2, generator=gen) * 6,
            torch.randn(2, 7, 8, generator=gen))


def _strided(t):
    """t's values and shape in a tensor that is not contiguous."""
    return t.transpose(0, 1).contiguous().transpose(0, 1)


BAD = {
    "map fp64": lambda f, p, g: (f.double(), p, g),
    "points fp64": lambda f, p, g: (f, p.double(), g),
    "grad_out fp64": lambda f, p, g: (f, p, g.double()),
    "map strided": lambda f, p, g: (_strided(f), p, g),
    "points strided": lambda f, p, g: (f, _strided(p), g),
    "grad_out strided": lambda f, p, g: (f, p, _strided(g)),
    "map 3-D": lambda f, p, g: (f[0], p, g),
    "points without y": lambda f, p, g: (f, p[..., :1].contiguous(), g),
    "points of another batch": lambda f, p, g: (f, p[:1].contiguous(), g),
    "grad_out of another width": lambda f, p, g: (f, p, g[..., :4].contiguous()),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_launch_check_rejects(case):
    with pytest.raises(ValueError, match="contiguous fp32 tensors"):
        grid_sample._check_cuda_args(*BAD[case](*_inputs()))


@pytest.mark.parametrize("with_grad", [False, True])
def test_launch_check_takes_the_kernels_inputs(with_grad):
    feat, points, grad_out = _inputs()
    grid_sample._check_cuda_args(feat, points, grad_out if with_grad else None)

