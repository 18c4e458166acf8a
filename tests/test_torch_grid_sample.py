"""The port's bilinear point sampler (``ops/grid_sample.py``) against the JAX
package's ``bilinear_sample`` on the same numpy inputs, through the
autograd Function the DCN calls: the output and the gradients of the map and
the points, NaN points included; and its ``torch.library`` op, counted by
``FlopCounterMode`` and kept by ``torch.export`` in a tiny DCN.

On CPU tensors the Function's forward is the op's plain version and its
backward the written-out plain backward (not autograd's); the card's
kernels are held against those plain versions by
``tests/test_torch_no_jax.py`` and ``chip_smoke.py`` phase 12 (c).
Tolerances: 1e-6 on the output and the map gradient, 1e-5 on the point
gradient (a sum over channels, in another order than JAX's), NaN where
JAX has NaN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relation_detr_tpu.ops import grid_sample as jgrid
from relation_detr_tpu_torch.models.deform_conv import DeformConv2dPack
from relation_detr_tpu_torch.ops import grid_sample
from relation_detr_tpu_torch.utils import flops


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(rng, n, h, w, nan):
    """``tests/test_torch_bricks.py``'s sampler cases: points on integers,
    fractional, half off and just off each side, far off; ``nan`` makes
    one point's x, one's y, and one's both NaN."""
    pts = np.concatenate([rng.uniform(-1.5, w + 0.5, (2, n, 1)),
                          rng.uniform(-1.5, h + 0.5, (2, n, 1))], -1)
    pts[:, :8] = np.floor(pts[:, :8])  # on integers
    pts[:, 8:12] = [[-0.5, 2.3], [w - 0.5, 1.2], [3.3, -0.7], [2.1, h - 0.6]]  # half out
    pts[:, 12:16] = [[-1.0, 2.0], [w, 1.0], [3.0, -1.0], [2.0, h]]  # just past each side
    pts[:, 16:18] = [[-3.0, -3.0], [w + 2.0, h + 3.0]]  # far off
    if nan:
        pts[0, 20, 0] = pts[1, 21, 1] = np.nan
        pts[1, 22] = np.nan
    return pts.astype(np.float32)


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("hwc", [(5, 7, 3), (6, 9, 8)])
def test_bilinear_sample_function_matches_jax(hwc, nan):
    """``BilinearSampleFunction`` (forward and written-out backward) on CPU
    tensors against ``jax.value_and_grad`` of JAX's ``bilinear_sample``;
    the wrapper without gradients gives the same output; nothing launched."""
    h, w, c = hwc
    rng = np.random.RandomState(h * w + c + nan)
    feat = rng.randn(2, h, w, c).astype(np.float32)
    pts = _points(rng, 40, h, w, nan)
    cot = rng.randn(2, 40, c).astype(np.float32)

    def loss(f, p):
        out = jgrid.bilinear_sample(f, p)
        return jnp.sum(out * cot), out

    (_, want), (gf, gp) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(feat, pts)
    launches = (grid_sample.bilinear_sample.launches,
                grid_sample.bilinear_sample_backward.launches)
    tf = torch.from_numpy(feat).requires_grad_(True)
    tp = torch.from_numpy(pts).requires_grad_(True)
    got = grid_sample.BilinearSampleFunction.apply(tf, tp)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tf.grad.numpy(), gf, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), gp, rtol=1e-5, atol=1e-5)
    assert not got[:, 16:18].any()
    assert bool(np.isnan(want).any()) == nan
    with torch.no_grad():
        plain = grid_sample.bilinear_sample(torch.from_numpy(feat), torch.from_numpy(pts))
    np.testing.assert_array_equal(plain.numpy(), got.detach().numpy())
    assert (grid_sample.bilinear_sample.launches,
            grid_sample.bilinear_sample_backward.launches) == launches


def test_bilinear_sample_backward_is_autograd_of_the_plain_forward():
    """The written-out backward equals autograd through the plain forward on
    a DCN's points (on integers, as zero offsets put them, and shifted):
    the gradients take the same side of the floor's kink."""
    rng = np.random.RandomState(5)
    feat = torch.from_numpy(rng.randn(1, 6, 8, 4).astype(np.float32))
    base = torch.stack(torch.meshgrid(torch.arange(-1, 9.0), torch.arange(-1, 7.0),
                                      indexing="xy"), -1).reshape(1, -1, 2)
    for pts in (base, base + torch.from_numpy(rng.randn(*base.shape).astype(np.float32))):
        grad_out = torch.from_numpy(rng.randn(1, pts.shape[1], 4).astype(np.float32))
        f, p = feat.clone().requires_grad_(True), pts.clone().requires_grad_(True)
        torch.autograd.backward(grid_sample.bilinear_sample_reference(f, p), grad_out)
        got = grid_sample.bilinear_sample_backward_reference(feat, pts, grad_out)
        torch.testing.assert_close(got[0], f.grad, rtol=0, atol=1e-6)
        torch.testing.assert_close(got[1], p.grad, rtol=0, atol=1e-5)


def test_dcn_op_is_counted_and_exported():
    """A tiny ``DeformConv2dPack`` without gradients calls the op
    ``relation_detr::bilinear_sample_fwd`` once: ``FlopCounterMode`` counts
    it by ``utils/flops.py``'s formula (8 B N C, N = 9 taps a position), and
    ``torch.export`` keeps it in the graph; the exported module gives the
    eager output."""
    rng = np.random.RandomState(2)
    conv = DeformConv2dPack(8, 6, 3, stride=2)
    conv.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.conv_offset.weight.copy_(torch.from_numpy(
            rng.randn(*conv.conv_offset.weight.shape).astype(np.float32) * 0.3))
    conv.requires_grad_(False)
    x = torch.from_numpy(rng.randn(2, 8, 9, 11).astype(np.float32))
    want, total, ops = flops.count_flops(conv, x)
    assert ops == {"bilinear_sample_fwd": 8 * 2 * (5 * 6 * 9) * 8}
    assert total > ops["bilinear_sample_fwd"]  # beside the convolutions and the einsum
    with torch.no_grad():
        program = torch.export.export(conv, (x,))
        got = program.module()(x)
    targets = [str(node.target) for node in program.graph.nodes]
    assert targets.count("relation_detr.bilinear_sample_fwd.default") == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
