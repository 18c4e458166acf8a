"""The port (eval forward and train step) runs without jax, flax or cv2,
and its kernel wrappers launch nothing on CPU tensors and raise (never fall
back) on CUDA tensors they cannot serve. This file imports no jax so that
it also runs on a machine with a card and no jax (the conftest imports jax,
so skip it there):
``python -m pytest --noconftest tests/test_torch_no_jax.py``."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import numpy as np
import torch
import relation_detr_tpu_torch
import relation_detr_tpu_torch.inference as inference
from relation_detr_tpu.utils.config import Config
from relation_detr_tpu_torch.configs import train_config
from relation_detr_tpu_torch.ops.msda import msda_backward
from relation_detr_tpu_torch.ops.msda import multi_scale_deformable_attention as msda
from relation_detr_tpu_torch.ops.patch_scatter import window_accumulate
from relation_detr_tpu_torch.ops.relation_bias import relation_bias_v4
from relation_detr_tpu_torch.parallel.train_step import make_train_step
from relation_detr_tpu_torch.utils.param_groups import build_optimizer

cfgs = [Config("relation_detr_tpu_torch/configs/relation_detr/" + name) for name in
        ("relation_detr_resnet50_800_1333.py", "relation_detr_resnet50_tiny_test.py")]
model = cfgs[1].build_model()
rng = np.random.RandomState(0)
images = rng.randn(1, 128, 160, 3).astype(np.float32)
mask = np.zeros((1, 128, 160), bool)
mask[:, 96:] = True
det = inference.detect(model, images, mask, [[96, 160]], 30)
assert det["boxes"].shape == (1, 30, 4) and bool(torch.isfinite(det["boxes"]).all())

model.train()
step = make_train_step(model, cfgs[1].build_criterion(),
                       build_optimizer(model, train_config.learning_rate), cfgs[1].hybrid_assign)
labels = torch.tensor([[1, 2, 0]])
boxes = torch.tensor([[[0.3, 0.4, 0.2, 0.3], [0.6, 0.5, 0.3, 0.2], [0.0, 0.0, 0.0, 0.0]]])
metrics = step({"images": torch.from_numpy(images), "mask": torch.from_numpy(mask),
                "gt_labels": labels, "gt_boxes": boxes,
                "gt_valid": torch.tensor([[True, True, False]])})
assert np.isfinite(metrics["total_loss"]) and metrics["nonfinite_count"] == 0, metrics
launches = (msda.launches, msda_backward.launches, relation_bias_v4.launches,
            window_accumulate.launches)
assert launches == (0, 0, 0, 0), f"CPU run launched a kernel: {launches}"
loaded = [m for m in ("jax", "flax", "cv2") if m in sys.modules]
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_runs_without_jax_flax_cv2():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,heads", [(2, 4), (1, 8), (3, 16)])
def test_kernels_match_plain_versions_on_card(batch, heads):
    """Both kernels against their plain versions on the card at small
    shapes, B > 1 and every head count the relation kernel instantiates
    (the flagship shapes are chip_smoke.py's phase 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.ops import msda, relation_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(heads)
    shapes = ((9, 11), (5, 6), (3, 3))
    total = sum(h * w for h, w in shapes)
    value = torch.randn(batch, total, heads, 16, generator=gen, device=dev)
    locs = torch.rand(batch, 37, heads, 3, 4, 2, generator=gen, device=dev) * 1.4 - 0.2
    attn = torch.rand(batch, 37, heads, 3, 4, generator=gen, device=dev)
    with torch.no_grad():
        got = msda.multi_scale_deformable_attention(value, shapes, locs, attn)
        want = msda.msda_reference(value, shapes, locs, attn)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

    boxes = torch.rand(batch, 45, 4, generator=gen, device=dev) * 0.9 + 0.01
    kernel = torch.randn(64, heads, generator=gen, device=dev) * 0.1
    bias = torch.randn(heads, generator=gen, device=dev) * 0.1
    tgt = boxes[:, 5:].contiguous()
    with torch.no_grad():
        got = relation_bias.relation_bias_v4(boxes, tgt, kernel, bias)
        want = relation_bias.relation_bias_v4_reference(boxes, tgt, kernel, bias)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,heads,head_dim", [(2, 4, 32), (1, 8, 16), (3, 2, 8)])
def test_backward_kernels_match_plain_versions_on_card(batch, heads, head_dim):
    """msda_bwd against autograd through the plain MSDA (locations past
    every border, on them, and on pixel centres, where the location
    gradient has a kink), the relation Function's gradients against
    the plain version's, and window_accumulate against its slice-add loop
    (bit for bit: both add the windows in ascending order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.ops import msda, patch_scatter, relation_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(heads)
    shapes = ((9, 11), (5, 6), (3, 3))
    total = sum(h * w for h, w in shapes)
    value = torch.randn(batch, total, heads, head_dim, generator=gen, device=dev)
    locs = torch.rand(batch, 37, heads, 3, 4, 2, generator=gen, device=dev) * 1.4 - 0.2
    locs[:, ::5, :, :, 1] = 0.0
    locs[:, ::7, :, :, 2] = 1.0
    for lvl, (h, w) in enumerate(shapes):  # on pixel centres, as the encoder's
        for axis, size in ((0, w), (1, h)):  # samples sit at initialisation
            cells = torch.randint(0, size, (batch, 13, heads), generator=gen, device=dev)
            offs = torch.randint(-2, 3, (batch, 13, heads), generator=gen, device=dev)
            locs[:, ::3, :, lvl, 3, axis] = (cells + 0.5) / size + offs.float() / size
    attn = torch.rand(batch, 37, heads, 3, 4, generator=gen, device=dev)
    grad_out = torch.randn(batch, 37, heads * head_dim, generator=gen, device=dev)
    got = msda.msda_backward(value, shapes, locs, attn, grad_out)
    want = msda.msda_backward_reference(value, shapes, locs, attn, grad_out)
    for name, g, w in zip(("value", "locations", "weights"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)

    boxes = torch.rand(batch, 45, 4, generator=gen, device=dev) * 0.9 + 0.01
    kernel = (torch.randn(64, 8, generator=gen, device=dev) * 0.1).requires_grad_(True)
    bias = (torch.randn(8, generator=gen, device=dev) * 0.1).requires_grad_(True)
    tgt = boxes[:, 5:].contiguous()
    cot = torch.randn(batch, 8, 45, 40, generator=gen, device=dev)
    relation_bias.relation_bias_v4(boxes, tgt, kernel, bias).backward(cot)
    dk, db = torch.autograd.grad(
        relation_bias.relation_bias_v4_reference(boxes, tgt, kernel, bias), (kernel, bias), cot)
    torch.testing.assert_close(kernel.grad, dk, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(bias.grad, db, rtol=1e-4, atol=1e-4)

    y0s, x0s = [0, 3, 9, 3], [0, 5, 1, 5]
    g = torch.randn(4, 7, 6, 33, generator=gen, device=dev)
    got = patch_scatter.window_accumulate(g, y0s, x0s, 16, 11)
    want = patch_scatter.window_accumulate_reference(g, y0s, x0s, 16, 11)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_wrappers_raise_on_cuda_without_library(monkeypatch, tmp_path):
    """On a CUDA tensor a wrapper builds and launches its kernel or raises:
    with no nvcc and no built library it raises, it does not fall back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch import _build
    from relation_detr_tpu_torch.ops.msda import multi_scale_deformable_attention
    from relation_detr_tpu_torch.ops.patch_scatter import window_accumulate
    from relation_detr_tpu_torch.ops.relation_bias import relation_bias_v4

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    _build.load_library.cache_clear()
    launched = (multi_scale_deformable_attention.launches, relation_bias_v4.launches,
                window_accumulate.launches)
    try:
        dev = torch.device("cuda")
        value = torch.zeros(1, 6, 2, 4, device=dev)
        locs = torch.full((1, 3, 2, 1, 2, 2), 0.5, device=dev)
        attn = torch.full((1, 3, 2, 1, 2), 0.5, device=dev)
        with pytest.raises(RuntimeError, match="nvcc"):
            multi_scale_deformable_attention(value, ((2, 3),), locs, attn)
        boxes = torch.full((1, 5, 4), 0.5, device=dev)
        with pytest.raises(RuntimeError, match="nvcc"):
            relation_bias_v4(boxes, boxes, torch.zeros(64, 8, device=dev),
                             torch.zeros(8, device=dev))
        with pytest.raises(RuntimeError, match="nvcc"):
            window_accumulate(torch.zeros(1, 2, 2, 3, device=dev), [0], [0], 4, 4)
        assert (multi_scale_deformable_attention.launches, relation_bias_v4.launches,
                window_accumulate.launches) == launched
    finally:
        _build.load_library.cache_clear()
