"""The port runs without jax, flax or cv2, and its kernel wrappers launch
nothing on CPU tensors and raise (never fall back) on CUDA tensors they
cannot serve. This file imports no jax so that it also runs on a machine
with a card and no jax (the conftest imports jax, so skip it there):
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
from relation_detr_tpu_torch.ops.msda import multi_scale_deformable_attention as msda
from relation_detr_tpu_torch.ops.relation_bias import relation_bias_v4

cfgs = [Config("relation_detr_tpu_torch/configs/relation_detr/" + name) for name in
        ("relation_detr_resnet50_800_1333.py", "relation_detr_resnet50_tiny_test.py")]
model = cfgs[1].build_model()
rng = np.random.RandomState(0)
images = rng.randn(1, 128, 160, 3).astype(np.float32)
mask = np.zeros((1, 128, 160), bool)
mask[:, 96:] = True
det = inference.detect(model, images, mask, [[96, 160]], 30)
assert det["boxes"].shape == (1, 30, 4) and bool(torch.isfinite(det["boxes"]).all())
assert msda.launches == 0 and relation_bias_v4.launches == 0, "CPU run launched a kernel"
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
def test_wrappers_raise_on_cuda_without_library(monkeypatch, tmp_path):
    """On a CUDA tensor a wrapper builds and launches its kernel or raises:
    with no nvcc and no built library it raises, it does not fall back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch import _build
    from relation_detr_tpu_torch.ops.msda import multi_scale_deformable_attention
    from relation_detr_tpu_torch.ops.relation_bias import relation_bias_v4

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    _build.load_library.cache_clear()
    launched = (multi_scale_deformable_attention.launches, relation_bias_v4.launches)
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
        assert (multi_scale_deformable_attention.launches,
                relation_bias_v4.launches) == launched
    finally:
        _build.load_library.cache_clear()
