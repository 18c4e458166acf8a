"""The port's own copies of the JAX package's host helpers (``Config``, the
eval ``EvalPreset``) against the originals."""
import os

import numpy as np
import pytest

from relation_detr_tpu.data.transforms import EvalPreset as JEvalPreset
from relation_detr_tpu_torch.data.transforms import EvalPreset
from relation_detr_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("hw", [(480, 640), (333, 500), (1200, 900)])
def test_eval_preset_matches_jax_package(hw):
    """Resize (antialiased, down and up) and normalise: exact in float32;
    boxes scale alike."""
    rng = np.random.RandomState(sum(hw))
    sample = {"image": rng.randint(0, 256, (*hw, 3)).astype(np.uint8),
              "boxes": (rng.rand(3, 4) * 300).astype(np.float32),
              "labels": np.arange(3), "image_id": 7, "orig_size": np.asarray(hw)}
    got = EvalPreset(800, 1333)(dict(sample))
    want = JEvalPreset(800, 1333)(dict(sample))
    assert got["image"].dtype == want["image"].dtype == np.float32
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    assert got["image_id"] == 7


@pytest.mark.parametrize("name", ["relation_detr_resnet50_800_1333.py",
                                  "relation_detr_resnet50_tiny_test.py"])
def test_config_loads_port_configs(name):
    cfg = Config(os.path.join(REPO, "relation_detr_tpu_torch", "configs", "relation_detr", name))
    assert callable(cfg.build_model) and callable(cfg.build_criterion)
    assert cfg.get("hybrid_assign") == 6 and cfg.get("missing", 3) == 3
    model = cfg.build_model(device="cpu", seed=0) if "tiny" in name else None
    if model is not None:
        assert next(model.parameters()).device.type == "cpu" and not model.training
