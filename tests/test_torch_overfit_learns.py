"""The port learns: ``tests/test_overfit_learns.py`` on the port, on the CPU.

The case and its thresholds live in ``relation_detr_tpu_torch/utils/overfit.py``
(the same 4 numpy-drawn images, tiny RelationDETR, 50 steps at lr 2e-4, the
last 5 losses' mean at most 0.55x the first 5's, AP50 at least 0.5), which
``chip_smoke.py`` also runs on the card.
"""
import numpy as np
import pytest

from relation_detr_tpu_torch.utils import overfit


@pytest.mark.slow
def test_port_overfits_four_images(tmp_path):
    result = overfit.run("cpu", tmp_path / "overfit_ann.json")
    losses, first, last = result["losses"], result["first_loss"], result["last_loss"]
    assert np.isfinite(losses).all(), losses[-5:]
    assert last <= overfit.LOSS_RATIO * first, (first, last)
    assert result["stats"]["AP50"] >= overfit.MIN_AP50, result["stats"]
    assert result["ok"]
