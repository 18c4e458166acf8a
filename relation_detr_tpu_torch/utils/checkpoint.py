"""Training-state checkpoints. Counterpart of
``relation_detr_tpu/utils/checkpoint.py``'s ``CheckpointManager`` (``:23-61``,
which uses orbax; the card's machine has none).

``CheckpointManager`` keeps epoch-numbered state files (``<epoch>.pt`` in
its directory), the newest ``max_to_keep``, and tracks the best AP and AP50
(the reference's HighestCheckpoint, util/utils.py:250-269; the caller saves
the ``best_ap`` / ``best_ap50`` weight files). A state file is a dict of
tensors and plain values, written with ``torch.save`` (to a temporary file,
then renamed) and read back with ``weights_only=True``: the train CLI puts
in it the model's ``state_dict``, AdamW's, the train step's ``TrainState``
and accumulator, the EMA, the loader's epoch and the best metrics.

Bare weight files (the JAX ``.npz`` layout) are ``utils/weights.py``'s
``save_weights`` and ``load_weights``.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_STATE_FILE = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """Epoch-numbered training-state files with a keep limit and the best
    metrics seen."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best = {"ap": -1.0, "ap50": -1.0}

    def epochs(self) -> List[int]:
        """The epochs with a state file, ascending."""
        found = (_STATE_FILE.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pt")

    def save(self, epoch: int, state: Dict[str, Any]) -> None:
        """Writes ``state`` (with the best metrics) as epoch ``epoch``'s file,
        then deletes the oldest beyond ``max_to_keep``."""
        tmp = self.path(epoch) + ".tmp"
        torch.save({**state, "best": dict(self.best)}, tmp)
        os.replace(tmp, self.path(epoch))
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def update_best(self, ap: float, ap50: float) -> Dict[str, bool]:
        """Tracks the best metrics; returns which improved."""
        improved = {"ap": ap > self.best["ap"], "ap50": ap50 > self.best["ap50"]}
        self.best["ap"] = max(self.best["ap"], ap)
        self.best["ap50"] = max(self.best["ap50"], ap50)
        return improved

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: Optional[int] = None, map_location=None) -> Dict[str, Any]:
        """The state saved at ``epoch`` (the latest when None), tensors on
        ``map_location``; its best metrics become this manager's."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        state = torch.load(self.path(epoch), map_location=map_location, weights_only=True)
        self.best = dict(state.pop("best"))
        return state
