"""Class names inside weight files. The port's own copy of
``relation_detr_tpu/utils/class_names.py`` (numpy only), after the
reference's util/misc.py:198-232: the names ride in the ``.npz`` weight file
as an integer array of code points, '|'-separated, under ``_classes_``, so
evaluation and inference can label outputs without the dataset."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)


def encode_labels(names: Sequence[str]) -> np.ndarray:
    joined = "|".join(names)
    return np.asarray([ord(c) for c in joined], np.int32)


def decode_labels(encoded: np.ndarray) -> Tuple[str, ...]:
    return tuple("".join(chr(int(c)) for c in encoded).split("|"))


def load_class_names(checkpoint_path: str):
    """The ``_classes_`` entry of an ``.npz`` weight file, or None."""
    path = checkpoint_path if checkpoint_path.endswith(".npz") else checkpoint_path + ".npz"
    with np.load(path) as archive:
        if "_classes_" in archive:
            return decode_labels(archive["_classes_"])
    return None
