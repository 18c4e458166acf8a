"""Box drawing. The port's counterpart of ``relation_detr_tpu/utils/visualize.py``
(cv2 there): per-class colours, boxes filled at ``alpha`` and outlined, score
labels, drawn with ``data/cv_ops.py``'s numpy counterparts of cv2's
``rectangle``, ``getTextSize``, ``putText`` and ``addWeighted``, whose bytes
they give."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from relation_detr_tpu_torch.data import cv_ops


def _class_color(label: int) -> tuple:
    rng = np.random.RandomState(int(label) * 7919 + 13)
    return tuple(int(c) for c in rng.randint(64, 255, 3))


def plot_bounding_boxes_on_image(
    image_bgr: np.ndarray,
    boxes_xyxy: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    alpha: float = 0.2,
    thickness: int = 2,
) -> np.ndarray:
    """(H, W, 3) uint8 BGR image with each box drawn: filled into an overlay
    blended in at ``alpha``, outlined, and labelled "name: score" (the class
    name, or the label past the names) in white on a box of its colour."""
    out = image_bgr.copy()
    overlay = image_bgr.copy()
    for box, score, label in zip(boxes_xyxy, scores, labels):
        color = _class_color(int(label))
        x0, y0, x1, y1 = [int(round(float(v))) for v in box]
        cv_ops.rectangle(overlay, (x0, y0), (x1, y1), color, -1)
        cv_ops.rectangle(out, (x0, y0), (x1, y1), color, thickness)
        name = (
            class_names[int(label)]
            if class_names and 0 <= int(label) < len(class_names)
            else str(int(label))
        )
        text = f"{name}: {float(score):.2f}"
        (tw, th), _ = cv_ops.get_text_size(text, cv_ops.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv_ops.rectangle(out, (x0, y0 - th - 4), (x0 + tw, y0), color, -1)
        cv_ops.put_text(out, text, (x0, y0 - 2), cv_ops.FONT_HERSHEY_SIMPLEX, 0.5,
                        (255, 255, 255), 1, cv_ops.LINE_AA)
    return cv_ops.add_weighted(overlay, alpha, out, 1 - alpha, 0)
