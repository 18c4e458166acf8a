"""The COCO evaluation loop: batched eval forward, top-k decode, accumulate.

Counterpart of ``relation_detr_tpu/utils/evaluation.py``:
``make_detections_fn`` (normalise a uint8 canvas on the card, forward,
``post_process`` and one packed (B, topk, 6) tensor), ``detection_stream``
(batch k+1 goes to the card before batch k's detections are fetched, so
the card computes while the host accumulates), ``pack_local_detections``,
``merge_packed_detections``, ``gather_detections_across_processes`` and
``evaluate_model``. The model holds its weights and runs where they lie:
the card, or the CPU when a caller asks for it.

Not ported: the cross-process gather for more than one process (ROADMAP
Queue 1 item 8) raises; a single process needs none.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch

from relation_detr_tpu_torch.data.loader import DataLoader, Normalizer
from relation_detr_tpu_torch.models.post_process import post_process
from relation_detr_tpu_torch.utils.coco_eval import CocoEvaluator


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_detections_fn(model: torch.nn.Module, topk: int):
    """``det_fn(images, mask, orig_sizes)`` -> (B, topk, 6) float32 tensor
    [x0 y0 x1 y1 score label] on the model's device.

    A uint8 canvas (``EvalPreset(normalize_host=False)``) is normalised here
    with the host's math (``data/loader.py::Normalizer``), its padding an
    exact 0, as the host path pads after normalising.
    Boxes are in pixels of ``orig_sizes`` (B, 2) (h, w)."""
    normalize = Normalizer(model_device(model))

    def det_fn(images: torch.Tensor, mask: torch.Tensor, orig_sizes: torch.Tensor):
        with torch.inference_mode():
            if images.dtype == torch.uint8:
                images = normalize(images, mask)
            out = model(images, mask)
            det = post_process(out["pred_logits"], out["pred_boxes"], orig_sizes, topk)
            return torch.cat([det["boxes"], det["scores"][..., None],
                              det["labels"].to(torch.float32)[..., None]], dim=-1)

    return det_fn


class StageTimes:
    """Milliseconds spent per named stage: for a span on a card, CUDA events
    recorded on the current stream before and after the stage's work is
    queued (the stream's time from the event before to the event after,
    read once the stream is done: a wait for the host's dispatch inside the
    span counts, a wait before it does not); the host clock otherwise."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.ms: Dict[str, float] = defaultdict(float)
        self._events = []

    @contextmanager
    def span(self, name: str, on_card: bool = True):
        if self.cuda and on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self._events.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.ms[name] += (time.perf_counter() - t0) * 1e3

    def totals(self) -> Dict[str, float]:
        """Every stage's milliseconds so far (waits for the card's spans)."""
        for name, start, end in self._events:
            end.synchronize()
            self.ms[name] += start.elapsed_time(end)
        self._events = []
        return dict(self.ms)


def host_inputs(batch, device: torch.device):
    """The batch's images, mask and orig_sizes (float32) as host tensors,
    in pinned memory when ``device`` is a card (for non-blocking copies)."""
    arrays = (batch["images"], batch["mask"], batch["orig_sizes"].astype(np.float32))
    tensors = tuple(torch.from_numpy(a) for a in arrays)
    return tuple(t.pin_memory() for t in tensors) if device.type == "cuda" else tensors


def upload(batch, device: torch.device):
    """``host_inputs`` on ``device``, the copies to a card non-blocking."""
    return tuple(t.to(device, non_blocking=True) for t in host_inputs(batch, device))


def detection_stream(det_fn, loader, device, progress=None, times: StageTimes = None):
    """Yields (batch, detections) with detections a host (B, topk, 6) array,
    the upload of batch k+1 and its forward queued before batch k's
    detections are fetched. ``times`` (optional) gathers the stages "pin"
    (host clock), "copy" (the non-blocking copies' span on the stream) and
    "forward" (the forward's span on the stream)."""
    device = torch.device(device)
    times = times if times is not None else StageTimes(device)
    it = iter(progress(loader) if progress is not None else loader)

    def dispatch(inputs):
        with times.span("forward"):
            return det_fn(*inputs)

    pending = None  # (batch, detections on the device)
    staged = None  # (batch, uploaded inputs)
    for batch in it:
        with times.span("pin", on_card=False):
            host = host_inputs(batch, device)
        with times.span("copy"):  # stage k+1's transfer behind k's compute
            up = tuple(t.to(device, non_blocking=True) for t in host)
        if staged is not None:
            dev = dispatch(staged[1])
            if pending is not None:
                yield pending[0], pending[1].cpu().numpy()
            pending = (staged[0], dev)
        staged = (batch, up)
    if staged is not None:
        dev = dispatch(staged[1])
        if pending is not None:
            yield pending[0], pending[1].cpu().numpy()
        pending = (staged[0], dev)
    if pending is not None:
        yield pending[0], pending[1].cpu().numpy()


def pack_local_detections(evaluator: CocoEvaluator) -> np.ndarray:
    """This process's accumulated detections as one (N, 7) float64 array
    [image_id, category_id, x, y, w, h, score], for a cross-process gather."""
    rows = []
    for (img_id, cat_id), dets in evaluator.dets.items():
        for d in dets:
            rows.append(
                [float(img_id), float(cat_id)] + [float(v) for v in d["bbox"]]
                + [d["score"]]
            )
    if not rows:
        return np.zeros((0, 7), np.float64)
    return np.asarray(rows, np.float64)


def merge_packed_detections(evaluator: CocoEvaluator, packed_per_process) -> None:
    """Merge other processes' packed detections into this evaluator, image
    by image (xywh back to xyxy); images this process already evaluated are
    skipped (``update_from_arrays(skip_if_seen=True)``)."""
    per_img = defaultdict(list)
    for packed in packed_per_process:
        packed = np.asarray(packed)
        for row in packed:
            per_img[int(row[0])].append(row)
    for img_id, rows in per_img.items():
        arr = np.stack(rows)
        xywh = arr[:, 2:6]
        xyxy = np.stack(
            [xywh[:, 0], xywh[:, 1], xywh[:, 0] + xywh[:, 2], xywh[:, 1] + xywh[:, 3]],
            axis=-1,
        )
        evaluator.update_from_arrays(
            img_id, xyxy, arr[:, 6], arr[:, 1].astype(np.int64),
            skip_if_seen=True,
        )


def gather_detections_across_processes(evaluator: CocoEvaluator) -> None:
    """Every process's detections into every process's evaluator: nothing to
    do for one process; more than one is not ported yet."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError("the cross-process detection gather is not ported "
                                  "(ROADMAP Queue 1 item 8)")


def accumulate_batch(evaluator: CocoEvaluator, batch, det: np.ndarray) -> None:
    """One batch's (B, topk, 6) detections into the evaluator; tail padding
    (image_id -1) and repeated images are skipped."""
    for i in range(len(det)):
        if batch["image_ids"][i] < 0:
            continue
        evaluator.update_from_arrays(
            int(batch["image_ids"][i]), det[i, :, :4], det[i, :, 4],
            det[i, :, 5].astype(np.int64), skip_if_seen=True,
        )


def evaluate_model(
    model: torch.nn.Module,
    dataset,
    ann_file: str,
    batch_size: int = 4,
    topk: int = 300,
    verbose: bool = True,
    buckets=None,
) -> Dict[str, float]:
    """The 12 COCO stats of ``model`` over ``dataset``, through
    ``make_detections_fn`` and ``detection_stream``. (The JAX function's
    ``fwd`` argument, a raw forward for its tests, has no counterpart: the
    model is the forward.)"""
    kwargs = {} if buckets is None else {"buckets": tuple(buckets)}
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False, **kwargs)
    evaluator = CocoEvaluator(ann_file)
    det_fn = make_detections_fn(model, topk)
    for batch, det in detection_stream(det_fn, loader, model_device(model)):
        accumulate_batch(evaluator, batch, det)
    gather_detections_across_processes(evaluator)
    return evaluator.accumulate_and_summarize(verbose=verbose)
