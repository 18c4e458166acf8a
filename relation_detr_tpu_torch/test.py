"""Evaluation CLI: COCO bbox mAP of a model over a split, on the card.

The port's counterpart of the root ``test.py``:

    python -m relation_detr_tpu_torch.test --coco-path data/coco \\
        [--model-config relation_detr_tpu_torch/configs/relation_detr/...py] \\
        [--checkpoint weights.npz] [--batch-size 2] [--result-json out.json]

Images decode with nvJPEG on the card (``data/image_io.py``), resize on the
host (``EvalPreset(normalize_host=False)``) into the loader's canvas
buckets, go to the card as uint8 and are normalised there; the forward,
``post_process`` top-k (``select_box_nums_for_evaluation`` of the config)
and the packing run on the card, batch k+1 queued before batch k is
fetched (``utils/evaluation.py``). ``--checkpoint`` takes the JAX package's
``.npz`` weight files (``utils/weights.py::load_weights``); without one the
model keeps its weights drawn from seed 0. ``--eval-json`` re-scores a
predictions file without a model.

``--device cpu`` runs the model on the CPU (the kernels' plain versions);
the CPU has no JPEG decoder, so a caller of ``main`` passes ``decode=``.

Data parallelism, one process per card:

    python -m torch.distributed.run --nproc-per-node N -m relation_detr_tpu_torch.test ...

Each process (``parallel/mesh.py``: NCCL on cards, gloo with ``--device
cpu``; ``--dist-backend gloo`` lets several share a card) evaluates every
N-th batch, and the detections are gathered into every process
(``utils/evaluation.py``), so each computes the 12 stats over the whole
split; the main process (rank 0) alone logs them and writes
``--result-json`` (every image's predictions, in image and category
order).

Not ported, and raising: ``--show-dir`` / ``--show-conf``, and the JAX
package's TPU-only settings (``--msda-halos`` other than ``auto``,
``--msda-dtype bf16``, ``--msda-int8-slab``, ``--clamp-check on``,
``--msda-profile fast``). ``--msda-profile auto`` and ``--clamp-check
auto`` mean the exact default, as they do in the JAX package when no clamp
gate is in play.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from relation_detr_tpu_torch.data.coco import CocoDetection
from relation_detr_tpu_torch.data.image_io import Decode
from relation_detr_tpu_torch.data.loader import DataLoader
from relation_detr_tpu_torch.data.transforms import EvalPreset
from relation_detr_tpu_torch.ops.msda import set_msda_defaults
from relation_detr_tpu_torch.parallel import mesh
from relation_detr_tpu_torch.utils.coco_eval import CocoEvaluator
from relation_detr_tpu_torch.utils.config import Config
from relation_detr_tpu_torch.utils.evaluation import (
    StageTimes,
    accumulate_batch,
    detection_stream,
    gather_detections_across_processes,
    make_detections_fn,
)
from relation_detr_tpu_torch.utils.logging import MetricLogger, setup_logger
from relation_detr_tpu_torch.utils.weights import load_weights

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "configs", "relation_detr", "relation_detr_resnet50_800_1333.py",
)


def parse_args(argv=None):
    p = argparse.ArgumentParser("relation_detr_tpu_torch evaluation")
    p.add_argument("--coco-path", default="data/coco")
    p.add_argument("--split", default="val2017")
    p.add_argument("--model-config", default=DEFAULT_CONFIG)
    p.add_argument("--checkpoint", default=None, help="the JAX package's .npz weight file")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--result-json", default=None, help="dump predictions json")
    p.add_argument("--eval-json", default=None,
                   help="re-score an existing predictions json without a model")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--per-category", action="store_true",
                   help="print the per-category AP/AR table")
    p.add_argument("--show-dir", default=None, help="not ported")
    p.add_argument("--show-conf", type=float, default=None, help="not ported")
    p.add_argument("--msda-impl", default=None, choices=("gather", "tiled", "tiled_xla"),
                   help="MSDA form (default: gather)")
    p.add_argument("--msda-halos", default=None, help="only 'auto' is ported")
    p.add_argument("--msda-dtype", default=None, choices=("auto", "fp32", "bf16"),
                   help="only auto / fp32 are ported")
    p.add_argument("--msda-int8-slab", action="store_true", help="not ported")
    p.add_argument("--clamp-check", default="auto", choices=("auto", "on", "off"),
                   help="auto / off: no clamp gate (the port's tiled form is exact); "
                        "on is not ported")
    p.add_argument("--msda-profile", default="auto", choices=("auto", "exact", "fast"),
                   help="auto / exact: the exact default; fast is not ported")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="under torch.distributed.run: the process group's backend (default "
                        "nccl on cards, gloo on the CPU; gloo lets processes share a card)")
    return p.parse_args(argv)


def apply_msda_flags(args) -> None:
    """The MSDA flags onto the port's defaults; the TPU-only ones raise.
    Also takes the train CLI's arguments, which lack the eval-only flags."""
    if getattr(args, "show_dir", None) is not None or getattr(args, "show_conf", None) is not None:
        raise NotImplementedError("--show-dir / --show-conf are not ported "
                                  "(ROADMAP Queue 1 item 7)")
    if args.clamp_check == "on":
        raise NotImplementedError("--clamp-check on is not ported (no clamp gate: the "
                                  "port's tiled MSDA keeps the exact auto halos)")
    if getattr(args, "msda_profile", "auto") == "fast":
        raise NotImplementedError("--msda-profile fast is not ported (reduced halos)")
    if args.msda_impl:
        set_msda_defaults(impl=args.msda_impl)
    if args.msda_halos:
        set_msda_defaults(tiled_halos="auto" if args.msda_halos == "auto"
                          else tuple(int(v) for v in args.msda_halos.split(",")))
    if args.msda_dtype:
        set_msda_defaults(tiled_dtype={"auto": "auto", "fp32": torch.float32,
                                       "bf16": torch.bfloat16}[args.msda_dtype])
    if getattr(args, "msda_int8_slab", False):
        set_msda_defaults(tiled_int8_slab=True)


def _category_names(ann_file):
    try:
        with open(ann_file) as f:
            return {c["id"]: c["name"] for c in json.load(f)["categories"]}
    except (OSError, KeyError, ValueError):
        return None


def predictions_of(image_id: int, det: np.ndarray):
    """COCO result dicts of one image's (topk, 6) detections; the box width
    and height in float64, as the evaluator computes them."""
    out = []
    for x0, y0, x1, y1, score, label in det.astype(np.float64):
        out.append({"image_id": image_id, "category_id": int(label),
                    "bbox": [x0, y0, x1 - x0, y1 - y0], "score": score})
    return out


STAGES = ("decode", "transform", "pin", "copy", "forward", "evaluator")


def evaluate(det_fn, loader, ann_file: str, device, result_json: Optional[str] = None,
             per_category: bool = False, logger=None) -> Dict:
    """``det_fn``'s detections over ``loader``'s batches
    (``detection_stream``) into a ``CocoEvaluator``; with ``result_json``
    their COCO result dicts into that file. Returns ``stats`` (the 12 COCO
    stats, and the per-category APs with ``per_category``), ``images``,
    ``canvases`` (the (H, W) seen), ``seconds``, ``images_per_s`` and
    ``ms_per_image`` by stage: decode and transform (host seconds summed
    over the loader's threads, from ``loader.dataset.seconds``), pin (host),
    copy and forward (spans on the card's stream, ``StageTimes``),
    evaluator (host)."""
    logger = logger or setup_logger("relation_detr_tpu_torch")
    evaluator = CocoEvaluator(ann_file)
    metric = MetricLogger(print_freq=50, logger=logger)
    times = StageTimes(device)
    predictions, canvases, images = [], set(), 0
    t0 = time.perf_counter()
    for batch, det in detection_stream(det_fn, loader, device, times=times,
                                       progress=lambda it: metric.log_every(it, "eval")):
        canvases.add(tuple(batch["images"].shape[1:3]))
        with times.span("evaluator", on_card=False):
            accumulate_batch(evaluator, batch, det)
        for i, image_id in enumerate(batch["image_ids"]):
            if image_id < 0:
                continue  # tail padding
            images += 1
            if result_json:
                predictions.extend(predictions_of(int(image_id), det[i]))
    with times.span("evaluator", on_card=False):
        gather_detections_across_processes(evaluator)
        stats = evaluator.accumulate_and_summarize(per_category=per_category,
                                                   category_names=_category_names(ann_file))
    seconds = time.perf_counter() - t0
    logger.info(f"mAP: {stats['AP']:.4f}  AP50: {stats['AP50']:.4f}")
    if result_json and mesh.active():  # every process's, from the gathered evaluator
        predictions = [d for _, dets in sorted(evaluator.dets.items()) for d in dets]
    if result_json and mesh.is_main():
        with open(result_json, "w") as f:
            json.dump(predictions, f)
        logger.info(f"wrote {len(predictions)} predictions to {result_json}")
    mesh.barrier()
    ms = times.totals()
    for key, value in getattr(loader.dataset, "seconds", {}).items():
        ms[key] = value * 1e3
    per_image = {k: ms.get(k, 0.0) / max(images, 1) for k in STAGES}
    logger.info(f"{images} images in {seconds:.3f} s ({images / seconds:.3f} images/s); ms "
                "per image: " + ", ".join(f"{k} {v:.3f}" for k, v in per_image.items()))
    return {"stats": stats, "images": images, "canvases": sorted(canvases),
            "seconds": seconds, "images_per_s": images / seconds, "ms_per_image": per_image}


def main(argv=None, decode: Optional[Decode] = None) -> Dict:
    """Runs the evaluation; returns ``stats`` after ``--eval-json``, else
    ``evaluate``'s result."""
    args = parse_args(argv)
    apply_msda_flags(args)
    device, created = mesh.join_from_env(args.device, args.dist_backend)
    try:
        return _main(args, device, decode)
    finally:
        if created:
            mesh.destroy()


def _main(args, device, decode) -> Dict:
    logger = setup_logger("relation_detr_tpu_torch")
    ann_file = os.path.join(args.coco_path, "annotations", f"instances_{args.split}.json")
    if args.eval_json:
        evaluator = CocoEvaluator(ann_file)
        with open(args.eval_json) as f:
            evaluator.update(json.load(f))
        stats = evaluator.accumulate_and_summarize(per_category=args.per_category,
                                                   category_names=_category_names(ann_file))
        logger.info(f"mAP: {stats['AP']:.4f}  AP50: {stats['AP50']:.4f}")
        return {"stats": stats}

    cfg = Config(args.model_config)
    model = cfg.build_model(device=device)
    if args.checkpoint:
        load_weights(model, args.checkpoint)
    dataset = CocoDetection(
        img_folder=os.path.join(args.coco_path, args.split),
        ann_file=ann_file,
        transforms=EvalPreset(cfg.get("min_size", 800), cfg.get("max_size", 1333),
                              normalize_host=False),  # uint8 upload, 4x less
        device=device,
        decode=decode,
    )
    if args.max_images:
        dataset.ids = dataset.ids[: args.max_images]
    # adaptive canvas buckets: portrait images resize up to (1333, 800)
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=False)
    det_fn = make_detections_fn(model, cfg.get("select_box_nums_for_evaluation", 300))
    return evaluate(det_fn, loader, ann_file, device, args.result_json, args.per_category,
                    logger)


if __name__ == "__main__":
    main()
