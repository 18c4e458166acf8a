"""Training CLI: Relation-DETR on COCO, on the card.

The port's counterpart of the root ``train.py`` (the reference's main.py):

    python -m relation_detr_tpu_torch.train [--config-file ...train_config.py] \\
        [--model-config ...relation_detr_resnet50_800_1333.py] [--coco-path data/coco] \\
        [--output-dir out] [--num-epochs 12] [--batch-size 2] [--accumulate-steps 1] \\
        [--ema-decay 0.9998] [--eval-every-epochs 1] [--resume out | weights.npz]

Images decode with nvJPEG on the card and go through the ``detr`` train
preset on the host (``data/transforms.py``) in the loader's threads; the
loader pads them to a fixed canvas (``--canvas h,w``) or to aspect-grouped
canvas buckets (``--canvas buckets``); ``device_prefetch`` uploads batch k+1
from reused pinned buffers on a side stream while step k runs, and
normalises it there. Each step is ``parallel/train_step.py``'s (CDN, the
hybrid branch, the matcher, the criterion, the backward, the clip, AdamW),
micro-steps of ``--accumulate-steps``; ``--ema-decay`` keeps an EMA of the
parameters, updated once per optimizer step. Every ``--save-every-epochs``
epochs (and the last) the training state goes to ``checkpoints/<epoch>.pt``
(keep 5; ``utils/checkpoint.py``) and the weights to ``latest.npz`` and
``latest_ema.npz`` in the JAX package's layout (``utils/weights.py``, with
``_classes_`` when the config has ``class_names``); every
``--eval-every-epochs`` the COCO evaluation (``utils/evaluation.py``) runs
and the best AP and AP50 weights go to ``best_ap.npz`` / ``best_ap50.npz``.

``--resume`` of a directory (a run's output directory or its
``checkpoints/``) restores the model, AdamW, the step counts, the gradient
accumulator, the EMA and the loader's epoch, and trains on from the next
epoch; ``--resume`` of a ``.npz`` file loads those weights (leniently) and
fine-tunes. A run resumed after epoch e draws what the uninterrupted run
draws: the loader shuffles by (seed, epoch), each sample's augmentation
draws from a generator of (seed, epoch, index), and the CDN draws from
(seed, step).

``--mixed-precision bf16`` builds the model under the bf16 policy (the
backbone's convolutions and the transformer layers' projections in bf16,
the JAX package's fp32 islands kept; parameters, gradients, the clip and
AdamW fp32; no loss scaling, as in JAX). ``--remat-policy`` recomputes each
transformer layer in the backward (``models/transformer.py::
resolve_remat_policy``); unset, nothing is recomputed, also under bf16
(where the JAX CLI picks "dots"). A ``--resume`` of a directory must use
the run's ``--mixed-precision``; the checkpoint records it.

The MSDA flags (``--msda-impl``, ``--msda-halos``, ``--msda-dtype``) set
what the JAX package's ``apply_msda_cli_flags`` sets. After a weight load
(``--resume``), the clamp gate (``utils/clamp_check.py``) measures the
weights' tiled-MSDA clamp fraction on the first batch's first image under
a tiled impl (``--clamp-check on``: under any), and raises past
``--clamp-threshold`` when ``--msda-halos`` was forced: training on
halos that clamp bakes the clamp into the gradients.

``--device cpu`` runs on the CPU (the kernels' plain versions), for tests;
the CPU has no JPEG decoder, so a caller of ``main`` passes ``decode=``.

Data parallelism, one process per card:

    python -m torch.distributed.run --nproc-per-node N -m relation_detr_tpu_torch.train ...

Each process joins the group (``parallel/mesh.py``: NCCL on cards, gloo
with ``--device cpu``; ``--dist-backend gloo`` puts several processes on
one card), takes card ``LOCAL_RANK`` and every N-th batch of the seeded
batch list (``--batch-size`` per process, as the JAX CLI's per device, and
``steps_per_epoch`` of that shard), and steps on its slice of the global
batch, the step summing gradients, losses and ground-truth counts over the
group (``parallel/train_step.py``): every process keeps the same
parameters, AdamW state, EMA and metrics. The in-training evaluation runs
in every process on its shard and gathers the detections, so every
process sees the same stats and best AP. The main process (rank 0) alone
logs and writes checkpoints and weight files; the others wait for it.
``--resume`` restores in every process, under any process count, as the
JAX CLI restores under any device count (the state is the same in every
process). A caller of ``main`` that has already joined a group trains in
it; at one process the run is the single-process one, bit for bit.

Not ported, and raising: ``--tensorboard`` without a ``tensorboard``
package, and the JAX package's TPU-only MSDA settings, as in the port's
``test.py``.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import time
from contextlib import closing
from typing import Dict, Optional

import torch

from relation_detr_tpu_torch.data.image_io import Decode
from relation_detr_tpu_torch.data.loader import DataLoader, device_prefetch
from relation_detr_tpu_torch.parallel import mesh
from relation_detr_tpu_torch.parallel.train_step import BATCH_KEYS, make_train_step
from relation_detr_tpu_torch.ops.msda import apply_msda_cli_flags
from relation_detr_tpu_torch.test import add_msda_flags, halos_forced
from relation_detr_tpu_torch.utils import clamp_check
from relation_detr_tpu_torch.utils.checkpoint import CheckpointManager
from relation_detr_tpu_torch.utils.class_names import encode_labels
from relation_detr_tpu_torch.utils.collect_env import collect_env_info
from relation_detr_tpu_torch.utils.config import Config
from relation_detr_tpu_torch.utils.ema import ema_init, ema_update
from relation_detr_tpu_torch.utils.evaluation import StageTimes, evaluate_model
from relation_detr_tpu_torch.utils.logging import MetricLogger, setup_logger
from relation_detr_tpu_torch.utils.param_groups import build_optimizer, warmup_multistep_schedule
from relation_detr_tpu_torch.utils.weights import load_weights, save_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG = os.path.join(REPO, "relation_detr_tpu_torch", "configs", "train_config.py")
LOG_KEYS = ("total_loss", "grad_norm", "loss_class", "loss_bbox", "loss_giou")


def parse_args(argv=None):
    p = argparse.ArgumentParser("relation_detr_tpu_torch training")
    p.add_argument("--config-file", default=DEFAULT_CONFIG)
    p.add_argument("--model-config", default=None, help="override cfg.model_path")
    p.add_argument("--coco-path", default=None, help="override cfg.coco_path")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None, help="per-device batch size")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory = resume training (a run's output dir or "
                        "its checkpoints/); weight FILE (.npz) = load those weights and "
                        "fine-tune")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--canvas", default="800,1344",
                   help="fixed train canvas 'h,w', or 'buckets' for aspect-ratio-grouped "
                        "canvas buckets")
    p.add_argument("--max-steps", type=int, default=None, help="debug: stop early")
    p.add_argument("--accumulate-steps", type=int, default=1)
    p.add_argument("--save-every-epochs", type=int, default=1,
                   help="checkpoint every N epochs (the last epoch always saves)")
    p.add_argument("--eval-every-epochs", type=int, default=0,
                   help="run COCO eval every N epochs (0 = off); tracks best AP")
    p.add_argument("--tensorboard", action="store_true", help="log to <output>/tb")
    p.add_argument("--profile-steps", default=None,
                   help="START,STOP step range to trace with torch.profiler")
    p.add_argument("--mixed-precision", default="no", choices=("no", "bf16"),
                   help="bf16: the backbone's convolutions and the transformer layers' "
                        "projections in bf16 (parameters, LayerNorms, heads, the MSDA "
                        "sampling arithmetic, softmaxes, loss and optimizer stay fp32)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep an exponential moving average of the parameters, saved as "
                        "latest_ema.npz; 0 disables")
    p.add_argument("--remat-policy", default=None,
                   choices=(None, "none", "dots", "dots_no_batch", "save_all"),
                   help="recompute each transformer layer in the backward: none = all of "
                        "it, dots = all but the matmul outputs, dots_no_batch = all but "
                        "the unbatched ones, save_all = nothing (as when unset)")
    add_msda_flags(p)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="under torch.distributed.run: the process group's backend (default "
                        "nccl on cards, gloo on the CPU; gloo lets processes share a card)")
    return p.parse_args(argv)


def check_ported(args) -> None:
    if args.tensorboard:
        try:
            import tensorboard  # noqa: F401
        except ImportError:
            raise NotImplementedError("--tensorboard needs the tensorboard package, which "
                                      "is not installed") from None


def on_main(fn, *args, **kwargs) -> None:
    """``fn(*args, **kwargs)`` in the main process; every process returns
    once it has (a barrier)."""
    if mesh.is_main():
        fn(*args, **kwargs)
    mesh.barrier()


def _repo_path(path: str) -> str:
    """``path`` as given, or from the repository root when it is relative and
    not found from the working directory."""
    return path if os.path.exists(path) or os.path.isabs(path) else os.path.join(REPO, path)


class DeviceProfile:
    """A ``torch.profiler`` trace of steps [start, stop) of the run, written
    to ``<output>/profile/trace.json``; ``result`` holds the device-busy time
    (the device events' self time: kernels, copies, fills) against the span
    on the host clock (synchronised at both ends), both in ms, and the idle
    share. On the CPU the busy time is 0."""

    def __init__(self, spec: str, output_dir: str, device: torch.device):
        self.start, self.stop = (int(x) for x in spec.split(","))
        self.path = os.path.join(output_dir, "profile", "trace.json")
        self.cuda = device.type == "cuda"
        self.prof = None
        self.result = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def at(self, steps_run: int) -> None:
        """Called before step number ``steps_run`` of this run."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        if steps_run == self.start and self.prof is None:
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self._sync()
            self.prof = profile(activities=activities)
            self.prof.start()
            self.t0 = time.perf_counter()
        elif steps_run == self.stop and self.prof is not None and self.result is None:
            self._sync()
            span = (time.perf_counter() - self.t0) * 1e3
            self.prof.stop()
            busy = sum(e.self_device_time_total for e in self.prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and "Activity Buffer" not in e.key) / 1e3
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self.prof.export_chrome_trace(self.path)
            self.result = {"steps": self.stop - self.start, "span_ms": span,
                           "device_busy_ms": busy, "idle_share": 1.0 - busy / span,
                           "trace": self.path}


def training_state(model, optimizer, step, ema, epoch: int, loader_epoch: int,
                   precision: str = "no") -> Dict:
    """What a checkpoint holds: tensors and plain values only (and the
    process count, for the log of a resume)."""
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "train_step": step.state_dict(), "ema": ema, "epoch": epoch,
            "loader_epoch": loader_epoch, "mixed_precision": precision,
            "world_size": mesh.world()[1]}


def restore_training(src: CheckpointManager, model, optimizer, step, ema, device,
                     precision: str = "no") -> Dict:
    """Loads ``src``'s latest checkpoint into the model, AdamW, the train step
    (``TrainState`` and accumulator) and the EMA (name -> tensor, or None);
    returns the saved state. Raises if the checkpoint's run trained under
    another ``--mixed-precision`` than ``precision``."""
    saved = src.restore(map_location=device)
    if saved.get("mixed_precision", "no") != precision:
        raise ValueError(f"{src.directory}: the run trained with --mixed-precision "
                         f"{saved.get('mixed_precision', 'no')}, not {precision}")
    model.load_state_dict(saved["model"])
    optimizer.load_state_dict(saved["optimizer"])
    step.load_state_dict(saved["train_step"])
    if (saved["ema"] is None) != (ema is None):
        raise ValueError(f"{src.directory}: the checkpoint and --ema-decay disagree on "
                         "keeping an EMA")
    if ema is not None:
        with torch.no_grad():
            for n, value in saved["ema"].items():
                ema[n].copy_(value)
    return saved


def main(argv=None, decode: Optional[Decode] = None) -> Dict:
    """Trains; returns ``metrics`` (the last step's), ``paths`` (the output
    files), ``evals`` (each evaluation's epoch and 12 stats), ``lrs`` (the
    lr of each update applied), ``steps`` (per step: ``epoch``,
    ``total_loss``, ``start`` (the host clock when it began, s) and host ms
    of ``step`` (the step call), ``wait`` (the wait for the batch) and
    ``pin`` (its copy into pinned memory)), ``upload_ms``
    (the side stream's spans of the uploads, summed), ``images``,
    ``profile`` (``DeviceProfile.result`` with ``--profile-steps``) and
    ``clamp`` (the clamp gate's measurement of the loaded weights, or
    None)."""
    args = parse_args(argv)
    check_ported(args)
    apply_msda_cli_flags(args)
    device, created = mesh.join_from_env(args.device, args.dist_backend)
    try:
        return _main(args, device, decode)
    finally:
        if created:
            mesh.destroy()


def _main(args, device, decode) -> Dict:
    cfg = Config(_repo_path(args.config_file))
    model_path = _repo_path(args.model_config or cfg.model_path)
    model_cfg = Config(model_path)
    coco_path = args.coco_path or cfg.coco_path

    name = os.path.splitext(os.path.basename(model_path))[0]
    output_dir = args.output_dir or cfg.get("output_dir") or f"checkpoints/{name}"
    os.makedirs(output_dir, exist_ok=True)
    logger = setup_logger("relation_detr_tpu_torch")
    if not mesh.is_main():
        return _train(args, cfg, model_cfg, coco_path, output_dir, device, decode, logger)
    log_file = logging.FileHandler(os.path.join(output_dir, "train.log"))
    log_file.setFormatter(logger.handlers[0].formatter)
    logger.addHandler(log_file)
    try:
        return _train(args, cfg, model_cfg, coco_path, output_dir, device, decode, logger)
    finally:
        logger.removeHandler(log_file)
        log_file.close()


def _train(args, cfg, model_cfg, coco_path, output_dir, device, decode, logger) -> Dict:
    logger.info("environment:\n" + collect_env_info(device))
    dtype = "bfloat16" if args.mixed_precision == "bf16" else None
    model = model_cfg.build_model(device=device, seed=args.seed, backbone_dtype=dtype,
                                  compute_dtype=dtype, remat_policy=args.remat_policy)
    batch_size = args.batch_size or cfg.batch_size
    num_epochs = args.num_epochs or cfg.num_epochs
    bucketed = args.canvas == "buckets"
    canvas = None if bucketed else tuple(int(x) for x in args.canvas.split(","))

    dataset = cfg.train_dataset(coco_path, device=device, decode=decode)
    loader = DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=True,
        seed=args.seed,
        num_workers=cfg.get("num_workers", 4),
        fixed_canvas=canvas,
        aspect_ratio_group_factor=3 if bucketed else -1,
        drop_last=True,
    )
    steps_per_epoch = len(loader)
    world_size = mesh.world()[1]
    logger.info(f"{len(dataset)} images, {steps_per_epoch} steps/epoch, batch {batch_size} "
                f"per process, {world_size} process(es) ({mesh.backend_name() or 'no group'})")

    schedule = warmup_multistep_schedule(
        cfg.learning_rate,
        steps_per_epoch,
        milestones_epochs=cfg.get("lr_milestones", (10,)),
        gamma=cfg.get("lr_gamma", 0.1),
    )
    optimizer = build_optimizer(
        model,
        schedule,
        weight_decay=cfg.get("weight_decay", 1e-4),
        betas=cfg.get("betas", (0.9, 0.999)),
        max_norm=cfg.get("max_norm", 0.1),
        accumulate_steps=args.accumulate_steps,
    )
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params / 1e6:.1f}M")
    step = make_train_step(model, model_cfg.build_criterion(), optimizer,
                           model_cfg.get("hybrid_assign", 6), seed=args.seed)
    ema = ema_init(dict(model.named_parameters())) if args.ema_decay > 0.0 else None

    resume_from = args.resume or cfg.get("resume_from_checkpoint")
    loaded_weights = bool(resume_from)
    if isinstance(resume_from, str) and os.path.isfile(resume_from):
        # a weight FILE: load and fine-tune (reference main.py:143-148)
        load_weights(model, resume_from)
        logger.info(f"loaded pretrained weights from {resume_from}")
        if ema is not None:
            ema = ema_init(dict(model.named_parameters()))
        resume_from = None

    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"))
    start_epoch = cfg.get("starting_epoch", 0)
    if resume_from:
        # `--resume PATH` restores from PATH (any run's checkpoints); a bare
        # truthy config flag from this run's own
        src = ckpt
        if isinstance(resume_from, str) and os.path.isdir(resume_from):
            cand = os.path.join(resume_from, "checkpoints")
            src = CheckpointManager(cand if os.path.isdir(cand) else resume_from)
        saved = restore_training(src, model, optimizer, step, ema, device,
                                 args.mixed_precision)
        ckpt.best = dict(src.best)
        start_epoch = saved["epoch"] + 1
        logger.info(f"resumed from epoch {saved['epoch']} ({src.directory}), saved by "
                    f"{saved.get('world_size', 1)} process(es), resumed by {world_size}")

    clamp = None
    if loaded_weights and args.clamp_check != "off" and \
            clamp_check.gate_active(args.clamp_check == "on"):
        # training on halos that clamp this checkpoint's offsets bakes the
        # clamp into the gradients: one captured forward on the first
        # batch's first image, raising if forced halos clamp past the
        # threshold (the loader's samples depend on (seed, epoch, index)
        # alone, so the look ahead changes no batch)
        with closing(iter(loader)) as batches:
            first = next(batches, None)
        if first is not None:
            clamp = clamp_check.check_checkpoint_clamp(
                model, first["images"][:1], first["mask"][:1], threshold=args.clamp_threshold,
                halos_forced=halos_forced(args), force=args.clamp_check == "on")

    tb_writer = None
    if args.tensorboard and mesh.is_main():
        from torch.utils.tensorboard import SummaryWriter

        tb_writer = SummaryWriter(os.path.join(output_dir, "tb"))
    profile = DeviceProfile(args.profile_steps, output_dir, device) \
        if args.profile_steps and mesh.is_main() else None

    def check_divergence(metrics, host=None):
        # non-finite steps are skipped in the step (parallel/train_step.py),
        # so no garbage update is ever applied; stop with the step's index
        if metrics["nonfinite_count"] > 0:
            raise RuntimeError(
                f"non-finite loss first hit at step {metrics['first_nonfinite_step']} "
                f"({metrics['nonfinite_count']} skipped)"
                + (f"; latest metrics: {host}" if host else ""))

    print_freq = cfg.get("print_freq", 50)
    times = StageTimes(device)
    paths = {"checkpoints": ckpt.directory}
    evals, lrs, steps = [], [], []
    steps_run, images = 0, 0
    metrics = prev_metrics = metric = None
    waited: Dict[str, float] = {}
    stop_now = False
    def run_step(batch, epoch: int) -> None:
        nonlocal metrics, prev_metrics, steps_run, images, waited
        if profile is not None:
            profile.at(steps_run)
        t0 = time.perf_counter()
        updates = step.state.updates
        metrics = step(batch)
        # EMA tracks optimizer steps, not micro-steps (JAX train.py:297-300)
        if ema is not None and step.state.step % args.accumulate_steps == 0:
            ema_update(ema, dict(model.named_parameters()), args.ema_decay)
        if step.state.updates > updates:  # the lr the update took
            lrs.append(next(g["lr"] for g in optimizer.param_groups if g["lr_factor"] == 1.0))
        steps.append({"epoch": epoch, "start": t0, "step": (time.perf_counter() - t0) * 1e3,
                      "total_loss": metrics["total_loss"],
                      **{k: times.ms.get(k, 0.0) - waited.get(k, 0.0) for k in ("wait", "pin")}})
        waited = dict(times.ms)
        steps_run += 1
        images += batch["images"].shape[0]
        # the divergence stop checks the previous step's counters (the JAX
        # CLI's order, where that value is already on the host)
        if prev_metrics is not None:
            check_divergence(prev_metrics)
        prev_metrics = metrics
        if steps_run % print_freq == 0:
            host = {k: metrics[k] for k in LOG_KEYS}
            check_divergence(metrics, host)
            if not math.isfinite(host["total_loss"]):
                raise RuntimeError(f"non-finite loss at step {steps_run}: {host}")
            metric.update(**host)
            if tb_writer is not None:
                for k, v in metrics.items():
                    tb_writer.add_scalar(f"train/{k}", v, step.state.step)

    for epoch in range(start_epoch, num_epochs):
        loader.epoch = epoch
        metric = MetricLogger(print_freq=print_freq, logger=logger)
        waited = dict(times.ms)
        with closing(device_prefetch(loader, device, keys=BATCH_KEYS, times=times)) as batches:
            for batch in metric.log_every(batches, f"epoch {epoch}"):
                run_step(batch, epoch)
                if args.max_steps and steps_run >= args.max_steps:
                    logger.info("max steps reached")
                    stop_now = True
                    break
        if profile is not None:
            profile.at(steps_run)
        if args.eval_every_epochs and (
            (epoch + 1) % args.eval_every_epochs == 0 or epoch == num_epochs - 1
        ):
            # in-training COCO eval + best-AP weights (the reference's
            # engine.py evaluate_acc and HighestCheckpoint)
            stats = evaluate_model(
                model,
                cfg.test_dataset(coco_path, device=device, decode=decode,
                                 min_size=model_cfg.get("min_size", 800),
                                 max_size=model_cfg.get("max_size", 1333)),
                cfg.test_ann_file(coco_path),
                batch_size=cfg.get("eval_batch_size", 1),
                topk=model_cfg.get("select_box_nums_for_evaluation", 300),
                verbose=False,
                buckets=cfg.get("eval_buckets"),
            )
            evals.append({"epoch": epoch, "stats": stats})
            logger.info(f"epoch {epoch} eval: AP {stats['AP']:.4f} AP50 {stats['AP50']:.4f}")
            if tb_writer is not None:
                for k, v in stats.items():
                    tb_writer.add_scalar(f"val/{k}", v, step.state.step)
            improved = ckpt.update_best(stats["AP"], stats["AP50"])
            for key in ("ap", "ap50"):
                if improved[key]:
                    paths[f"best_{key}"] = os.path.join(output_dir, f"best_{key}.npz")
                    on_main(save_weights, paths[f"best_{key}"], model)
        if (epoch + 1) % args.save_every_epochs == 0 or epoch == num_epochs - 1 or stop_now:
            ckpt.save(epoch, training_state(model, optimizer, step, ema, epoch, loader.epoch,
                                            args.mixed_precision))
            class_names = cfg.get("class_names")
            extra = {"_classes_": encode_labels(class_names)} if class_names else None
            paths["latest"] = os.path.join(output_dir, "latest.npz")
            on_main(save_weights, paths["latest"], model, extra)
            if ema is not None:
                paths["latest_ema"] = os.path.join(output_dir, "latest_ema.npz")
                on_main(save_weights, paths["latest_ema"], model, extra,
                        state_dict={**model.state_dict(), **ema})
        if stop_now:
            break
    if prev_metrics is not None:  # the final step was never cross-checked
        check_divergence(prev_metrics)
    if tb_writer is not None:
        tb_writer.close()
    logger.info("training done")
    upload = times.totals().get("upload", 0.0)
    return {"metrics": metrics, "paths": paths, "evals": evals, "lrs": lrs, "steps": steps,
            "upload_ms": upload, "images": images,
            "profile": None if profile is None else profile.result, "clamp": clamp}


if __name__ == "__main__":
    main()
