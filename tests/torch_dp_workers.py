"""Process bodies for ``tests/test_torch_parallel.py``: the port on N CPU
processes under gloo. This module imports no jax, so that the spawned
processes start quickly; the test file holds them against the JAX package.

``Spawned(jobs, tmp, world)`` starts ``world`` processes
(``torch.multiprocessing.spawn``, a ``file://`` rendezvous in ``tmp``, one
torch thread each, deterministic algorithms) that run each ``JOBS[job](spec)``
in turn, while the caller computes its references; ``join()`` returns
each rank's results. ``run_steps`` also runs alone (no group), as the
one-process reference.
"""
import os
import pickle

import cv2
import numpy as np
import torch

from relation_detr_tpu_torch.configs import build_detector
from relation_detr_tpu_torch.data.loader import GT_BUCKETS
from relation_detr_tpu_torch.losses.criterion import CriterionConfig
from relation_detr_tpu_torch.parallel import mesh
from relation_detr_tpu_torch.parallel.train_step import make_train_step
from relation_detr_tpu_torch.utils import param_groups

TIMEOUT_S = 120.0


def cv2_decode(data):
    return cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def rank_batch(batch, rank, size):
    """Rank ``rank``'s slice of a global batch (numpy, the loader's layout),
    its ground truth re-padded to the smallest bucket that holds its own
    images (``data/loader.py::collate``'s rule), as tensors."""
    b = batch["images"].shape[0] // size
    part = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
    need = int(part["gt_valid"].sum(1).max())
    cap = min(c for c in GT_BUCKETS if c >= need)
    for k in ("gt_labels", "gt_boxes", "gt_valid"):
        part[k] = part[k][:, :cap]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in part.items()}


def run_steps(spec):
    """``spec["steps"]`` train steps of the tiny model from ``spec["state"]``:
    each a global batch (this process takes its slice) with its injected
    denoising draws (the global batch's; the step takes this process's
    rows). Returns each step's metrics, the gradients AdamW stepped on
    (after the clip) at each update, and the trainable parameters after."""
    torch.manual_seed(0)
    rank, size = mesh.world()
    model = build_detector(spec["model_args"], "cpu", 0, remat_policy=spec.get("remat"))
    model.load_state_dict(spec["state"])
    model.train()
    optimizer = param_groups.build_optimizer(model, spec["lr"],
                                             accumulate_steps=spec.get("accumulate", 1))
    optimizer.max_norm = spec.get("max_norm", optimizer.max_norm)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    updates = []
    adamw_step = optimizer.step

    def recording_step(*args, **kwargs):
        updates.append({n: p.grad.clone() for n, p in named if p.grad is not None})
        return adamw_step(*args, **kwargs)

    optimizer.step = recording_step
    step = make_train_step(model, CriterionConfig(**spec["criterion_args"]), optimizer,
                           spec["hybrid_assign"], seed=0)
    metrics = []
    for batch, draws in spec["steps"]:
        model.denoising_generator.draw_noise = \
            lambda bs, gen, dev, draws=draws: {k: torch.from_numpy(v) for k, v in draws.items()}
        metrics.append(step(rank_batch(batch, rank, size)))
    return {"metrics": metrics, "updates": updates, "reduce_ms": step.reduce_ms(),
            "params": {n: p.detach().clone() for n, p in named}}


def gather(spec):
    """The evaluator path of the detection gather: this rank adds every
    ``size``-th image's detections (rank 1 also a perturbed copy of image
    0's, as the loader's wraparound repeats a batch); returns the 12 stats
    after the gather."""
    from relation_detr_tpu_torch.utils import evaluation
    from relation_detr_tpu_torch.utils.coco_eval import CocoEvaluator

    rank, size = mesh.world()
    evaluator = CocoEvaluator(spec["ann_file"])
    dets = spec["dets"]
    mine = [d for k, d in enumerate(dets) if k % size == rank]
    if rank == 1:
        img_id, boxes, scores, labels = dets[0]
        mine.append((img_id, boxes + 3.0, scores[::-1].copy(), labels))
    for img_id, boxes, scores, labels in mine:
        evaluator.update_from_arrays(img_id, boxes, scores, labels, skip_if_seen=True)
    evaluation.gather_detections_across_processes(evaluator)
    return {"stats": evaluator.accumulate_and_summarize(verbose=False),
            "images": len(evaluator.seen_images)}


def train_cli(spec):
    """The train CLI on this process's group; returns its result."""
    from relation_detr_tpu_torch import train

    out = train.main(spec["args"], decode=cv2_decode)
    return {k: out[k] for k in ("metrics", "evals", "paths", "lrs", "images")}


def eval_cli(spec):
    """The eval CLI on this process's group; returns its result."""
    from relation_detr_tpu_torch import test

    out = test.main(spec["args"], decode=cv2_decode)
    return {k: out[k] for k in ("stats", "images")}


JOBS = {"steps": run_steps, "gather": gather, "train_cli": train_cli, "eval_cli": eval_cli}


def _process(rank, world, spec_path, tmp):
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    with open(spec_path, "rb") as f:
        jobs = pickle.load(f)
    mesh.init_distributed("gloo", "cpu", init_method=f"file://{tmp}/rendezvous", rank=rank,
                          world_size=world, timeout_s=TIMEOUT_S)
    try:
        results = [JOBS[job](spec) for job, spec in jobs]
    finally:
        mesh.destroy()
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


class Spawned:
    """``jobs`` (a list of (job, spec)) run one after another in each of
    ``world`` processes started now; ``join()`` waits for them and returns,
    per job, each rank's result in rank order. A failing rank fails it."""

    def __init__(self, jobs, tmp, world=2):
        self.tmp, self.world, self.n = str(tmp), world, len(jobs)
        os.makedirs(self.tmp, exist_ok=True)
        spec_path = os.path.join(self.tmp, "jobs.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(jobs, f)
        self.context = torch.multiprocessing.spawn(_process, args=(world, spec_path, self.tmp),
                                                   nprocs=world, join=False)

    def join(self):
        while not self.context.join():
            pass
        per_rank = []
        for rank in range(self.world):
            with open(os.path.join(self.tmp, f"result{rank}.pkl"), "rb") as f:
                per_rank.append(pickle.load(f))
        return [[per_rank[r][j] for r in range(self.world)] for j in range(self.n)]


def spawn(job, spec, tmp, world=2):
    """One job in ``world`` processes: each rank's result, in rank order."""
    return Spawned([(job, spec)], tmp, world).join()[0]
