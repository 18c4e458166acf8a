"""The train step. Counterpart of
``relation_detr_tpu/parallel/train_step.py::make_train_step``.

One call does the train forward (CDN + hybrid branch), the loss, the
backward, the global-norm clip and the AdamW update, on the model's device.
The host syncs once for the matcher (by design, as the reference's scipy
matcher does) and once to read the metrics, which also decides the
non-finite skip: a step whose loss or gradient norm is not finite changes
neither the parameters nor the optimizer state, and is counted, as the JAX
step does in-graph (``train_step.py:134-155``).

With ``optimizer.accumulate_steps`` k > 1 a step is a micro-step, as under
the JAX chain's ``optax.MultiSteps``: its gradients are summed into an
accumulator, and every k-th accepted micro-step the mean is clipped to
``max_norm`` (the norm of the mean), AdamW steps at the lr of the update
count, and the accumulator is reset. A non-finite micro-step moves neither
the accumulator nor the micro-step count (the JAX step keeps MultiSteps'
whole state). ``grad_norm`` stays the micro-gradient's norm.

Single device; data parallelism is not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

from relation_detr_tpu_torch.losses.criterion import CriterionConfig, relation_detr_loss
from relation_detr_tpu_torch.utils.param_groups import set_learning_rate

BATCH_KEYS = ("images", "mask", "gt_labels", "gt_boxes", "gt_valid")


@dataclasses.dataclass
class TrainState:
    step: int = 0  # steps taken, skipped ones included
    updates: int = 0  # updates applied (the lr schedule's count, as optax's)
    micro_steps: int = 0  # accepted micro-steps in the accumulator (MultiSteps' mini_step)
    nonfinite_count: int = 0
    first_nonfinite_step: int = -1


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def apply_update(optimizer: torch.optim.Optimizer, params, grad_norm: torch.Tensor,
                 norm_value: float, updates: int) -> None:
    """Clip the gradients of ``params`` to ``optimizer.max_norm``
    (``optax.clip_by_global_norm``: scaled by max_norm / norm when the norm
    reaches max_norm), set the lr of update number ``updates`` and step.
    ``norm_value`` is ``grad_norm`` already read on the host, so the clip
    test costs no sync."""
    if norm_value >= optimizer.max_norm:
        for p in params:
            if p.grad is not None:
                p.grad.div_(grad_norm).mul_(optimizer.max_norm)
    set_learning_rate(optimizer, updates)
    optimizer.step()


@torch.no_grad()
def accumulate(optimizer: torch.optim.Optimizer, params, accumulator, state: TrainState) -> None:
    """One accepted micro-step of ``optax.MultiSteps``: adds the gradients of
    ``params`` (those that have one) to ``accumulator`` (a tensor per
    parameter) and counts it; on the ``optimizer.accumulate_steps``-th,
    applies ``apply_update`` to the mean (clipped by its own norm) at the lr
    of update ``state.updates``, counts the update, and zeroes the
    accumulator and the count. Leaves every ``.grad`` None."""
    got = [(a, p.grad) for a, p in zip(accumulator, params) if p.grad is not None]
    torch._foreach_add_([a for a, _ in got], [g for _, g in got])
    state.micro_steps += 1
    if state.micro_steps == optimizer.accumulate_steps:
        torch._foreach_div_(accumulator, float(optimizer.accumulate_steps))
        for p, a in zip(params, accumulator):
            p.grad = a
        norm = global_norm(accumulator)
        apply_update(optimizer, params, norm, norm.item(), state.updates)
        state.updates += 1
        state.micro_steps = 0
        torch._foreach_zero_(accumulator)
    for p in params:
        p.grad = None


def make_train_step(
    model: torch.nn.Module,
    criterion_cfg: CriterionConfig,
    optimizer: torch.optim.Optimizer,
    hybrid_assign: int = 6,
    seed: int = 0,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, float]]:
    """Build the train step: ``step(batch) -> metrics``.

    batch: images (B, H, W, 3), mask (B, H, W) bool, gt_labels (B, G),
    gt_boxes (B, G, 4) normalised cxcywh, gt_valid (B, G), on the model's
    device (the loader's layout). metrics: ``total_loss``, every loss term,
    ``grad_norm`` (over the trainable parameters, before the clip),
    ``nonfinite_count`` and ``first_nonfinite_step``, as floats/ints.
    ``step.state`` is the ``TrainState``; ``step.state_dict()`` /
    ``step.load_state_dict(d)`` give and take it with the accumulator (None
    without accumulation), by parameter name. The CDN draws come from a
    generator re-seeded from (seed, step) each step, the analogue of the
    JAX step's ``fold_in(rng, step)``.
    """
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    device = params[0].device
    generator = torch.Generator(device=device)
    state = TrainState()
    accumulator = ([torch.zeros_like(p) for p in params]
                   if getattr(optimizer, "accumulate_steps", 1) > 1 else None)

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        optimizer.zero_grad(set_to_none=True)
        generator.manual_seed((seed << 32) + state.step)
        images, mask, gt_labels, gt_boxes, gt_valid = (batch[k] for k in BATCH_KEYS)
        outputs = model(images, mask, gt_labels, gt_boxes, gt_valid, train=True,
                        generator=generator)
        total, losses = relation_detr_loss(criterion_cfg, outputs, gt_labels, gt_boxes,
                                           gt_valid, hybrid_assign)
        total.backward()
        grad_norm = global_norm(p.grad for p in params if p.grad is not None)
        names = ["total_loss", "grad_norm", *losses]
        values = torch.stack([total.detach(), grad_norm,
                              *(v.detach() for v in losses.values())]).cpu().tolist()
        metrics = dict(zip(names, values))
        if not (math.isfinite(values[0]) and math.isfinite(values[1])):
            state.nonfinite_count += 1
            if state.first_nonfinite_step < 0:
                state.first_nonfinite_step = state.step
        elif accumulator is not None:
            accumulate(optimizer, params, accumulator, state)
        else:
            apply_update(optimizer, params, grad_norm, values[1], state.updates)
            state.updates += 1
        optimizer.zero_grad(set_to_none=True)
        state.step += 1
        metrics["nonfinite_count"] = state.nonfinite_count
        metrics["first_nonfinite_step"] = state.first_nonfinite_step
        return metrics

    def state_dict() -> Dict:
        return {"state": dataclasses.asdict(state),
                "accumulator": None if accumulator is None else
                {n: a for (n, _), a in zip(named, accumulator)}}

    def load_state_dict(saved: Dict) -> None:
        for key, value in saved["state"].items():
            setattr(state, key, value)
        if (saved["accumulator"] is None) != (accumulator is None):
            raise ValueError("the saved train step and this one differ in accumulation")
        if accumulator is not None:
            with torch.no_grad():
                for (n, _), a in zip(named, accumulator):
                    a.copy_(saved["accumulator"][n])

    step.state = state
    step.state_dict = state_dict
    step.load_state_dict = load_state_dict
    return step
