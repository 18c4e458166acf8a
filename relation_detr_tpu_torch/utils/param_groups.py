"""Optimizer parameter groups and the learning-rate schedule. Counterpart of
``relation_detr_tpu/utils/param_groups.py``.

``build_optimizer`` is the optax chain of ``build_optimizer``
(``param_groups.py:86-95``) in torch: AdamW (betas (0.9, 0.999), eps 1e-8,
decoupled weight decay 1e-4), no weight decay on biases and norm weights,
lr x0.1 for the backbone and the ``sampling_offsets``/``reference_points``
projections, and a global-norm clip of 0.1 over the trainable parameters
(applied by the train step, which reads ``optimizer.max_norm``).
``accumulate_steps`` > 1 is ``optax.MultiSteps`` around that whole chain
(``param_groups.py:96-97``): the train step accumulates the micro-batch
gradients and applies the chain to their mean every ``accumulate_steps``
accepted micro-steps (``optimizer.accumulate_steps``).

Frozen parameters (the ResNet stem and ``layer1``, ``requires_grad=False``)
are left out of the optimizer, as the reference leaves them. The JAX chain
instead zeroes their gradients and still applies weight decay to them, and
its ``is_frozen`` name test also catches the first conv of every later
ResNet block; ROADMAP Queue 3 records both.
"""
from __future__ import annotations

from typing import Callable, Union

import torch
from torch import nn

Schedule = Union[float, Callable[[int], float]]


def is_low_lr(name: str) -> bool:
    """Backbone + the deformable attention's linear projections train at
    lr x0.1 (param_dict.py:123-148)."""
    parts = name.split(".")
    return any(p in parts for p in ("backbone", "sampling_offsets", "reference_points"))


def no_weight_decay_names(model: nn.Module) -> set:
    """Biases and LayerNorm/GroupNorm weights (param_dict.py:100-121);
    embeddings keep weight decay, as torch AdamW does in the reference."""
    names = set()
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            if p_name == "bias" or p_name.endswith("_bias") or (
                    isinstance(module, (nn.LayerNorm, nn.GroupNorm)) and p_name == "weight"):
                names.add(full)
    return names


def build_optimizer(
    model: nn.Module,
    learning_rate_schedule: Schedule,
    weight_decay: float = 1e-4,
    betas=(0.9, 0.999),
    max_norm: float = 0.1,
    low_lr_factor: float = 0.1,
    accumulate_steps: int = 1,
) -> torch.optim.AdamW:
    """AdamW over the trainable parameters in (lr factor, weight decay)
    groups. Each group's ``lr_factor`` scales the schedule's lr; the train
    step sets the groups' lr before each update and clips to
    ``optimizer.max_norm`` first, and updates once every
    ``optimizer.accumulate_steps`` micro-steps."""
    if accumulate_steps < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
    no_wd = no_weight_decay_names(model)
    groups = {}
    for name, param in model.named_parameters():
        if not param.requires_grad:
            continue
        key = (low_lr_factor if is_low_lr(name) else 1.0,
               0.0 if name in no_wd else weight_decay)
        groups.setdefault(key, []).append(param)
    base_lr = learning_rate_schedule(0) if callable(learning_rate_schedule) \
        else learning_rate_schedule
    optimizer = torch.optim.AdamW(
        [{"params": params, "lr_factor": factor, "lr": base_lr * factor,
          "weight_decay": wd} for (factor, wd), params in groups.items()],
        lr=base_lr, betas=betas, eps=1e-8, weight_decay=weight_decay,
    )
    optimizer.lr_schedule = learning_rate_schedule
    optimizer.max_norm = max_norm
    optimizer.accumulate_steps = accumulate_steps
    return optimizer


def set_learning_rate(optimizer: torch.optim.Optimizer, count: int) -> None:
    """Set every group's lr to the schedule at update ``count`` times its
    factor (optax's ``scale_by_learning_rate`` after the masked x0.1)."""
    schedule = optimizer.lr_schedule
    lr = schedule(count) if callable(schedule) else schedule
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_factor"]


def warmup_multistep_schedule(
    base_lr: float,
    steps_per_epoch: int,
    milestones_epochs=(10,),
    gamma: float = 0.1,
    warmup_steps: int = 1000,
    warmup_factor: float = 1e-3,
) -> Callable[[int], float]:
    """Epoch-0 linear warmup (engine.py:30-35) + MultiStepLR drops."""
    warmup = min(warmup_steps, steps_per_epoch) if steps_per_epoch > 0 else warmup_steps

    def schedule(step: int) -> float:
        frac = min(step / max(warmup, 1), 1.0)
        lr = base_lr * (warmup_factor + (1 - warmup_factor) * frac)
        for m in milestones_epochs:
            if step >= m * steps_per_epoch:
                lr *= gamma
        return lr

    return schedule
