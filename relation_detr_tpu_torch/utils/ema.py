"""Exponential moving average of the parameters. Counterpart of
``relation_detr_tpu/utils/ema.py`` (the reference's util/utils.py:272-282,
torch AveragedModel with decay averaging): ``ema = decay * ema + (1 - decay)
* params``, on name -> tensor dicts, in place, with foreach ops (one launch
per op for all tensors on a card)."""
from __future__ import annotations

from typing import Dict

import torch


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A real copy of ``params`` (name -> tensor), not a view of them."""
    return {name: p.detach().clone() for name, p in params.items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.999) -> None:
    """``ema[n] = ema[n] * decay + params[n] * (1 - decay)`` for every name,
    in place; each product rounded apart and then added, as the JAX
    package's jitted ``ema_update`` computes it on the CPU."""
    names = list(ema)
    shadow = [ema[n] for n in names]
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, torch._foreach_mul([params[n].detach() for n in names],
                                                   1.0 - decay))
