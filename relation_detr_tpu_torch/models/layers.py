"""Small shared layers and initializers. Counterpart of
``relation_detr_tpu/models/layers.py``.

Initialisation follows the JAX modules (which follow the reference): every
module of the port that owns parameters has ``init_weights(generator)``,
and ``init_weights(model, generator)`` walks a model once. Norm epsilons are
the JAX package's (flax LayerNorm/GroupNorm: 1e-6), not torch's 1e-5.

The precision policy: ``Linear`` and ``Conv2d`` carry a ``compute_dtype``,
the counterpart of flax's ``nn.Dense(dtype=...)`` / ``nn.Conv(dtype=...)``.
With a dtype set the input, the fp32 weight and the bias are cast to it and
the result comes out in it; parameters stay fp32. ``set_compute_dtype``
sets it on every such module below a root (the detector names its bf16
islands with it). flax rounds the product and then adds the bias in the
compute dtype; ``F.linear`` adds the bias in the fp32 accumulator and
rounds once, which on the card saves a launch per layer. The difference is
one bf16 rounding of the product (tests/test_torch_bf16.py measures it).

``dropout`` draws its masks from an explicit ``torch.Generator``, never the
global one: a layer seeds its own from a host integer (``dropout_generator``),
so a recompute under ``torch.utils.checkpoint`` draws the same masks.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax.linen.LayerNorm / GroupNorm default


def xavier_(layer: nn.Module, generator: torch.Generator) -> None:
    """xavier_uniform weight, zero bias (flax ``xavier_uniform``/``zeros``)."""
    nn.init.xavier_uniform_(layer.weight, generator=generator)
    if getattr(layer, "bias", None) is not None:
        nn.init.zeros_(layer.bias)


def lecun_(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax ``nn.Dense`` default: truncated-normal lecun weight, zero bias."""
    fan_in = layer.weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # flax truncation fix
    nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def prior_prob_bias(prior_prob: float = 0.01) -> float:
    """Focal-loss class bias -log((1 - p) / p)."""
    return -math.log((1 - prior_prob) / prior_prob)


def with_pos_embed(tensor: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    return tensor if pos is None else tensor + pos


def dropout_generator(seed: Optional[int], p: float, device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed``, or None when nothing
    is to be dropped (``p`` 0 or no seed: the eval forward)."""
    if p <= 0.0 or seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(p)``: each element kept with probability 1 - p and
    scaled by 1 / (1 - p), the mask drawn from ``generator``. The identity,
    with no draw, when ``generator`` is None (``dropout_generator``'s p = 0
    or eval)."""
    if generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def resolve_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A config's dtype string ("bfloat16", "float32", ...) or None."""
    if name is None:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]):
    return t if t is None or dtype is None else t.to(dtype)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``F.linear`` in ``compute_dtype`` (None: as the tensors come)."""
    return F.linear(_cast(x, compute_dtype), _cast(weight, compute_dtype),
                    _cast(bias, compute_dtype))


class Linear(nn.Linear):
    """``nn.Linear`` with a compute dtype (flax ``nn.Dense(dtype=...)``)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.compute_dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a compute dtype (flax ``nn.Conv(dtype=...)``)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


def set_compute_dtype(root: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Set ``compute_dtype`` on ``root`` and every module below it that has
    one (``Linear``, ``Conv2d`` and the modules that cast on their own)."""
    for module in root.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = dtype


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every port module of ``model`` that defines
    ``init_weights``, in module order, from one generator."""
    for module in model.modules():
        if hasattr(module, "init_weights"):
            module.init_weights(generator)
    return model


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine params, all buffers
    (state_dict names: weight, bias, running_mean, running_var). NCHW."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


class MLP(nn.Module):
    """DETR-style MLP, ReLU between layers (state_dict: layers.{i}).
    ``zero_last`` zero-initialises the last layer (the bbox heads)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, zero_last: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [output_dim])
        )
        self.zero_last = zero_last

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            xavier_(layer, generator)
        if self.zero_last:
            nn.init.zeros_(self.layers[-1].weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                x = torch.relu(x)
        return x


class ConvNormActivation(nn.Sequential):
    """Conv2d + GroupNorm(32) (NCHW), no activation — the ChannelMapper's
    block. state_dict: 0 = conv (bias-free), 1 = norm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, num_groups: int = 32):
        pad = (kernel_size - 1) // 2
        super().__init__(
            nn.Conv2d(in_channels, out_channels, kernel_size, stride, pad, bias=False),
            nn.GroupNorm(num_groups, out_channels, eps=LN_EPS),
        )

    def init_weights(self, generator: torch.Generator) -> None:
        xavier_(self[0], generator)
        nn.init.ones_(self[1].weight)
        nn.init.zeros_(self[1].bias)
