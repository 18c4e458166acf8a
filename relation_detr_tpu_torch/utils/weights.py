"""Weight bridge from the JAX package to the port.

``state_dict_from_jax`` is the inverse of
``tools/convert_torch_weights.py::convert_state_dict``: it takes the JAX
model's parameters and FrozenBN statistics as '/'-keyed numpy arrays (the
``params`` and ``batch_stats`` collections flattened) and returns the port's
``state_dict``: HWIO -> OIHW conv kernels, (in, out) -> (out, in) linear
kernels, q/k/v projections merged back into ``in_proj_weight``/``in_proj_bias``
and the flax module names mapped onto the reference's.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"^(layers|convs|class_head|bbox_head)_(\d+)$")
_STAGE_BLOCK = re.compile(r"^layer(\d+)_(\d+)$")
_RENAMES = {
    "downsample_conv": "downsample.0",
    "downsample_bn": "downsample.1",
    "fusion_0": "memory_fusion.0",
    "fusion_1": "memory_fusion.2",
    "fusion_norm": "memory_fusion.3",
    "pos_proj": "pos_proj.0",  # 1x1 Conv2d (+ ReLU) in a Sequential
}
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}
_BARE = {"transformer/tgt_embed": "transformer.tgt_embed.weight",
         "transformer/hybrid_tgt_embed": "transformer.hybrid_tgt_embed.weight"}
_QKV = ("q_proj", "k_proj", "v_proj")


def _module_path(parts) -> str:
    out = []
    for seg in parts:
        m = _STAGE_BLOCK.match(seg)
        if m:
            out.append(f"layer{m.group(1)}.{m.group(2)}")
            continue
        m = _INDEXED.match(seg)
        out.append(f"{m.group(1)}.{m.group(2)}" if m else _RENAMES.get(seg, seg))
    if out[0] == "neck":  # ConvNormActivation is a Sequential: 0 conv, 1 norm
        out = [{"conv": "0", "norm": "1"}.get(s, s) for s in out]
    return ".".join(out)


def _torch_name(key: str) -> str:
    if key in _BARE:
        return _BARE[key]
    parts = key.split("/")
    if parts[-1] not in _LEAVES:  # a bare parameter, e.g. level_embeds
        return _module_path(parts)
    return f"{_module_path(parts[:-1])}.{_LEAVES[parts[-1]]}"


def state_dict_from_jax(
    params_flat: Mapping[str, np.ndarray],
    batch_stats_flat: Mapping[str, np.ndarray],
) -> Dict[str, torch.Tensor]:
    """JAX '/'-keyed params and batch_stats -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in params_flat.items():
        value = np.asarray(value, np.float32)
        parts = key.split("/")
        if len(parts) >= 3 and parts[-2] in _QKV:
            qkv.setdefault("/".join(parts[:-2]), {})[f"{parts[-2]}/{parts[-1]}"] = value
            continue
        name = _torch_name(key)
        if parts[-1] == "kernel":
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif parts[-2] == "pos_proj":  # (in, H) Dense -> (H, in, 1, 1) conv
                value = value.T[:, :, None, None]
            else:
                value = value.T
        sd[name] = torch.from_numpy(np.ascontiguousarray(value))
    for prefix, parts in qkv.items():
        base = _module_path(prefix.split("/"))
        sd[f"{base}.in_proj_weight"] = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([parts[f"{n}/kernel"].T for n in _QKV], axis=0)
        ))
        sd[f"{base}.in_proj_bias"] = torch.from_numpy(
            np.concatenate([parts[f"{n}/bias"] for n in _QKV], axis=0)
        )
    for key, value in batch_stats_flat.items():
        sd[_torch_name(key)] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    return sd
