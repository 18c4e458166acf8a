"""Weight bridge from the JAX package to the port.

``state_dict_from_jax`` is the inverse of
``tools/convert_torch_weights.py::convert_state_dict``: it takes the JAX
model's parameters and FrozenBN statistics as '/'-keyed numpy arrays (the
``params`` and ``batch_stats`` collections flattened) and returns the port's
``state_dict``: HWIO -> OIHW conv kernels, (in, out) -> (out, in) linear
kernels, q/k/v projections merged back into ``in_proj_weight``/``in_proj_bias``
and the flax module names mapped onto the reference's. ``load_weights``
reads the JAX package's ``.npz`` weight files into a model leniently, as
``relation_detr_tpu/utils/checkpoint.py::load_weights`` does.

The Swin backbone's names are torchvision's (``features.0.0``, ``features.{2s}``
for ``merge{s}``, ``features.{2s+1}.{j}`` for ``stage{s}_block{j}``,
``mlp.0`` / ``mlp.3``, ``cpb_mlp.0`` / ``.2``); ConvNeXt's and FocalNet's
blocks and MLPs take the same ones, their other modules the JAX names
(``focal_{l}`` as ``focal.{l}``). Depthwise kernels cross as any conv's:
HWIO (k, k, 1, C) <-> OIHW (C, 1, k, k).

``jax_weights`` is the inverse map: a port ``state_dict`` to the JAX
layout (``params/...`` and ``batch_stats/...``, merged ``in_proj`` tensors
split into the q, k and v keys), the same arrays as
``tools/convert_torch_weights.py::convert_state_dict``. ``save_weights``
writes it as the JAX package's ``save_weights`` does, so a weight file
crosses both ways.
"""
from __future__ import annotations

import logging
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_INDEXED = re.compile(r"^(layers|convs|class_head|bbox_head|focal)_(\d+)$")
_STAGE_BLOCK = re.compile(r"^layer(\d+)_(\d+)$")
# Swin, ConvNeXt and FocalNet name their blocks alike in the JAX package
# (stage{s}_block{j}, and Swin's and FocalNet's MLPs mlp_fc1 / mlp_fc2), so
# the port gives all three torchvision's Swin names for them
# (features.{2s+1}.{j}, mlp.0 / mlp.3), which ``convert_state_dict`` reads.
_SWIN_BLOCK = re.compile(r"^stage(\d+)_block(\d+)$")
_SWIN_MERGE = re.compile(r"^merge(\d+)$")
_BACKBONE_RENAMES = {
    "mlp_fc1": "mlp.0",
    "mlp_fc2": "mlp.3",
    "cpb_fc1": "cpb_mlp.0",
    "cpb_fc2": "cpb_mlp.2",
}
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
         "transformer/hybrid_tgt_embed": "transformer.hybrid_tgt_embed.weight",
         "transformer/refpoint_embed": "transformer.refpoint_embed.weight"}
_QKV = ("q_proj", "k_proj", "v_proj")


def _backbone_segment(seg: str, last: bool) -> Optional[str]:
    """The port's path of a Swin / ConvNeXt / FocalNet segment under
    ``backbone``, or None for one the port names as JAX does. Swin's
    ``patch_embed`` is the conv itself (``features.0.0``); FocalNet's holds
    ``proj`` and ``norm`` and keeps its name."""
    m = _SWIN_BLOCK.match(seg)
    if m:
        return f"features.{2 * int(m.group(1)) + 1}.{m.group(2)}"
    m = _SWIN_MERGE.match(seg)
    if m:
        return f"features.{2 * int(m.group(1))}"
    if seg == "patch_embed" and last:
        return "features.0.0"
    if seg == "patch_norm":
        return "features.0.2"
    return _BACKBONE_RENAMES.get(seg)


def _module_path(parts) -> str:
    out = []
    for i, seg in enumerate(parts):
        if parts[0] == "backbone":
            renamed = _backbone_segment(seg, i == len(parts) - 1)
            if renamed is not None:
                out.append(renamed)
                continue
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


def _param_slot(key: str) -> Tuple[str, Optional[int]]:
    """Where a JAX ``params`` array goes in the port: (state_dict name,
    part), part 0 / 1 / 2 for the q / k / v rows of a merged
    ``in_proj_weight`` / ``in_proj_bias``, else None."""
    parts = key.split("/")
    if len(parts) >= 3 and parts[-2] in _QKV:
        leaf = "in_proj_weight" if parts[-1] == "kernel" else "in_proj_bias"
        return f"{_module_path(parts[:-2])}.{leaf}", _QKV.index(parts[-2])
    return _torch_name(key), None


def _param_entry(key: str, value: np.ndarray) -> Tuple[str, Optional[int], np.ndarray]:
    """``_param_slot`` of a JAX ``params`` array and its value in the port's
    layout."""
    value = np.asarray(value, np.float32)
    if key.endswith("/kernel"):
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif key.split("/")[-2] == "pos_proj":  # (in, H) Dense -> (H, in, 1, 1) conv
            value = value.T[:, :, None, None]
        else:
            value = value.T
    return (*_param_slot(key), value)


def state_dict_from_jax(
    params_flat: Mapping[str, np.ndarray],
    batch_stats_flat: Mapping[str, np.ndarray],
) -> Dict[str, torch.Tensor]:
    """JAX '/'-keyed params and batch_stats -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    qkv: Dict[str, Dict[int, np.ndarray]] = {}
    for key, value in params_flat.items():
        name, part, value = _param_entry(key, value)
        if part is None:
            sd[name] = torch.from_numpy(np.ascontiguousarray(value))
        else:
            qkv.setdefault(name, {})[part] = value
    for name, parts in qkv.items():
        sd[name] = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([parts[i] for i in range(len(_QKV))], axis=0)))
    for key, value in batch_stats_flat.items():
        sd[_torch_name(key)] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    return sd


def _label(name: str, part: Optional[int]) -> str:
    return name if part is None else f"{name}[{'qkv'[part]}]"


def jax_key_label(key: str) -> str:
    """The port's name of a '/'-keyed array of a JAX weight file
    (``params/...`` or ``batch_stats/...``): its state_dict name, with
    ``[q]``, ``[k]`` or ``[v]`` for a part of a merged in_proj tensor."""
    collection, _, rest = key.partition("/")
    if collection == "batch_stats":
        return _torch_name(rest)
    return _label(*_param_slot(rest))


def load_weights(model: torch.nn.Module, path: str, strict: bool = False) -> Dict[str, list]:
    """Lenient load of a JAX-package ``.npz`` weight file (``params/...`` and
    ``batch_stats/...`` arrays) into ``model``, as the JAX package's
    ``utils/checkpoint.py::load_weights``: ``.npz`` is appended to a bare
    path; a tensor (or q / k / v part of a merged in_proj tensor) that the
    file lacks or holds at another shape keeps the model's value and is
    reported; ``strict=True`` raises on either before loading anything.
    Returns the report: ``loaded`` and ``missing`` names and ``mismatched``
    (name, file shape, model shape), named as ``jax_key_label``."""
    path = path if path.endswith(".npz") else path + ".npz"
    entries = {}  # (state_dict name, part) -> value in the port's layout
    with np.load(path) as archive:
        for key in archive.files:
            collection, _, rest = key.partition("/")
            if collection == "params":
                name, part, value = _param_entry(rest, archive[key])
                entries[(name, part)] = value
            elif collection == "batch_stats":
                entries[(_torch_name(rest), None)] = np.asarray(archive[key], np.float32)
    report = {"loaded": [], "mismatched": [], "missing": []}
    update: Dict[str, torch.Tensor] = {}
    for name, current in model.state_dict().items():
        merged = name.endswith((".in_proj_weight", ".in_proj_bias"))
        rows = current.shape[0] // len(_QKV) if merged else 0
        for part in range(len(_QKV)) if merged else (None,):
            label = _label(name, part)
            target = current if part is None else current[part * rows:(part + 1) * rows]
            value = entries.get((name, part))
            if value is None:
                report["missing"].append(label)
            elif tuple(value.shape) != tuple(target.shape):
                report["mismatched"].append((label, tuple(value.shape), tuple(target.shape)))
            else:
                report["loaded"].append(label)
                value = torch.from_numpy(np.ascontiguousarray(value)).to(current.dtype)
                if part is None:
                    update[name] = value
                else:
                    update.setdefault(name, current.clone())[part * rows:(part + 1) * rows] = value
    for label, got, want in report["mismatched"]:
        logger.warning(f"shape mismatch for {label}: checkpoint {got} vs model {want}")
    if report["missing"]:
        logger.warning(f"{len(report['missing'])} parameters missing from {path}")
    if strict and (report["mismatched"] or report["missing"]):
        raise ValueError(f"strict load failed: {len(report['mismatched'])} mismatched, "
                         f"{len(report['missing'])} missing")
    model.load_state_dict(update, strict=False)
    total = len(report["loaded"]) + len(report["mismatched"]) + len(report["missing"])
    logger.info(f"loaded {len(report['loaded'])}/{total} tensors from {path}")
    return report


# the inverse of _RENAMES: (module, index) segment pairs of the port
_PAIRS = {tuple(v.split(".")): k for k, v in _RENAMES.items() if "." in v}
_INDEXED_NAMES = ("layers", "convs", "class_head", "bbox_head", "focal")
_INV_BARE = {v: k for k, v in _BARE.items()}
_INV_BACKBONE = {tuple(v.split(".")): k for k, v in _BACKBONE_RENAMES.items()}


def _jax_backbone_segment(parts, i):
    """(JAX segment, port segments taken) for a Swin / ConvNeXt / FocalNet
    path under ``backbone`` at ``parts[i]``, or None: the inverse of
    ``_backbone_segment``."""
    seg, nxt = parts[i], parts[i + 1] if i + 1 < len(parts) else None
    pair = (seg, nxt)
    if pair in _INV_BACKBONE:
        return _INV_BACKBONE[pair], 2
    if seg != "features" or nxt is None:
        return None
    n, third = int(nxt), parts[i + 2] if i + 2 < len(parts) else None
    if n % 2:
        return f"stage{(n - 1) // 2}_block{third}", 3
    if n == 0:
        return {"0": "patch_embed", "2": "patch_norm"}[third], 3
    return f"merge{n // 2}", 2


def _jax_path(module_path: str) -> str:
    """The flax path ('/'-joined) of a port module path ('.'-joined): the
    inverse of ``_module_path``."""
    parts, out, i = module_path.split("."), [], 0
    while i < len(parts):
        seg, nxt = parts[i], parts[i + 1] if i + 1 < len(parts) else None
        backbone = _jax_backbone_segment(parts, i) if parts[0] == "backbone" else None
        if backbone is not None:
            out.append(backbone[0])
            i += backbone[1]
        elif (seg, nxt) in _PAIRS:
            out.append(_PAIRS[(seg, nxt)])
            i += 2
        elif nxt is not None and nxt.isdigit() and (
                seg in _INDEXED_NAMES or re.fullmatch(r"layer\d+", seg)):
            out.append(f"{seg}_{nxt}")
            i += 2
        elif parts[0] == "neck" and seg in ("0", "1"):
            out.append({"0": "conv", "1": "norm"}[seg])
            i += 1
        else:
            out.append(seg)
            i += 1
    return "/".join(out)


def jax_weights(model: torch.nn.Module,
                state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, np.ndarray]:
    """``state_dict`` (the model's own when None) in the JAX package's weight
    layout: '/'-keyed ``params/...`` (conv kernels HWIO, linear kernels (in,
    out), the relation's 1x1 ``pos_proj`` conv as a Dense kernel, LayerNorm
    and GroupNorm weights as ``scale``, embeddings as ``embedding``, merged
    ``in_proj`` tensors as q/k/v kernels and biases) and ``batch_stats/...``
    (the FrozenBN buffers). Each key is checked to map back to its tensor
    through ``state_dict_from_jax``'s names; one that does not raises."""
    state_dict = model.state_dict() if state_dict is None else state_dict
    buffers = {name for name, _ in model.named_buffers()}
    out: Dict[str, np.ndarray] = {}
    for name, tensor in state_dict.items():
        value = tensor.detach().cpu().numpy()
        module_path, _, leaf = name.rpartition(".")
        if name in buffers:
            key = f"{_jax_path(module_path)}/{leaf}"
            if _torch_name(key) != name:
                raise ValueError(f"{name}: no JAX key maps back to it (got {key})")
            out[f"batch_stats/{key}"] = value
            continue
        module = model.get_submodule(module_path)
        path = _jax_path(module_path)
        if leaf in ("in_proj_weight", "in_proj_bias"):
            for part, (proj, chunk) in enumerate(zip(_QKV, np.split(value, len(_QKV)))):
                key = f"{path}/{proj}/{'kernel' if leaf == 'in_proj_weight' else 'bias'}"
                out[key] = chunk.T if leaf == "in_proj_weight" else chunk
                if _param_slot(key) != (name, part):
                    raise ValueError(f"{name}: no JAX key maps back to it (got {key})")
            continue
        if name in _INV_BARE:
            key = _INV_BARE[name]
        elif leaf == "weight" and isinstance(module, torch.nn.Conv2d):
            key = f"{path}/kernel"
            if path.split("/")[-1] == "pos_proj":  # a Dense kernel in the JAX model
                value = value[:, :, 0, 0].T
            else:
                value = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif leaf == "weight" and isinstance(module, torch.nn.Linear):
            key, value = f"{path}/kernel", value.T
        elif leaf == "weight" and isinstance(module, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            key = f"{path}/scale"
        elif leaf == "weight" and isinstance(module, torch.nn.Embedding):
            key = f"{path}/embedding"
        elif leaf == "bias":
            key = f"{path}/bias"
        else:  # a bare parameter, e.g. level_embeds
            key = _jax_path(name)
        if _param_slot(key) != (name, None):
            raise ValueError(f"{name}: no JAX key maps back to it (got {key})")
        out[key] = np.ascontiguousarray(value)
    return {(k if k.startswith("batch_stats/") else f"params/{k}"): v for k, v in out.items()}


def save_weights(path: str, model: torch.nn.Module,
                 extra: Optional[Mapping[str, np.ndarray]] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """Writes ``jax_weights(model, state_dict)`` and ``extra`` (e.g.
    ``_classes_``) as an ``.npz`` file, as the JAX package's
    ``utils/checkpoint.py::save_weights`` writes its weights: the JAX
    package's ``load_weights`` and the port's read it."""
    arrays = jax_weights(model, state_dict)
    arrays.update(extra or {})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
