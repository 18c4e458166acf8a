"""Environment dump at start-up. Counterpart of
``relation_detr_tpu/utils/collect_env.py`` (the reference's
util/collect_env.py): Python, torch and its CUDA, the device's name and
power limit as ``nvidia-smi`` reports them, nvcc's version, numpy, and the
process group: its backend, its size and each rank's device (a gather, so
every process of a group calls it)."""
from __future__ import annotations

import platform
import shutil
import subprocess
import sys

import numpy as np
import torch


def _command(args) -> str:
    try:
        return subprocess.run(args, capture_output=True, text=True, check=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"


def process_group_info(device=None) -> str:
    """The group's backend, size and each rank's device (``device``, this
    process's: a card index, or -1 for the CPU)."""
    from relation_detr_tpu_torch.parallel import mesh

    if not mesh.initialized():
        return "process group: none (one process)"
    device = torch.device("cpu" if device is None else device)
    card = torch.cuda.current_device() if device.type == "cuda" else -1
    cards = mesh.all_gather_array(np.asarray([card], np.int64))
    where = ", ".join(f"rank {r}: " + (f"cuda:{c[0]}" if c[0] >= 0 else "cpu")
                      for r, c in enumerate(cards))
    return (f"process group: {mesh.backend_name()}, world size {mesh.world()[1]}; "
            f"devices: {where}")


def collect_env_info(device=None) -> str:
    from relation_detr_tpu_torch import _build

    lines = [
        f"python: {sys.version.split()[0]} ({platform.platform()})",
        f"torch: {torch.__version__}, CUDA {torch.version.cuda}",
        f"numpy: {np.__version__}",
    ]
    if torch.cuda.is_available():
        lines.append(f"devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    else:
        lines.append("devices: no CUDA device")
    if shutil.which("nvidia-smi"):
        smi = _command(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
        lines.append(f"nvidia-smi: {smi}")
    try:
        nvcc = _build.find_nvcc()
    except RuntimeError:
        lines.append("nvcc: not found")
    else:
        lines.append(f"nvcc: {_command([nvcc, '--version']).splitlines()[-1]}")
    lines.append(process_group_info(device))
    return "\n".join(lines)
