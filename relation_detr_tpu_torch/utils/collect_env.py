"""Environment dump at start-up. Counterpart of
``relation_detr_tpu/utils/collect_env.py`` (the reference's
util/collect_env.py): Python, torch and its CUDA, the device's name and
power limit as ``nvidia-smi`` reports them, nvcc's version, numpy."""
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


def collect_env_info() -> str:
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
    return "\n".join(lines)
