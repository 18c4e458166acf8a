"""Python-file configs: ``Config(path)`` runs a config file and exposes its
globals as attributes. The port's own copy of
``relation_detr_tpu/utils/config.py::Config`` (the port imports nothing of
the JAX package); ``partials`` is accepted and ignored, as there."""
from __future__ import annotations

import importlib.util
import os
import sys
import uuid
from typing import Optional, Sequence


class Config:
    def __init__(self, file_path: str, partials: Optional[Sequence[str]] = None):
        file_path = os.path.abspath(file_path)
        if not os.path.isfile(file_path):
            raise FileNotFoundError(file_path)
        module_name = f"_rdetr_config_{uuid.uuid4().hex[:8]}"
        spec = importlib.util.spec_from_file_location(module_name, file_path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        try:
            spec.loader.exec_module(module)
        finally:
            sys.modules.pop(module_name, None)
        self._file_path = file_path
        for key, value in vars(module).items():
            if not key.startswith("__"):
                setattr(self, key, value)

    def get(self, key, default=None):
        return getattr(self, key, default)

    def __repr__(self):
        return f"Config({self._file_path})"
