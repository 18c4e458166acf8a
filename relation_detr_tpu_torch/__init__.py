"""relation_detr_tpu_torch: the PyTorch/CUDA port of relation_detr_tpu.

The JAX package ``relation_detr_tpu`` is the reference; this package keeps
its module layout and names so each counterpart is easy to find, and runs
the RelationDETR-R50 eval forward and train step on an NVIDIA H100. The
kernels are hand-written CUDA C++ (``csrc/``), built with ``nvcc`` at first
use (``_build.py``); on CPU tensors every kernel wrapper takes its plain
PyTorch version instead.

This package imports ``torch`` and never ``jax`` or ``flax``.
"""

__version__ = "0.1.0"
