"""Ops of the port: box math, MSDA and the relation bias (CUDA kernels
with their plain PyTorch versions)."""
