"""Ops of the port: box math, MSDA, the relation bias and the DCN's bilinear
sampler (CUDA kernels with their plain PyTorch versions)."""
