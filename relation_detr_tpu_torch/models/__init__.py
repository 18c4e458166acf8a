"""Modules of the port (PyTorch counterparts of relation_detr_tpu.models)."""
