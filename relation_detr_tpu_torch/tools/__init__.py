"""Command-line tools of the port, counterparts of the root ``tools/``:
``python -m relation_detr_tpu_torch.tools.<name> --help``."""
