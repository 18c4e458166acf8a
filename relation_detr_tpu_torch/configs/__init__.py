"""Model configs of the port: Python files read with
``relation_detr_tpu_torch.utils.config.Config``."""
