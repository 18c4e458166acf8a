"""Model configs of the port: Python files read with
``relation_detr_tpu_torch.utils.config.Config``."""


def build_detector(model_args, device="cuda", seed=0, backbone_dtype=None, compute_dtype=None,
                   remat_policy=None):
    """A config's ``RelationDETR(**model_args)`` with weights drawn from
    ``seed``, in eval mode on ``device``; ``backbone_dtype`` /
    ``compute_dtype`` ("bfloat16": the bf16 policy) and ``remat_policy`` as
    ``RelationDETR`` takes them."""
    import torch

    from relation_detr_tpu_torch.models.detector import RelationDETR

    model = RelationDETR(**model_args, backbone_dtype=backbone_dtype,
                         compute_dtype=compute_dtype, remat_policy=remat_policy,
                         generator=torch.Generator().manual_seed(seed))
    return model.to(device).eval()
