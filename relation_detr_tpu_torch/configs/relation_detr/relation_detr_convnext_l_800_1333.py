"""RelationDETR ConvNeXt-L 800x1333 — PyTorch port.

Same values as configs/relation_detr/relation_detr_convnext_l_800_1333.py (the JAX package's);
``build_model`` builds the port's model. Read it with
``relation_detr_tpu_torch.utils.config.Config``.
"""
from relation_detr_tpu_torch.configs import build_detector
from relation_detr_tpu_torch.losses.criterion import CriterionConfig

num_classes = 91
hybrid_assign = 6

model_args = dict(
    num_classes=num_classes,
    num_queries=900,
    hybrid_num_proposals=1500,
    denoising_nums=100,
    backbone_arch="convnext_large",
)

criterion_args = dict(num_classes=num_classes, class_loss_type="vari_focal")


def build_criterion():
    return CriterionConfig(**criterion_args)


def build_model(device="cuda", seed=0, backbone_dtype=None, compute_dtype=None,
                remat_policy=None):
    """The model with weights drawn from ``seed``, in eval mode on ``device``.
    The backbone stays fp32 under ``backbone_dtype``, as in JAX."""
    return build_detector(model_args, device, seed, backbone_dtype, compute_dtype, remat_policy)


# eval-time resize bounds (applied host-side)
min_size = 800
max_size = 1333
select_box_nums_for_evaluation = 300
