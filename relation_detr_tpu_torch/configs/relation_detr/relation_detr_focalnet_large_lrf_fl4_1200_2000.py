"""RelationDETR FocalNet-L (lrf, fl4) 1200x2000 (63.5 AP test-dev config) —
PyTorch port.

Same values as
configs/relation_detr/relation_detr_focalnet_large_lrf_fl4_1200_2000.py (the
JAX package's: the 800x1333 config's model at larger eval bounds);
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
    backbone_arch="focalnet_large_lrf_fl4",
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
min_size = 1200
max_size = 2000
select_box_nums_for_evaluation = 300
