"""Relation-DETR ResNet-50 for SA-Det-100k — PyTorch port. Class-agnostic:
every category is one foreground class (id 1); pair it with
``CocoDetection(class_agnostic=True)``.

Same values as configs/relation_detr/relation_detr_resnet50_sa_det_100k.py
(the JAX package's); ``build_model`` builds the port's model. Read it with
``relation_detr_tpu_torch.utils.config.Config``.
"""
from relation_detr_tpu_torch.configs import build_detector
from relation_detr_tpu_torch.losses.criterion import CriterionConfig

num_classes = 2  # background slot + the single agnostic class (id 1)
hybrid_assign = 6

model_args = dict(
    num_classes=num_classes,
    num_queries=900,
    hybrid_num_proposals=1500,
    denoising_nums=100,
    backbone_arch="resnet50",
)

criterion_args = dict(num_classes=num_classes, class_loss_type="vari_focal")


def build_criterion():
    return CriterionConfig(**criterion_args)


def build_model(device="cuda", seed=0, backbone_dtype=None, compute_dtype=None,
                remat_policy=None):
    """The model with weights drawn from ``seed``, in eval mode on ``device``."""
    return build_detector(model_args, device, seed, backbone_dtype, compute_dtype, remat_policy)


min_size = 800
max_size = 1333
select_box_nums_for_evaluation = 300
