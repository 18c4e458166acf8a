"""Tiny RelationDETR for smoke tests (shallow stack, few queries) — PyTorch
port. Same values as configs/relation_detr/relation_detr_resnet50_tiny_test.py
(the JAX package's); ``build_model`` builds the port's model."""
from relation_detr_tpu_torch.configs import build_detector
from relation_detr_tpu_torch.losses.criterion import CriterionConfig

num_classes = 4  # synthetic: ids 1..3 + 0
hybrid_assign = 6

model_args = dict(
    num_classes=num_classes,
    num_queries=60,
    hybrid_num_proposals=90,
    denoising_nums=5,
    transformer_enc_layers=1,
    transformer_dec_layers=2,
    backbone_arch="resnet18",
)


criterion_args = dict(num_classes=num_classes)


def build_criterion():
    return CriterionConfig(**criterion_args)


def build_model(device="cuda", seed=0, backbone_dtype=None, compute_dtype=None,
                remat_policy=None):
    """The model with weights drawn from ``seed``, in eval mode on ``device``."""
    return build_detector(model_args, device, seed, backbone_dtype, compute_dtype, remat_policy)


min_size = 224
max_size = 320
select_box_nums_for_evaluation = 30
