"""Tiny RelationDETR for smoke tests (shallow stack, few queries) — PyTorch
port. Same values as configs/relation_detr/relation_detr_resnet50_tiny_test.py
(the JAX package's); ``build_model`` builds the port's model."""
import torch

from relation_detr_tpu_torch.losses.criterion import CriterionConfig
from relation_detr_tpu_torch.models.detector import RelationDETR

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
    """The model with weights drawn from ``seed``, in eval mode on ``device``;
    ``backbone_dtype`` / ``compute_dtype`` ("bfloat16": the bf16 policy) and
    ``remat_policy`` as ``RelationDETR`` takes them."""
    model = RelationDETR(**model_args, backbone_dtype=backbone_dtype,
                         compute_dtype=compute_dtype, remat_policy=remat_policy,
                         generator=torch.Generator().manual_seed(seed))
    return model.to(device).eval()


min_size = 224
max_size = 320
select_box_nums_for_evaluation = 30
