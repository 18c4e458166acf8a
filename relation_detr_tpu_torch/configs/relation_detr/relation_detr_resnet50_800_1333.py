"""RelationDETR ResNet-50 800x1333 — flagship config of the PyTorch port.

Same values as configs/relation_detr/relation_detr_resnet50_800_1333.py (the
JAX package's); ``build_model`` builds the port's model. Read it with
``relation_detr_tpu_torch.utils.config.Config``.
"""
from relation_detr_tpu_torch.configs import build_detector
from relation_detr_tpu_torch.losses.criterion import CriterionConfig

embed_dim = 256
num_classes = 91
num_queries = 900
hybrid_num_proposals = 1500
hybrid_assign = 6
num_feature_levels = 4
transformer_enc_layers = 6
transformer_dec_layers = 6
num_heads = 8
dim_feedforward = 2048

model_args = dict(
    num_classes=num_classes,
    embed_dim=embed_dim,
    num_queries=num_queries,
    hybrid_num_proposals=hybrid_num_proposals,
    hybrid_assign=hybrid_assign,
    denoising_nums=100,
    num_feature_levels=num_feature_levels,
    num_heads=num_heads,
    dim_feedforward=dim_feedforward,
    transformer_enc_layers=transformer_enc_layers,
    transformer_dec_layers=transformer_dec_layers,
    backbone_arch="resnet50",
)


criterion_args = dict(
    num_classes=num_classes,
    cost_class=2.0,
    cost_bbox=5.0,
    cost_giou=2.0,
    focal_alpha=0.25,
    focal_gamma=2.0,
    weight_class=1.0,
    weight_bbox=5.0,
    weight_giou=2.0,
    class_loss_type="vari_focal",
)


def build_criterion():
    return CriterionConfig(**criterion_args)


def build_model(device="cuda", seed=0, backbone_dtype=None, compute_dtype=None,
                remat_policy=None):
    """The model with weights drawn from ``seed``, in eval mode on ``device``."""
    return build_detector(model_args, device, seed, backbone_dtype, compute_dtype, remat_policy)


# eval-time resize bounds (applied host-side)
min_size = 800
max_size = 1333
select_box_nums_for_evaluation = 300
