"""DN-Def-DETR++ ResNet-50: single-stage DN-DETR with the relation bias
(learned queries and anchors, no encoder outputs, DN denoising with an
indicator channel, 5 groups) — PyTorch port.

Same values as configs/dn_def_detr_pp/dn_def_detr_pp_resnet50_800_1333.py
(the JAX package's); ``build_model`` builds the port's model. Read it with
``relation_detr_tpu_torch.utils.config.Config``.
"""
from relation_detr_tpu_torch.configs import build_detector
from relation_detr_tpu_torch.losses.criterion import CriterionConfig

num_classes = 91
num_queries = 300

model_args = dict(
    num_classes=num_classes,
    num_queries=num_queries,
    query_source="learned_anchor",
    encoder_memory_fusion=False,
    decoder_use_relation=True,
    with_hybrid=False,
    denoising="dn",
    dn_groups=5,
    backbone_arch="resnet50",
)

criterion_args = dict(num_classes=num_classes, class_loss_type="focal")


def build_criterion():
    return CriterionConfig(**criterion_args)


def build_model(device="cuda", seed=0, backbone_dtype=None, compute_dtype=None,
                remat_policy=None):
    """The model with weights drawn from ``seed``, in eval mode on ``device``."""
    return build_detector(model_args, device, seed, backbone_dtype, compute_dtype, remat_policy)


min_size = 800
max_size = 1333
select_box_nums_for_evaluation = 300
