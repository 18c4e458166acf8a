"""Training run configuration of the port: the values of the JAX package's
configs/train_config.py and its dataset factories, over the port's COCO
dataset (nvJPEG decode on ``device``, or a caller's ``decode`` on the CPU).
Each factory takes the COCO root (``coco_path`` by default; the train CLI's
``--coco-path`` overrides it). The train preset is ``detr`` and the eval
one ``EvalPreset``, both keeping uint8 pixels that are normalised on the
card. Another preset is picked by config, as in the JAX package: a train
config (``--config-file``) whose ``train_dataset`` passes
``transforms.<name>(normalize_host=False)`` (``data/transforms.py::PRESETS``:
lsj, lsj_1536, strong_album, strong_album_1200_2000, multiscale, ssd,
ssdlite, rtdetr_transform, mosaic_detr) or a ``transforms.Compose`` with the
``data/mix_transforms.py`` transforms, and ``return_masks=True`` for the
mask-based ``SimpleCopyPaste``."""
import os

from relation_detr_tpu_torch.data import transforms
from relation_detr_tpu_torch.data.coco import CocoDetection

num_epochs = 12
batch_size = 2  # per device
num_workers = 4
print_freq = 50
starting_epoch = 0
max_norm = 0.1

output_dir = None  # default: checkpoints/{model_name}

coco_path = "data/coco"


def train_dataset(root=coco_path, device="cuda", decode=None):
    return CocoDetection(
        img_folder=os.path.join(root, "train2017"),
        ann_file=os.path.join(root, "annotations", "instances_train2017.json"),
        transforms=transforms.detr(normalize_host=False),
        train=True,
        device=device,
        decode=decode,
    )


def test_dataset(root=coco_path, device="cuda", decode=None, min_size=800, max_size=1333):
    return CocoDetection(
        img_folder=os.path.join(root, "val2017"),
        ann_file=test_ann_file(root),
        transforms=transforms.EvalPreset(min_size, max_size, normalize_host=False),
        device=device,
        decode=decode,
    )


def test_ann_file(root=coco_path):
    return os.path.join(root, "annotations", "instances_val2017.json")


model_path = "relation_detr_tpu_torch/configs/relation_detr/relation_detr_resnet50_800_1333.py"

resume_from_checkpoint = None

learning_rate = 1e-4
weight_decay = 1e-4
betas = (0.9, 0.999)
lr_milestones = (10,)  # epochs
lr_gamma = 0.1
