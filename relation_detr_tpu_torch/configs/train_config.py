"""Training run hyperparameters of the port: the values of the JAX
package's configs/train_config.py, without its dataset factories (the
COCO loader needs cv2, which the port's path does not import yet; the
train.py CLI is ROADMAP Queue 1 item 8)."""
num_epochs = 12
batch_size = 2  # per device
max_norm = 0.1

model_path = "relation_detr_tpu_torch/configs/relation_detr/relation_detr_resnet50_800_1333.py"

learning_rate = 1e-4
weight_decay = 1e-4
betas = (0.9, 0.999)
lr_milestones = (10,)  # epochs
lr_gamma = 0.1
