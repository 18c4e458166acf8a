"""The port (eval forward and train step, gather and tiled MSDA, the
evaluation path, the train CLI) runs without jax, flax, cv2, PIL or the JAX
package, and its kernel wrappers launch nothing on CPU tensors and raise
(never fall back) on CUDA tensors they cannot serve. This file imports no jax so that
it also runs on a machine with a card and no jax (the conftest imports jax,
so skip it there):
``python -m pytest --noconftest tests/test_torch_no_jax.py``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from msda_inputs import (REL_CASES, SEP_CASES, TILED_FWD_CASES, V4_CASES, close_where_finite,
                         encoder_like, relation_boxes, relation_rel, scattered, sep_operands,
                         tiled_fwd_operands)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import tempfile
import numpy as np
import torch
import relation_detr_tpu_torch
import relation_detr_tpu_torch.inference as inference
from relation_detr_tpu_torch.configs import train_config
from relation_detr_tpu_torch.ops import grid_sample, msda, msda_tiled, relation_bias
from relation_detr_tpu_torch.ops.patch_scatter import window_accumulate
from relation_detr_tpu_torch.parallel import mesh
from relation_detr_tpu_torch.parallel.train_step import make_train_step
from relation_detr_tpu_torch.utils.config import Config
from relation_detr_tpu_torch.utils.param_groups import build_optimizer

torch.set_num_threads(1)  # beside other test processes, one thread is the quickest
cfgs = [Config("relation_detr_tpu_torch/configs/relation_detr/" + name) for name in
        ("relation_detr_resnet50_800_1333.py", "relation_detr_resnet50_tiny_test.py")]
# the model families' and SA-Det's configs
family_cfgs = [Config("relation_detr_tpu_torch/configs/" + name) for name in (
    "dino_pp/dino_pp_resnet50_800_1333.py",
    "deformable_detr_pp/def_detr_pp_resnet50_800_1333.py",
    "dn_def_detr_pp/dn_def_detr_pp_resnet50_800_1333.py",
    "dab_def_detr_pp/dab_def_detr_pp_resnet50_800_1333.py",
    "relation_detr/relation_detr_resnet50_sa_det_100k.py")]
rng = np.random.RandomState(0)
images = rng.randn(1, 128, 160, 3).astype(np.float32)
mask = np.zeros((1, 128, 160), bool)
mask[:, 96:] = True
batch = {"images": torch.from_numpy(images), "mask": torch.from_numpy(mask),
         "gt_labels": torch.tensor([[1, 2, 0]]),
         "gt_boxes": torch.tensor([[[0.3, 0.4, 0.2, 0.3], [0.6, 0.5, 0.3, 0.2],
                                    [0.0, 0.0, 0.0, 0.0]]]),
         "gt_valid": torch.tensor([[True, True, False]])}
counters = (msda.multi_scale_deformable_attention, msda.msda_backward,
            relation_bias.relation_bias_v4, relation_bias.fused_relation_bias,
            msda_tiled.tiled_matmul_core, msda_tiled.tiled_core_backward,
            msda_tiled.sep_contract_fused, window_accumulate, grid_sample.bilinear_sample,
            grid_sample.bilinear_sample_backward)


def eval_and_train_step():
    model = cfgs[1].build_model(device="cpu")
    det = inference.detect(model, images, mask, [[96, 160]], 30)
    assert det["boxes"].shape == (1, 30, 4) and bool(torch.isfinite(det["boxes"]).all())
    model.train()
    step = make_train_step(model, cfgs[1].build_criterion(),
                           build_optimizer(model, train_config.learning_rate),
                           cfgs[1].hybrid_assign)
    metrics = step(batch)
    assert np.isfinite(metrics["total_loss"]) and metrics["nonfinite_count"] == 0, metrics


def tiny_dn_family():
    # DN-Def-DETR++ (single-stage, DN queries) at a tiny size: eval, train step
    from relation_detr_tpu_torch.configs import build_detector

    dn = family_cfgs[2]
    model = build_detector(dict(dn.model_args, backbone_arch="resnet18", num_queries=30,
                                transformer_enc_layers=1, transformer_dec_layers=2),
                           device="cpu")
    det = inference.detect(model, images, mask, [[96, 160]], 30)
    assert det["boxes"].shape == (1, 30, 4) and bool(torch.isfinite(det["boxes"]).all())
    model.train()
    step = make_train_step(model, dn.build_criterion(),
                           build_optimizer(model, train_config.learning_rate))
    metrics = step(batch)
    assert np.isfinite(metrics["total_loss"]) and "loss_class_dn" in metrics, metrics
    assert not any(k.endswith(("_enc", "_hybrid")) for k in metrics), metrics


def tiny_backbones():
    # the Swin (v1, v2), ConvNeXt and FocalNet (every flag on) modules at a
    # tiny size, each in a tiny detector: eval, and a train step (Swin v1)
    from relation_detr_tpu_torch.configs import build_detector
    from relation_detr_tpu_torch.models.backbones import convnext, focalnet, swin

    swin.ARCH_SETTINGS["swin_no_jax"] = (16, (2, 2, 2, 2), (2, 2, 4, 8), 7, False)
    swin.ARCH_SETTINGS["swin_v2_no_jax"] = (16, (2, 2, 2, 2), (2, 2, 4, 8), 8, True)
    convnext.ARCH_SETTINGS["convnext_no_jax"] = ((8, 16, 32, 64), (1, 1, 2, 1))
    focalnet.ARCH_SETTINGS["focalnet_no_jax"] = (16, (1, 1, 1, 1), (4,) * 4, (3,) * 4,
                                                 True, True, True, True)
    tiny = cfgs[1]
    for arch in ("swin_no_jax", "swin_v2_no_jax", "convnext_no_jax", "focalnet_no_jax"):
        model = build_detector(dict(tiny.model_args, backbone_arch=arch), device="cpu")
        det = inference.detect(model, images, mask, [[96, 160]], 30)
        assert det["boxes"].shape == (1, 30, 4) and bool(torch.isfinite(det["boxes"]).all())
    model = build_detector(dict(tiny.model_args, backbone_arch="swin_no_jax"), device="cpu")
    model.train()
    step = make_train_step(model, tiny.build_criterion(),
                           build_optimizer(model, train_config.learning_rate), tiny.hybrid_assign)
    metrics = step(batch)
    assert np.isfinite(metrics["total_loss"]) and metrics["nonfinite_count"] == 0, metrics


def vit_dcn_and_bricks():
    # tiny ViT and EVA-02 (RoPE, SwiGLU, padded windows) detectors and the
    # DCN ResNet-18 one: eval, and a train step on EVA and on the DCN (its
    # offsets get gradients); NMS in post_process, the segmentation decode,
    # the learned position embedding, SE, ContextBlock, the registry
    from relation_detr_tpu_torch.configs import build_detector
    from relation_detr_tpu_torch.models import layers, post_process
    from relation_detr_tpu_torch.models.backbones import vit
    from relation_detr_tpu_torch.models.position_encoding import PositionEmbeddingLearned
    from relation_detr_tpu_torch.utils import weight_registry

    for arch, extra in (("vit", {}), ("eva_02_vit", dict(rope=True, swiglu=True))):
        vit.ARCH_SETTINGS[arch + "_no_jax"] = dict(
            dict(dim=32, depth=2, num_heads=2, mlp_dim=48, global_idx=(1,), rope=False,
                 swiglu=False, window_size=4), **extra)
    tiny = cfgs[1]
    dcn = dict(backbone_arch="resnet18", backbone_stage_with_dcn=(False, True, True, True))
    for args in (dict(backbone_arch="vit_no_jax"), dict(backbone_arch="eva_02_vit_no_jax"), dcn):
        model = build_detector(dict(tiny.model_args, **args), device="cpu")
        det = inference.detect(model, images, mask, [[96, 160]], 30)
        assert det["boxes"].shape == (1, 30, 4) and bool(torch.isfinite(det["boxes"]).all())
    for args in (dict(backbone_arch="eva_02_vit_no_jax"), dcn):
        model = build_detector(dict(tiny.model_args, **args), device="cpu").train()
        step = make_train_step(model, tiny.build_criterion(),
                               build_optimizer(model, train_config.learning_rate),
                               tiny.hybrid_assign)
        metrics = step(batch)
        assert np.isfinite(metrics["total_loss"]) and metrics["nonfinite_count"] == 0, metrics
    logits, boxes = torch.randn(2, 30, 4), torch.rand(2, 30, 4) * 0.5 + 0.25
    out = post_process.post_process(logits, boxes, torch.tensor([[96.0, 160.0]] * 2), 30,
                                     nms_iou_threshold=0.5)
    assert 0 < int(out["valid"].sum()) < 60
    seg = post_process.segmentation_post_process(logits, torch.randn(2, 30, 8, 8), (12, 6))
    assert seg.shape == (2, 12, 6)
    assert PositionEmbeddingLearned(4, 8)(torch.zeros(1, 6, 3, dtype=torch.bool)).shape == \
        (1, 6, 3, 16)
    x = torch.randn(1, 5, 6, 32)
    assert layers.SqueezeExcitation(32)(x).shape == x.shape
    assert layers.ContextBlock(32, fusion_types=("channel_mul", "channel_add"))(x).shape == x.shape
    assert weight_registry.lookup_url("resnet50").endswith(".pth")


def evaluation_stream():
    # collate, the eval stream and the evaluator on numpy images (uint8,
    # EvalPreset(normalize_host=False)) with a tiny annotations JSON
    import json
    import tempfile

    from relation_detr_tpu_torch import test as port_test  # noqa: F401
    from relation_detr_tpu_torch.data import coco, image_io, loader
    from relation_detr_tpu_torch.data.transforms import EvalPreset
    from relation_detr_tpu_torch.utils import evaluation, logging
    from relation_detr_tpu_torch.utils.coco_eval import CocoEvaluator

    sizes = [(60, 90), (80, 70), (50, 50)]
    preset = EvalPreset(64, 96, normalize_host=False)
    samples = [preset({"image": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                       "boxes": np.array([[5, 5, 30, 40]], np.float32),
                       "labels": np.array([1 + i % 2]), "image_id": i + 1,
                       "orig_size": np.asarray([h, w])}) for i, (h, w) in enumerate(sizes)]
    batch = loader.collate(samples[:2], buckets=((96, 96), (128, 128)))
    assert batch["images"].dtype == np.uint8 and batch["images"].shape == (2, 96, 96, 3)
    ann = {"images": [{"id": i + 1, "height": h, "width": w, "file_name": f"{i}.jpg"}
                      for i, (h, w) in enumerate(sizes)],
           "annotations": [{"id": i + 1, "image_id": i + 1, "category_id": 1 + i % 2,
                            "bbox": [5, 5, 25, 35], "area": 875, "iscrowd": 0}
                           for i in range(len(sizes))],
           "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}
    with tempfile.TemporaryDirectory() as tmp:
        ann_file = tmp + "/instances.json"
        with open(ann_file, "w") as f:
            json.dump(ann, f)
        with open(tmp + "/0.jpg", "wb") as f:
            f.write(b"\xff\xd8\xff\xd9")
        try:
            coco.CocoDetection(tmp, ann_file, device="cpu")[0]
            raise AssertionError("CocoDetection decoded on the CPU without decode=")
        except RuntimeError as exc:
            assert "no JPEG decoder" in str(exc), exc
        dl = loader.DataLoader(samples, batch_size=2, buckets=((96, 96), (128, 128)))
        det_fn = evaluation.make_detections_fn(cfgs[1].build_model(device="cpu"), 30)
        evaluator = CocoEvaluator(ann_file)
        metric = logging.MetricLogger(print_freq=1)
        for b, det in evaluation.detection_stream(det_fn, dl, "cpu",
                                                  progress=lambda it: metric.log_every(it)):
            assert det.shape == (2, 30, 6) and np.isfinite(det).all()
            evaluation.accumulate_batch(evaluator, b, det)
        stats = evaluator.accumulate_and_summarize(verbose=False)
    assert len(stats) == 12 and all(np.isfinite(v) for v in stats.values()), stats
    assert image_io.exif_orientation(np.zeros(4, np.uint8)) == 1


def data_path():
    # the train presets, the mix transforms, masks and the PNG decode: a
    # sample through mosaic_detr, strong_album and the mask copy-paste (a
    # split of .npy bytes: no JPEG decoder on the CPU), the PNG fixtures
    import io
    import json
    import os
    import random

    from relation_detr_tpu_torch.data import cv_ops, image_io, mix_transforms, transforms
    from relation_detr_tpu_torch.data.coco import CocoDetection, Object365Detection

    with tempfile.TemporaryDirectory() as tmp:
        images, anns = [], []
        for i, (h, w) in enumerate([(90, 120), (100, 80), (70, 110)]):
            with open(f"{tmp}/{i}.jpg", "wb") as f:
                np.save(f, rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            images.append({"id": i + 1, "height": h, "width": w, "file_name": f"{i}.jpg"})
            anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1, "iscrowd": 0,
                         "bbox": [10, 10, 40, 30], "area": 1200,
                         "segmentation": [[12, 12, 48, 14, 30, 38]]})
        with open(f"{tmp}/ann.json", "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": 1, "name": "a"}]}, f)

        def decode(data):
            return np.load(io.BytesIO(data.tobytes()))

        for name in ("mosaic_detr", "strong_album"):
            preset = transforms.PRESETS[name](normalize_host=False)
            ds = CocoDetection(tmp, f"{tmp}/ann.json", preset, train=True, device="cpu",
                               decode=decode)
            out = ds.read(0, random.Random(5))
            assert out["image"].dtype == np.uint8 and out["boxes"].shape[1] == 4, name
        ds = Object365Detection(tmp, f"{tmp}/ann.json", transforms.Compose(
            transforms.mosaic_detr(normalize_host=False), mix_transforms.SimpleCopyPaste(p=1.0)),
            train=True, return_masks=True, device="cpu", decode=decode)
        out = ds.read(1, random.Random(2))
        assert len(out["masks"]) == len(out["boxes"]) > 0
    png = os.path.join("tests", "data", "torch_port", "png", "filters.png")
    np.testing.assert_array_equal(image_io.read_image(png, device="cpu"),
                                  np.load(png[:-4] + ".npy"))
    assert cv_ops.jpeg_roundtrip(np.full((9, 17, 3), 77, np.uint8), 90).shape == (9, 17, 3)


def tools_and_drawing():
    # the op binding, the FLOP formulas, the drawing, the writers and every
    # tool module: imported, and a box drawn and encoded both ways
    from relation_detr_tpu_torch.data import image_io
    from relation_detr_tpu_torch.ops import library  # noqa: F401
    from relation_detr_tpu_torch.tools import (  # noqa: F401
        benchmark_model, convert_torch_weights, export_model, make_synth_coco_scale,
        mc_distribution, visualize_datasets)
    from relation_detr_tpu_torch.utils import flops, visualize  # noqa: F401

    img = visualize.plot_bounding_boxes_on_image(
        np.zeros((40, 60, 3), np.uint8), np.array([[5.0, 12.0, 40.0, 30.0]]),
        np.array([0.9]), np.array([1]), ["a", "b"])
    assert image_io.encode_jpeg(img)[:2] == b"\xff\xd8"
    assert image_io.encode_png(img)[:4] == b"\x89PNG"


def clamp_gate_and_settings():
    # the clamp gate (utils/clamp_check.py) on the tiny model, forced and
    # under a tiled impl, and its fast-profile selection; the tiny eval
    # under each group of the JAX package's tiled settings
    from relation_detr_tpu_torch.utils import clamp_check

    model = cfgs[1].build_model(device="cpu")
    with msda.msda_defaults(impl="tiled_xla", tiled_halos=(0, 0, 0, 0), tiled_overflow=0):
        found = clamp_check.check_checkpoint_clamp(model, images, mask, threshold=1.0)
        assert found is not None and found["worst"] > 0.0, found
    with msda.msda_defaults():
        assert clamp_check.check_and_select_profile(model, images, mask, force=True)[
            "profile"] in ("exact", "fast")
    assert clamp_check.check_checkpoint_clamp(model, images, mask) is None  # the gather
    for settings in (dict(impl="tiled", tiled_halos=(1, 1, 0, 0), tiled_overflow=8),
                     dict(impl="tiled_xla", tiled_layout="t_major", tiled_tile_tokens=(24, 8)),
                     dict(impl="tiled_xla", tiled_slab_order="bm", tiled_patch_mode="gather",
                          tiled_margin=2),
                     dict(impl="tiled_xla", tiled_dtype=torch.bfloat16, tiled_dot_bf16=True,
                          tiled_sep_kernel=True, gather_dtype=torch.bfloat16),
                     dict(impl="tiled_xla", tiled_int8_slab=True, tiled_slab_order="xy"),
                     dict(impl="auto_pallas", decoder_prepack=False, dense_level_rows=10)):
        with msda.msda_defaults(**settings):
            det = inference.detect(model, images, mask, [[96, 160]], 30)
        assert bool(torch.isfinite(det["boxes"]).all()), settings


tools_and_drawing()
data_path()
clamp_gate_and_settings()
eval_and_train_step()
# a gloo group of one process (parallel/mesh.py): no collective runs
with tempfile.TemporaryDirectory() as tmp:
    mesh.init_distributed("gloo", "cpu", init_method=f"file://{tmp}/rendezvous", rank=0,
                          world_size=1, timeout_s=60)
    try:
        assert mesh.world() == (0, 1) and mesh.is_main() and not mesh.active()
        assert len(mesh.all_gather_array(np.ones((2, 7)))) == 1
        eval_and_train_step()
    finally:
        mesh.destroy()
tiny_dn_family()
tiny_backbones()
vit_dcn_and_bricks()
evaluation_stream()
relation_bias.set_fused_relation(version=1)
with msda.msda_defaults(impl="tiled"):
    eval_and_train_step()
launches = [fn.launches for fn in counters]
assert launches == [0] * len(counters), f"CPU run launched a kernel: {launches}"
loaded = [m for m in sys.modules if m in ("jax", "flax", "cv2", "PIL", "matplotlib")
          or m == "relation_detr_tpu"
          or m.startswith(("jax.", "flax.", "PIL.", "matplotlib.", "relation_detr_tpu."))]
assert not loaded, loaded
print("ok")
"""


TRAIN_SCRIPT = r"""
import sys
import numpy as np
import torch
from relation_detr_tpu_torch.ops import msda, relation_bias

torch.set_num_threads(1)  # beside other test processes, one thread is the quickest
rng = np.random.RandomState(0)


def train_cli():
    # the train CLI on the CPU over 3 images stored as .npy bytes (no JPEG
    # decoder without cv2), with accumulation, an EMA, an evaluation, a
    # checkpoint, a resume and the weight files' class names
    import io
    import json
    import os
    import tempfile

    from relation_detr_tpu_torch import train
    from relation_detr_tpu_torch.utils import overfit  # noqa: F401 (chip_smoke's overfit case)
    from relation_detr_tpu_torch.utils.class_names import load_class_names

    def decode(data):
        return np.load(io.BytesIO(data.tobytes()))

    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(tmp + "/coco/annotations")
        images, anns = [], []
        for i, (h, w) in enumerate([(90, 120), (100, 80), (70, 110)]):
            os.makedirs(tmp + "/coco/train2017", exist_ok=True)
            with open(tmp + f"/coco/train2017/{i}.jpg", "wb") as f:
                np.save(f, rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            images.append({"id": i + 1, "height": h, "width": w, "file_name": f"{i}.jpg"})
            anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1 + i % 3,
                         "bbox": [10, 10, 40, 30], "area": 1200, "iscrowd": 0})
        split = {"images": images, "annotations": anns,
                 "categories": [{"id": c, "name": f"c{c}"} for c in (1, 2, 3)]}
        for name in ("train2017", "val2017"):
            with open(tmp + f"/coco/annotations/instances_{name}.json", "w") as f:
                json.dump(split, f)
        os.symlink(tmp + "/coco/train2017", tmp + "/coco/val2017")
        with open(tmp + "/cfg.py", "w") as f:
            f.write("from relation_detr_tpu_torch.configs.train_config import *\n"
                    "class_names = ('a', 'b', 'c')\n"
                    "eval_buckets = ((224, 320), (320, 224), (320, 320))\n")
        args = ["--config-file", tmp + "/cfg.py",
                "--model-config", "relation_detr_tpu_torch/configs/relation_detr/"
                "relation_detr_resnet50_tiny_test.py", "--coco-path", tmp + "/coco",
                "--batch-size", "1", "--canvas", "128,160", "--accumulate-steps", "2",
                "--ema-decay", "0.9", "--eval-every-epochs", "1", "--device", "cpu"]
        first = train.main(args + ["--num-epochs", "1", "--output-dir", tmp + "/a"], decode=decode)
        assert len(first["steps"]) == 3 and len(first["lrs"]) == 1, first
        again = train.main(args + ["--num-epochs", "2", "--output-dir", tmp + "/b",
                                   "--resume", tmp + "/a"], decode=decode)
        assert len(again["steps"]) == 3 and len(again["evals"]) == 1
        assert np.isfinite(again["metrics"]["total_loss"])
        assert load_class_names(again["paths"]["latest_ema"]) == ("a", "b", "c")
        # the bf16 policy with the dots remat policy, evaluated too
        bf16 = train.main(args + ["--num-epochs", "1", "--output-dir", tmp + "/c",
                                  "--mixed-precision", "bf16", "--remat-policy", "dots"],
                          decode=decode)
        assert len(bf16["steps"]) == 3 and len(bf16["evals"]) == 1
        assert np.isfinite(bf16["metrics"]["total_loss"])
        # the clamp gate in the three CLIs, on the weights of the first run
        from relation_detr_tpu_torch import inference, test
        from relation_detr_tpu_torch.utils import clamp_check

        weights = first["paths"]["latest"]
        with msda.msda_defaults():
            # forced under the gather (the CPU's cheapest form; the tiled
            # forms run in clamp_gate_and_settings of the other script)
            tuned = train.main(args + ["--num-epochs", "1", "--output-dir", tmp + "/d",
                                       "--resume", weights, "--max-steps", "1",
                                       "--eval-every-epochs", "0", "--clamp-check", "on"],
                               decode=decode)
            assert np.isfinite(tuned["metrics"]["total_loss"])
            assert tuned["clamp"]["fractions"]
        with msda.msda_defaults():
            evaluated = test.main(["--coco-path", tmp + "/coco", "--model-config", args[3],
                                   "--checkpoint", weights, "--device", "cpu", "--max-images",
                                   "1", "--msda-profile", "fast", "--clamp-check", "on",
                                   "--clamp-threshold", "1"], decode=decode)
            assert evaluated["clamp"]["fractions"] and evaluated["images"] == 1
        os.makedirs(tmp + "/one")  # the folder CLI's 800x1344 canvas: one image
        os.symlink(tmp + "/coco/train2017/0.jpg", tmp + "/one/0.jpg")
        found = inference.main(["--image-dir", tmp + "/one", "--model-config", args[3],
                                "--checkpoint", weights, "--device", "cpu", "--clamp-check",
                                "on"], decode=decode)
        assert found["clamp"] is not None and len(found["detections"]) == 1


train_cli()
launches = [fn.launches for fn in (msda.multi_scale_deformable_attention, msda.msda_backward,
                                   relation_bias.relation_bias_v4)]
assert launches == [0, 0, 0], f"CPU run launched a kernel: {launches}"
loaded = [m for m in sys.modules if m in ("jax", "flax", "cv2", "PIL") or m == "relation_detr_tpu"
          or m.startswith(("jax.", "flax.", "PIL.", "relation_detr_tpu."))]
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_runs_without_jax_flax_cv2():
    """The tiny config's eval and train step on CPU, as they are, in a gloo
    group of one process (``parallel/mesh.py``) and under
    impl="tiled" with relation version 1; tiny detectors on the Swin (v1,
    v2), ConvNeXt, FocalNet, ViT, EVA-02 and DCN ResNet backbones; NMS, the
    segmentation decode and the other bricks; the clamp gate
    (``utils/clamp_check.py``) and the eval forward under each group of the
    JAX package's tiled settings; the evaluation path (collate,
    the loader, the detections function and stream, the evaluator, the CLI
    module); the data path's modules (a sample read through mosaic_detr,
    strong_album and the mask copy-paste, a PNG decode, the JPEG round
    trip); the op binding, the FLOP formulas, the drawing, the image
    writers and every module of ``relation_detr_tpu_torch/tools``: no kernel
    launch, and nothing of jax, flax, cv2, PIL, matplotlib or
    relation_detr_tpu imported."""
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_train_cli_runs_without_jax_flax_cv2():
    """The train CLI on the CPU (the detr preset, the loader's per-sample
    generators, device_prefetch, accumulation, the EMA, an evaluation,
    checkpoints, a resume, the weight files with class names; then an epoch
    under ``--mixed-precision bf16 --remat-policy dots``; then the clamp gate
    of the train, eval and folder CLIs on the first run's weights) over 3
    images stored as .npy: no kernel launch, and nothing of jax, flax, cv2,
    PIL or relation_detr_tpu imported."""
    proc = subprocess.run([sys.executable, "-c", TRAIN_SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,heads", [(2, 4), (1, 8), (3, 16)])
def test_kernels_match_plain_versions_on_card(batch, heads):
    """Both kernels against their plain versions on the card at small
    shapes, B > 1 and every head count the relation kernel instantiates
    (the flagship shapes are chip_smoke.py's phase 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.ops import msda, relation_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(heads)
    shapes = ((9, 11), (5, 6), (3, 3))
    total = sum(h * w for h, w in shapes)
    value = torch.randn(batch, total, heads, 16, generator=gen, device=dev)
    locs = torch.rand(batch, 37, heads, 3, 4, 2, generator=gen, device=dev) * 1.4 - 0.2
    attn = torch.rand(batch, 37, heads, 3, 4, generator=gen, device=dev)
    with torch.no_grad():
        got = msda.multi_scale_deformable_attention(value, shapes, locs, attn)
        want = msda.msda_reference(value, shapes, locs, attn)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

    boxes = torch.rand(batch, 45, 4, generator=gen, device=dev) * 0.9 + 0.01
    kernel = torch.randn(64, heads, generator=gen, device=dev) * 0.1
    bias = torch.randn(heads, generator=gen, device=dev) * 0.1
    tgt = boxes[:, 5:].contiguous()
    with torch.no_grad():
        got = relation_bias.relation_bias_v4(boxes, tgt, kernel, bias)
        want = relation_bias.relation_bias_v4_reference(boxes, tgt, kernel, bias)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,heads,head_dim", [(2, 4, 32), (1, 8, 16), (3, 2, 8)])
def test_backward_kernels_match_plain_versions_on_card(batch, heads, head_dim):
    """msda_bwd against autograd through the plain MSDA (locations past
    every border, on them, and on pixel centres, where the location
    gradient has a kink), the relation Function's gradients against
    the plain version's, and window_accumulate against its slice-add loop
    (bit for bit: both add the windows in ascending order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.ops import msda, patch_scatter, relation_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(heads)
    shapes = ((9, 11), (5, 6), (3, 3))
    total = sum(h * w for h, w in shapes)
    value = torch.randn(batch, total, heads, head_dim, generator=gen, device=dev)
    locs = torch.rand(batch, 37, heads, 3, 4, 2, generator=gen, device=dev) * 1.4 - 0.2
    locs[:, ::5, :, :, 1] = 0.0
    locs[:, ::7, :, :, 2] = 1.0
    for lvl, (h, w) in enumerate(shapes):  # on pixel centres, as the encoder's
        for axis, size in ((0, w), (1, h)):  # samples sit at initialisation
            cells = torch.randint(0, size, (batch, 13, heads), generator=gen, device=dev)
            offs = torch.randint(-2, 3, (batch, 13, heads), generator=gen, device=dev)
            locs[:, ::3, :, lvl, 3, axis] = (cells + 0.5) / size + offs.float() / size
    attn = torch.rand(batch, 37, heads, 3, 4, generator=gen, device=dev)
    grad_out = torch.randn(batch, 37, heads * head_dim, generator=gen, device=dev)
    got = msda.msda_backward(value, shapes, locs, attn, grad_out)
    want = msda.msda_backward_reference(value, shapes, locs, attn, grad_out)
    for name, g, w in zip(("value", "locations", "weights"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)

    boxes = torch.rand(batch, 45, 4, generator=gen, device=dev) * 0.9 + 0.01
    kernel = (torch.randn(64, 8, generator=gen, device=dev) * 0.1).requires_grad_(True)
    bias = (torch.randn(8, generator=gen, device=dev) * 0.1).requires_grad_(True)
    tgt = boxes[:, 5:].contiguous()
    cot = torch.randn(batch, 8, 45, 40, generator=gen, device=dev)
    relation_bias.relation_bias_v4(boxes, tgt, kernel, bias).backward(cot)
    dk, db = torch.autograd.grad(
        relation_bias.relation_bias_v4_reference(boxes, tgt, kernel, bias), (kernel, bias), cot)
    torch.testing.assert_close(kernel.grad, dk, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(bias.grad, db, rtol=1e-4, atol=1e-4)

    y0s, x0s = [0, 3, 9, 3], [0, 5, 1, 5]
    g = torch.randn(4, 7, 6, 33, generator=gen, device=dev)
    got = patch_scatter.window_accumulate(g, y0s, x0s, 16, 11)
    want = patch_scatter.window_accumulate_reference(g, y0s, x0s, 16, 11)
    assert torch.equal(got, want)
    # non-grid origins with repeats, float4 channels (C = 32 heads * dims),
    # values of mixed magnitude: bit-identical, and one table build for the
    # geometry however often it runs
    y0s = [int(v) for v in torch.randint(0, 12, (40,), generator=gen, device=dev)]
    x0s = [int(v) for v in torch.randint(0, 9, (40,), generator=gen, device=dev)]
    y0s[5:9], x0s[5:9] = [y0s[4]] * 4, [x0s[4]] * 4
    scale = 10.0 ** torch.randint(-4, 5, (40, 1, 1, 1), generator=gen, device=dev)
    g = torch.randn(40, 5, 4, heads * head_dim, generator=gen, device=dev) * scale
    builds = patch_scatter.window_table.builds
    for _ in range(3):
        got = patch_scatter.window_accumulate(g, y0s, x0s, 16, 12)
        assert torch.equal(got, patch_scatter.window_accumulate_reference(g, y0s, x0s, 16, 12))
    assert patch_scatter.window_table.builds - builds <= 1
    # a table keyed by the band grid, as SlicePatchesFunction's backward asks
    y0u, x0u = (0, 4, 9), (0, 3, 6)
    y0s, x0s = [y for y in y0u for _ in x0u], [x for _ in y0u for x in x0u]
    g = torch.randn(9, 7, 6, heads * head_dim, generator=gen, device=dev)
    builds = patch_scatter.window_table.builds
    for _ in range(3):
        got = patch_scatter.window_accumulate(g, y0s, x0s, 16, 12, grid=(y0u, x0u))
        assert torch.equal(got, patch_scatter.window_accumulate_reference(g, y0s, x0s, 16, 12))
    assert patch_scatter.window_table.builds - builds <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("batch,heads,rel_heads", [(2, 2, 4), (1, 4, 8), (3, 8, 16)])
def test_tiled_and_rel_kernels_match_plain_versions_on_card(batch, heads, rel_heads):
    """tiled_core_fwd, tiled_core_bwd and sep_contract_fwd against their
    plain versions on operands the tiled MSDA builds (encoder samples up to
    6 texels off, so some corners clamp to the patch border), plus entries
    with rows outside the patch; relation_bias_rel_fwd against its plain
    version. Forwards 1e-5 abs; the backward 1e-4 of each gradient's max
    (its own summation order), also with a row that no entry hits and one
    that every entry of an item hits, and bit-identical over two
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.ops import msda_tiled, relation_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(heads)
    shapes = ((36, 32), (18, 16), (9, 8), (5, 4))
    total = sum(h * w for h, w in shapes)
    head_dim = 32 // heads * 2 if heads < 8 else 8
    value = torch.randn(batch, total, heads, head_dim, generator=gen, device=dev)
    refs = torch.cat([torch.stack(torch.meshgrid((torch.arange(w, device=dev) + 0.5) / w,
                                                 (torch.arange(h, device=dev) + 0.5) / h,
                                                 indexing="xy"), -1).reshape(-1, 2)
                      for h, w in shapes])
    size = torch.tensor([(w, h) for h, w in shapes], device=dev, dtype=torch.float32)
    offs = torch.rand(batch, total, heads, 4, 4, 2, generator=gen, device=dev) * 12 - 6
    locs = refs[None, :, None, None, None] + offs / size[:, None]
    attn = torch.rand(batch, total, heads, 4, 4, generator=gen, device=dev)
    consts, levels = msda_tiled.tiled_level_operands(value, shapes, locs, attn)
    for lvl in levels:
        x0i, y0i, fx, fy, at, bx, by = lvl["sample"]
        ph, pw, h, w = lvl["ph"], lvl["pw"], lvl["h"], lvl["w"]
        m, wt = msda_tiled._tiled_entries(x0i, y0i, fx, fy, at, bx, by, ph, pw, h, w)
        m[m == ph * pw // 2] = ph * pw // 2 + 1  # a row no entry hits
        m[..., :3, ::5] = torch.tensor([-1, ph * pw, 10 ** 6], dtype=torch.int32,
                                       device=dev)[:, None]
        m[-1, -1, -1] = ph * pw - 1  # every entry of one item on one row
        patch = lvl["patch"].contiguous()
        dims = (heads, head_dim)
        torch.testing.assert_close(msda_tiled.tiled_matmul_core(m, wt, patch, dims),
                                   msda_tiled.tiled_core_reference(m, wt, patch, dims),
                                   rtol=0, atol=1e-5)
        g = torch.randn(batch, consts["nt"], consts["T"], heads * head_dim, generator=gen,
                        device=dev)
        got = msda_tiled.tiled_core_backward(m, wt, patch, g, dims)
        want = msda_tiled.tiled_core_backward_reference(m, wt, patch, g, dims)
        for name, a, b in zip(("dw", "dpatch"), got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()),
                                       msg=name)
        again = msda_tiled.tiled_core_backward(m, wt, patch, g, dims)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert not bool(got[1][:, :, ph * pw // 2].any())
        oy = msda_tiled._axis_soft(y0i, fy, by, ph, h, at).contiguous()
        ox = msda_tiled._axis_soft(x0i, fx, bx, pw, w, None).contiguous()
        torch.testing.assert_close(msda_tiled.sep_contract_fused(oy, ox, patch),
                                   msda_tiled.sep_contract_reference(oy, ox, patch),
                                   rtol=0, atol=1e-5)

    rel = torch.randn(batch, 45, 40, 4, generator=gen, device=dev)
    kernel = torch.randn(64, rel_heads, generator=gen, device=dev) * 0.1
    bias = torch.randn(rel_heads, generator=gen, device=dev) * 0.1
    with torch.no_grad():
        torch.testing.assert_close(relation_bias.fused_relation_bias(rel, kernel, bias),
                                   relation_bias.fused_relation_bias_reference(rel, kernel, bias),
                                   rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_wrappers_raise_on_cuda_without_library(monkeypatch, tmp_path):
    """On a CUDA tensor a wrapper builds and launches its kernel or raises:
    with no nvcc and no built library it raises, it does not fall back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch import _build
    from relation_detr_tpu_torch.ops.grid_sample import bilinear_sample
    from relation_detr_tpu_torch.ops.msda import multi_scale_deformable_attention
    from relation_detr_tpu_torch.ops.msda_tiled import (
        sep_contract_fused,
        tiled_core_backward,
        tiled_matmul_core,
    )
    from relation_detr_tpu_torch.ops.patch_scatter import window_accumulate
    from relation_detr_tpu_torch.ops.relation_bias import fused_relation_bias, relation_bias_v4

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    _build.load_library.cache_clear()
    wrappers = (multi_scale_deformable_attention, relation_bias_v4, window_accumulate,
                tiled_matmul_core, tiled_core_backward, sep_contract_fused, fused_relation_bias,
                bilinear_sample)
    launched = [fn.launches for fn in wrappers]
    try:
        dev = torch.device("cuda")
        value = torch.zeros(1, 6, 2, 4, device=dev)
        locs = torch.full((1, 3, 2, 1, 2, 2), 0.5, device=dev)
        attn = torch.full((1, 3, 2, 1, 2), 0.5, device=dev)
        with pytest.raises(RuntimeError, match="nvcc"):
            multi_scale_deformable_attention(value, ((2, 3),), locs, attn)
        boxes = torch.full((1, 5, 4), 0.5, device=dev)
        with pytest.raises(RuntimeError, match="nvcc"):
            relation_bias_v4(boxes, boxes, torch.zeros(64, 8, device=dev),
                             torch.zeros(8, device=dev))
        with pytest.raises(RuntimeError, match="nvcc"):
            window_accumulate(torch.zeros(1, 2, 2, 3, device=dev), [0], [0], 4, 4)
        m = torch.zeros(1, 2, 2, 16, 8, dtype=torch.int32, device=dev)
        w = torch.zeros(1, 2, 2, 16, 8, device=dev)
        patch = torch.zeros(1, 2, 6, 8, device=dev)
        with pytest.raises(RuntimeError, match="nvcc"):
            tiled_matmul_core(m, w, patch, (2, 4))
        with pytest.raises(RuntimeError, match="nvcc"):
            tiled_core_backward(m, w, patch, torch.zeros(1, 2, 8, 8, device=dev), (2, 4))
        with pytest.raises(RuntimeError, match="nvcc"):
            sep_contract_fused(torch.zeros(1, 2, 2, 4, 2, 8, device=dev),
                               torch.zeros(1, 2, 2, 4, 3, 8, device=dev), patch)
        with pytest.raises(RuntimeError, match="nvcc"):
            fused_relation_bias(torch.zeros(1, 3, 5, 4, device=dev),
                                torch.zeros(64, 8, device=dev), torch.zeros(8, device=dev))
        with pytest.raises(RuntimeError, match="nvcc"):
            bilinear_sample(torch.zeros(1, 4, 5, 8, device=dev), torch.zeros(1, 3, 2, device=dev))
        assert [fn.launches for fn in wrappers] == launched
    finally:
        _build.load_library.cache_clear()


# a quarter of the flagship's canvas, and a small ragged level set
MID_LEVELS = ((50, 84), (25, 42), (13, 21), (7, 11))
SMALL_LEVELS = ((19, 21), (10, 11), (5, 6), (3, 3))


def _msda_card_case(value, locs, attn, grad_out, levels):
    """msda_fwd and msda_bwd against their plain versions on the card: the
    output within 1e-4 abs, each gradient within 1e-4 of its max, where
    both are finite; the NaN sample (image 0, query 3, head 0, level 1,
    point 2) gives a NaN output and a NaN weight gradient on both."""
    from relation_detr_tpu_torch.ops import msda

    dev = torch.device("cuda")
    tv, tl, ta, tg = (t if isinstance(t, torch.Tensor) else torch.from_numpy(t).to(dev)
                      for t in (value, locs, attn, grad_out))
    with torch.no_grad():
        got = msda.multi_scale_deformable_attention(tv, levels, tl, ta)
        want = msda.msda_reference(tv, levels, tl, ta)
    assert torch.isnan(got[0, 3]).any() and torch.isnan(want[0, 3]).any()
    want_np = want.cpu().numpy()
    close_where_finite(got.cpu().numpy(), want_np,
                       1e-4 / np.abs(want_np[np.isfinite(want_np)]).max(), "out")
    grads = msda.msda_backward(tv, levels, tl, ta, tg)
    wants = msda.msda_backward_reference(tv, levels, tl, ta, tg)
    for name, g, w in zip(("grad_value", "grad_loc", "grad_attn"), grads, wants):
        close_where_finite(g.cpu().numpy(), w.cpu().numpy(), 1e-4, name)
    assert torch.isnan(grads[2][0, 3, 0, 1, 2]) and torch.isnan(wants[2][0, 3, 0, 1, 2])


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["encoder-like", "scattered"])
@pytest.mark.parametrize("layout,batch,heads,head_dim", [
    ("encoder", 1, 8, 32), ("encoder", 2, 4, 16), ("decoder", 2, 8, 32), ("decoder", 1, 3, 8)])
def test_msda_kernels_match_plain_versions_on_card(inputs, layout, batch, heads, head_dim):
    """The gather MSDA kernels in the encoder layout (Q = S) and the
    decoder layout, on the encoder-like and the scattered sets, 8 / 4 / 2
    lanes per item."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    rng = np.random.RandomState(head_dim + batch)
    total = sum(h * w for h, w in MID_LEVELS)
    num_queries = total if layout == "encoder" else 300
    make = encoder_like if inputs == "encoder-like" else scattered
    _msda_card_case(*make(rng, MID_LEVELS, batch, num_queries, heads, head_dim), MID_LEVELS)


BF16_EPS = 2.0 ** -8  # bf16's unit roundoff


def _msda_bf16_card_case(value, locs, attn, grad_out, levels):
    """The bf16-value forms (msda_fwd_bf16, msda_bwd_bf16) on a bf16 value
    and output gradient: the bf16 output and grad_value within one bf16
    rounding of the plain version's fp32 sums (EPS of each element, plus
    1e-5 / 1e-4 of the max for the fp32 sums' order), the fp32 location
    and weight gradients within 1e-4 of their max, and the NaN sample's
    NaNs on both; grad_value comes back bf16."""
    from relation_detr_tpu_torch.ops import msda

    dev = torch.device("cuda")
    tv, tl, ta, tg = (t if isinstance(t, torch.Tensor) else torch.from_numpy(t).to(dev)
                      for t in (value, locs, attn, grad_out))
    tv, tg = tv.to(torch.bfloat16), tg.to(torch.bfloat16)
    with torch.no_grad():
        got = msda.multi_scale_deformable_attention(tv, levels, tl, ta)
        want = msda.msda_reference(tv.float(), levels, tl, ta)
    assert got.dtype == torch.bfloat16
    assert torch.isnan(got[0, 3]).any() and torch.isnan(want[0, 3]).any()
    g, w = got.float().cpu().numpy(), want.cpu().numpy()
    both = np.isfinite(g) & np.isfinite(w)
    assert (np.abs(g - w)[both] <= BF16_EPS * np.abs(w[both])
            + 1e-5 * np.abs(w[both]).max()).all(), "out"
    grads = msda.msda_backward(tv, levels, tl, ta, tg)
    wants = msda.msda_backward_reference(tv.float(), levels, tl, ta, tg.float())
    assert grads[0].dtype == torch.bfloat16 and grads[1].dtype == grads[2].dtype == torch.float32
    gv, wv = grads[0].float().cpu().numpy(), wants[0].cpu().numpy()
    both = np.isfinite(gv) & np.isfinite(wv)
    assert (np.abs(gv - wv)[both] <= BF16_EPS * np.abs(wv[both])
            + 1e-4 * np.abs(wv[both]).max()).all(), "grad_value"
    for name, g, w in zip(("grad_loc", "grad_attn"), grads[1:], wants[1:]):
        close_where_finite(g.cpu().numpy(), w.cpu().numpy(), 1e-4, name)
    assert torch.isnan(grads[2][0, 3, 0, 1, 2]) and torch.isnan(wants[2][0, 3, 0, 1, 2])


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["encoder-like", "scattered"])
@pytest.mark.parametrize("layout,batch,heads,head_dim", [
    ("encoder", 1, 8, 32), ("encoder", 2, 4, 16), ("decoder", 2, 8, 32), ("decoder", 1, 3, 8)])
def test_msda_bf16_kernels_match_plain_versions_on_card(inputs, layout, batch, heads,
                                                        head_dim):
    """The bf16-value forms in the encoder and decoder layouts, on both
    location sets: the forward 8 bf16 channels a lane (4 lanes an item at
    D = 32, 2 at 16, 1 at 8), the backward 4 (8, 4, 2 lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    rng = np.random.RandomState(head_dim + batch + 100)
    total = sum(h * w for h, w in MID_LEVELS)
    num_queries = total if layout == "encoder" else 300
    make = encoder_like if inputs == "encoder-like" else scattered
    _msda_bf16_card_case(*make(rng, MID_LEVELS, batch, num_queries, heads, head_dim),
                         MID_LEVELS)


@pytest.mark.cuda
def test_msda_bf16_kernels_take_unaligned_tensors_on_card():
    """A bf16 value and output gradient that start 2 bytes into their
    storage: the forms then take one channel a lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    rng = np.random.RandomState(19)
    total = sum(h * w for h, w in SMALL_LEVELS)
    value, locs, attn, grad_out = encoder_like(rng, SMALL_LEVELS, 1, total, 2, 32)
    shifted = []
    for a in (value, grad_out):
        flat = torch.zeros(a.size + 1, device="cuda", dtype=torch.bfloat16)
        flat[1:] = torch.from_numpy(a).reshape(-1).cuda().to(torch.bfloat16)
        shifted.append(flat[1:].view(a.shape))
    assert all(t.data_ptr() % 4 and t.is_contiguous() for t in shifted)
    _msda_bf16_card_case(shifted[0], locs, attn, shifted[1], SMALL_LEVELS)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["encoder", "decoder"])
def test_msda_kernels_take_unaligned_tensors_on_card(layout):
    """Contiguous views that start 4 bytes into their storage: the kernels
    then take one channel per lane instead of four."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    rng = np.random.RandomState(9)
    total = sum(h * w for h, w in SMALL_LEVELS)
    arrays = encoder_like(rng, SMALL_LEVELS, 1, total if layout == "encoder" else 29, 2, 32)
    shifted = []
    for a in arrays:
        flat = torch.zeros(a.size + 1, device="cuda")
        flat[1:] = torch.from_numpy(a).reshape(-1).cuda()
        shifted.append(flat[1:].view(a.shape))
    assert all(t.data_ptr() % 16 and t.is_contiguous() for t in shifted)
    _msda_card_case(*shifted, SMALL_LEVELS)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n1,n2,heads,layout", V4_CASES)
def test_relation_bias_v4_kernel_edge_shapes_on_card(batch, n1, n2, heads, layout):
    """relation_bias_v4_fwd against its plain version: N1 != N2, row and
    column tiles cut short, 4 / 8 / 16 heads, the weights contiguous
    ("rows") or as the model hands them, the transposed view of conv's
    (H, 4E) weight ("conv"); NaN and Inf centres give the same finite
    biases, a NaN width and an Inf height NaN ones in both. One launch per
    call; 1e-4 abs where finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.ops import relation_bias

    src, tgt, kernel, bias = (torch.from_numpy(a).cuda()
                              for a in relation_boxes(np.random.RandomState(n1), batch, n1, n2,
                                                      heads))
    if layout == "conv":
        kernel = kernel.t().contiguous().t()
        assert kernel.stride() == (1, 64)
    launches = relation_bias.relation_bias_v4.launches
    with torch.no_grad():
        got = relation_bias.relation_bias_v4(src, tgt, kernel, bias)
        want = relation_bias.relation_bias_v4_reference(src, tgt, kernel, bias)
    assert relation_bias.relation_bias_v4.launches == launches + 1
    finite = torch.isfinite(want)
    assert torch.equal(finite, torch.isfinite(got))
    assert bool(torch.isnan(got[~finite]).all())
    if n1 > 2 and n2 > 2:
        assert not bool(finite[-1, :, n1 - 1].any()) and not bool(finite[-1, :, :, n2 - 2].any())
    torch.testing.assert_close(got[finite], want[finite], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,nt,heads,head_dim,points,ph,pw,tokens,dense", SEP_CASES)
def test_sep_contract_kernel_edge_shapes_on_card(batch, nt, heads, head_dim, points, ph, pw,
                                                 tokens, dense):
    """sep_contract_fwd against its plain version at 1e-5 abs: odd M, T
    not a multiple of the 4-token tile and above one 128-slot pass, 1 to 4
    points, D of 4 to 32, a patch one row high, one column wide, 20 wide
    (the most the kernel's 10-column form takes) and 25 wide (its
    16-column form, up to 32); and the wrapper's refusals (a 33-wide
    patch, D = 64) raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.ops import msda_tiled

    oy, ox, patch = (torch.from_numpy(a).cuda() for a in sep_operands(
        np.random.RandomState(ph * pw), batch, nt, heads, head_dim, points, ph, pw, tokens,
        dense))
    launches = msda_tiled.sep_contract_fused.launches
    with torch.no_grad():
        got = msda_tiled.sep_contract_fused(oy, ox, patch)
        want = msda_tiled.sep_contract_reference(oy, ox, patch)
    assert msda_tiled.sep_contract_fused.launches == launches + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    wide = torch.zeros(1, 1, 1, 1, 33, 8, device="cuda")
    with pytest.raises(ValueError, match="32 wide"):
        msda_tiled.sep_contract_fused(torch.zeros(1, 1, 1, 1, 2, 8, device="cuda"), wide,
                                      torch.zeros(1, 1, 66, 4, device="cuda"))
    with pytest.raises(ValueError, match="D = C / H"):
        msda_tiled.sep_contract_fused(torch.zeros(1, 1, 1, 1, 2, 8, device="cuda"),
                                      torch.zeros(1, 1, 1, 1, 3, 8, device="cuda"),
                                      torch.zeros(1, 1, 6, 64, device="cuda"))
    assert msda_tiled.sep_contract_fused.launches == launches + 1


def _misaligned(a):
    """A contiguous CUDA copy of a that starts 4 bytes past a 16-byte line."""
    flat = torch.zeros(a.size + 1, device="cuda")
    flat[1:] = torch.from_numpy(a).reshape(-1).cuda()
    return flat[1:].reshape(a.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,nt,heads,head_dim,entries,tokens,rows", TILED_FWD_CASES)
def test_tiled_core_fwd_kernel_edge_shapes_on_card(batch, nt, heads, head_dim, entries, tokens,
                                                   rows):
    """tiled_core_fwd against its plain version at 1e-5 abs: the flagship's
    level-0 item shape, M = 1, T not a multiple of 32, D of 4 to 32, rows
    outside [0, M) whose NaN weights are dropped and one NaN weight inside
    (its token's head slice NaN in both); and the wrapper's refusals (D =
    64, a patch not 16-byte aligned) raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.ops import msda_tiled

    arrays = tiled_fwd_operands(np.random.RandomState(rows), batch, nt, heads, head_dim,
                                entries, tokens, rows)
    m, w, patch = (torch.from_numpy(a).cuda() for a in arrays)
    dims = (heads, head_dim)
    launches = msda_tiled.tiled_matmul_core.launches
    with torch.no_grad():
        got = msda_tiled.tiled_matmul_core(m, w, patch, dims)
        want = msda_tiled.tiled_core_reference(m, w, patch, dims)
    assert msda_tiled.tiled_matmul_core.launches == launches + 1
    nan = torch.isnan(want)
    assert torch.equal(nan, torch.isnan(got)) and int(nan.sum()) == head_dim
    torch.testing.assert_close(got[~nan], want[~nan], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="head dim"):
        msda_tiled.tiled_matmul_core(m[:, :, :1].contiguous(), w[:, :, :1].contiguous(),
                                     torch.zeros(batch, nt, rows, 64, device="cuda"), (1, 64))
    with pytest.raises(ValueError, match="16-byte aligned"):
        msda_tiled.tiled_matmul_core(m, w, _misaligned(arrays[2]), dims)
    assert msda_tiled.tiled_matmul_core.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n1,n2,heads", REL_CASES)
def test_relation_bias_rel_kernel_edge_shapes_on_card(batch, n1, n2, heads):
    """relation_bias_rel_fwd against its plain version at 1e-5 abs where
    finite: one pair, N1 != N2, a last block cut short, 4 / 8 / 16 heads,
    |rel| up to 90 (angles to 9e3 rad), the flagship's N = 900; a NaN and
    an Inf in rel give NaN biases in both. One launch per call; a rel not
    16-byte aligned raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.ops import relation_bias

    arrays = relation_rel(np.random.RandomState(n2), batch, n1, n2, heads)
    rel, kernel, bias = (torch.from_numpy(a).cuda() for a in arrays)
    launches = relation_bias.fused_relation_bias.launches
    with torch.no_grad():
        got = relation_bias.fused_relation_bias(rel, kernel, bias)
        want = relation_bias.fused_relation_bias_reference(rel, kernel, bias)
    assert relation_bias.fused_relation_bias.launches == launches + 1
    finite = torch.isfinite(want)
    assert torch.equal(finite, torch.isfinite(got))
    assert bool(torch.isnan(got[~finite]).all())
    assert not bool(finite[0, :, n1 // 2, n2 // 3].any())
    torch.testing.assert_close(got[finite], want[finite], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="16-byte aligned"):
        relation_bias.fused_relation_bias(_misaligned(arrays[0]), kernel, bias)
    assert relation_bias.fused_relation_bias.launches == launches + 1


# the decode fixtures (tests/data/torch_port/make_fixtures.py) and the mean
# |nvJPEG - cv2| in levels each may have, at most. With libjpeg-turbo's
# chroma upsampling and colour conversion (ycc_to_rgb) only the inverse DCT's
# rounding differs: 0.02-0.05 measured on the H100 (4.78 at 4:2:0 with
# nvJPEG's own RGB output).
DECODE_FIXTURES = ("decode_444", "decode_gray", "decode_420", "decode_exif6", "decode_422",
                   "decode_440", "decode_411", "decode_cmyk", "decode_ycck")
YCBCR_FIXTURES = ("decode_444", "decode_420", "decode_422", "decode_440", "decode_411")
DECODE_TOL_MEAN = 0.25


@pytest.mark.cuda
def test_nvjpeg_decode_matches_cv2_on_card():
    """nvJPEG on the card against cv2's decode of each fixture: the shape
    exact (EXIF Orientation 6 turned upright, grayscale as 3 channels), the
    mean |difference| within DECODE_TOL_MEAN (CMYK and YCCK through
    ``cmyk_to_rgb``); the chroma upsampling and colour conversion kernel
    equal to its plain version on nvJPEG's planes at every subsampling,
    inside the decoder and through its wrapper, one launch counted per
    YCbCr or YCCK decode (YCCK's YCbCr -> RGB on the card), none per CMYK
    decode; four threads decoding at once give the single thread's
    arrays; a file that is not a JPEG raises with its name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from concurrent.futures import ThreadPoolExecutor

    from relation_detr_tpu_torch.data import image_io

    folder = os.path.join(REPO, "tests", "data", "torch_port")
    paths = [os.path.join(folder, name + ".jpg") for name in DECODE_FIXTURES]
    single = [image_io.read_image(p) for p in paths]
    for name, got in zip(DECODE_FIXTURES, single):
        want = np.load(os.path.join(folder, name + ".npy"))
        assert got.shape == want.shape and got.dtype == np.uint8, (name, got.shape)
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.mean() <= DECODE_TOL_MEAN, (name, diff.mean())
    assert (single[1][..., 0] == single[1][..., 2]).all()  # grayscale
    decoder = image_io.nvjpeg_decoder(0)
    for path in (os.path.join(folder, name + ".jpg") for name in YCBCR_FIXTURES):
        data = np.fromfile(path, np.uint8)
        *planes, factors = decoder.planes(data, path)
        want = image_io.ycc_to_rgb_reference(*[p.cpu() for p in planes], *factors).numpy()
        launches = image_io.ycc_to_rgb.launches
        np.testing.assert_array_equal(decoder.decode(data, path), want)
        assert image_io.ycc_to_rgb.launches == launches + 1
        got = image_io.ycc_to_rgb(*planes, *factors)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    for name, launched in (("decode_cmyk", 0), ("decode_ycck", 1)):
        path = os.path.join(folder, name + ".jpg")
        launches = image_io.ycc_to_rgb.launches
        image_io.read_image(path)
        assert image_io.ycc_to_rgb.launches == launches + launched, name
    with ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(image_io.read_image, paths * 4))
    for k, got in enumerate(threaded):
        np.testing.assert_array_equal(got, single[k % len(paths)])
    with pytest.raises(ValueError, match="x.png: not a JPEG"):
        image_io.decode_image(np.frombuffer(b"\x89PNG\r\n", np.uint8), "x.png")
    with pytest.raises(image_io.UnreadableImage, match="broken.jpg"):
        image_io.decode_image(np.frombuffer(b"\xff\xd8\xff\xe0" + bytes(40), np.uint8),
                              "broken.jpg")
    # the YCCK file's launch, then 4 threads x the YCbCr and YCCK files (the
    # EXIF file is 4:2:0); none for a failed decode
    launching = len(YCBCR_FIXTURES) + 2
    assert image_io.ycc_to_rgb.launches == launches + 1 + 4 * launching


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 11, 8, 300), (1, 7, 5, 3, 120), (1, 50, 84, 256, 4000)])
def test_bilinear_sample_kernels_match_plain_versions_on_card(shape):
    """``bilinear_sample_fwd`` and ``bilinear_sample_bwd`` against their plain
    versions on the card (float4 lanes at C = 8 and 256, scalar at C = 3):
    points on integers, off the map on every side, and a NaN point (NaN out,
    NaN gradients at the same places); the launches counted, through the
    op without gradients and through the Function with them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.ops import grid_sample

    b, h, w, c, n = shape
    rng = np.random.RandomState(h * w + c)
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).cuda()
    pts = np.stack([rng.uniform(-2, w + 1, (b, n)), rng.uniform(-2, h + 1, (b, n))], -1)
    pts[:, :n // 4] = np.floor(pts[:, :n // 4])
    pts[0, n // 2] = np.nan
    pts = torch.from_numpy(pts.astype(np.float32)).cuda()
    grad_out = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).cuda()
    fwd, bwd = grid_sample.bilinear_sample.launches, grid_sample.bilinear_sample_backward.launches
    got = grid_sample.bilinear_sample(feat, pts)
    tf, tp = feat.clone().requires_grad_(True), pts.clone().requires_grad_(True)
    (grid_sample.bilinear_sample(tf, tp) * grad_out).sum().backward()
    torch.cuda.synchronize()
    assert (grid_sample.bilinear_sample.launches, grid_sample.bilinear_sample_backward.launches) \
        == (fwd + 2, bwd + 1)
    want = grid_sample.bilinear_sample_reference(feat, pts)
    want_feat, want_pts = grid_sample.bilinear_sample_backward_reference(feat, pts, grad_out)
    for name, g, r, tol in (("out", got, want, 1e-6), ("grad_feat", tf.grad, want_feat, 1e-5),
                            ("grad_points", tp.grad, want_pts, 1e-5)):
        assert torch.equal(torch.isnan(g), torch.isnan(r)), name
        scale = r.nan_to_num().abs().max().item()
        assert (g - r).nan_to_num().abs().max().item() <= tol * scale, name
    assert bool(torch.isnan(got[0, n // 2]).all())


@pytest.mark.cuda
def test_device_prefetch_onto_the_process_card():
    """device_prefetch puts a batch on the card a process was given (the
    last one), normalised there, as a data-parallel process's loader does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not on a CPU-only host)")
    from relation_detr_tpu_torch.data.loader import Normalizer, device_prefetch

    card = torch.device("cuda", torch.cuda.device_count() - 1)
    rng = np.random.RandomState(0)
    batch = {"images": rng.randint(0, 256, (2, 32, 48, 3)).astype(np.uint8),
             "mask": np.zeros((2, 32, 48), bool)}
    batch["mask"][1, 20:] = True
    (out,) = list(device_prefetch([batch], card))
    assert out["images"].device == card and out["mask"].device == card
    want = Normalizer("cpu")(torch.from_numpy(batch["images"]), torch.from_numpy(batch["mask"]))
    torch.testing.assert_close(out["images"].cpu(), want, rtol=0, atol=1e-6)
