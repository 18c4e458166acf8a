"""The port's evaluation path against the JAX package: the tiny-test config
with the same (perturbed, converted) weights on the CPU, at B=2 over the
first 4 images of the synthetic val split.

``evaluate_model`` on the port: each batch's card-side normalisation against
the JAX detections function's, and its pre-top-k heads against the JAX
apply at 2e-3, as ``tests/test_torch_detector.py`` holds them. Then the CLI,
``relation_detr_tpu_torch.test.main`` with ``--device cpu`` and the JAX
``.npz`` weights: its stats equal its own ``--eval-json`` re-score and the
JAX ``CocoEvaluator`` on the same results JSON; and the same with the
split's jittered ground truth as the detections, where AP is not 0. cv2
decodes (the CPU has no JPEG decoder).
"""
import importlib
import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")
from tools.convert_torch_weights import convert_state_dict  # noqa: E402

from relation_detr_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD  # noqa: E402
from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu.utils.coco_eval import CocoEvaluator as JCocoEvaluator  # noqa: E402
from relation_detr_tpu_torch import test as port_test  # noqa: E402
from relation_detr_tpu_torch.data.coco import CocoDetection  # noqa: E402
from relation_detr_tpu_torch.data.loader import DataLoader  # noqa: E402
from relation_detr_tpu_torch.data.transforms import EvalPreset  # noqa: E402
from relation_detr_tpu_torch.utils.evaluation import evaluate_model  # noqa: E402
from tests.test_torch_modules import perturb, unflatten  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = importlib.import_module(
    "relation_detr_tpu_torch.configs.relation_detr.relation_detr_resnet50_tiny_test")
TINY_PATH = os.path.join(REPO, "relation_detr_tpu_torch", "configs", "relation_detr",
                         "relation_detr_resnet50_tiny_test.py")
IMAGES = 4
TOL = 2e-3


def cv2_decode(data):
    return cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The synthetic split, the port's tiny model with perturbed weights
    (seed 1) and the same weights as the JAX package's .npz and tree."""
    root = tmp_path_factory.mktemp("eval")
    subprocess.run([sys.executable, os.path.join(REPO, "tests", "make_synth_coco.py"),
                    str(root / "coco")], check=True, capture_output=True)
    model = TINY.build_model(device="cpu", seed=1)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    noisy = perturb({k: v for k, v in sd.items()
                     if not k.startswith("backbone.") or "bn" in k or "downsample.1" in k},
                    np.random.RandomState(11), 0.02)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in {**sd, **noisy}.items()})
    params, stats, leftover = convert_state_dict(dict(model.state_dict()))
    assert not leftover, leftover[:8]
    weights = str(root / "tiny.npz")
    np.savez(weights, **{f"params/{k}": v for k, v in params.items()},
             **{f"batch_stats/{k}": v for k, v in stats.items()})
    return dict(coco=str(root / "coco"), model=model, weights=weights, root=root,
                variables={"params": unflatten(params), "batch_stats": unflatten(stats)})


def _dataset(coco):
    ds = CocoDetection(os.path.join(coco, "val2017"),
                       os.path.join(coco, "annotations", "instances_val2017.json"),
                       EvalPreset(TINY.min_size, TINY.max_size, normalize_host=False),
                       device="cpu", decode=cv2_decode)
    ds.ids = ds.ids[:IMAGES]
    return ds


def test_evaluate_model_heads_match_jax(setup):
    """Per batch of evaluate_model: the normalised canvas equals the JAX
    detections function's normalisation of the same uint8 batch, and the
    pre-top-k heads agree with the JAX apply at 2e-3."""
    model, coco = setup["model"], setup["coco"]
    seen = []
    pre = model.register_forward_pre_hook(lambda m, args: seen.append(
        {"images": args[0].clone(), "mask": args[1].clone()}))
    post = model.register_forward_hook(lambda m, args, out: seen[-1].update(
        {k: out[k].clone() for k in ("pred_logits", "pred_boxes")}))
    try:
        stats = evaluate_model(model, _dataset(coco),
                               os.path.join(coco, "annotations", "instances_val2017.json"),
                               batch_size=2, topk=TINY.select_box_nums_for_evaluation,
                               verbose=False)
    finally:
        pre.remove()
        post.remove()
    assert len(stats) == 12 and all(np.isfinite(v) for v in stats.values())
    batches = list(DataLoader(_dataset(coco), batch_size=2, shuffle=False))
    assert len(seen) == len(batches) == IMAGES // 2
    jmodel = JRelationDETR(**TINY.model_args)
    apply = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, train=False))
    for batch, got in zip(batches, seen):
        images = jnp.asarray(batch["images"])
        x = (images.astype(jnp.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        x = jnp.where(jnp.asarray(batch["mask"])[..., None], 0.0, x)
        np.testing.assert_array_equal(got["images"].numpy(), np.asarray(x))
        np.testing.assert_array_equal(got["mask"].numpy(), batch["mask"])
        jout = apply(setup["variables"], x, jnp.asarray(batch["mask"]))
        for name in ("pred_logits", "pred_boxes"):
            want = np.asarray(jout[name])
            assert got[name].shape == want.shape
            np.testing.assert_allclose(got[name].numpy(), want, rtol=TOL, atol=TOL,
                                       err_msg=name)


def test_cli_stats_match_its_eval_json_and_jax(setup):
    """test.main over the split with the JAX weights file: finite stats,
    equal to its --eval-json re-score and to the JAX evaluator fed the same
    results JSON; 30 detections per image."""
    coco, out = setup["coco"], str(setup["root"] / "results.json")
    args = ["--coco-path", coco, "--model-config", TINY_PATH, "--checkpoint", setup["weights"],
            "--batch-size", "2", "--max-images", str(IMAGES), "--device", "cpu"]
    run = port_test.main(args + ["--result-json", out, "--per-category"], decode=cv2_decode)
    assert run["images"] == IMAGES and run["canvases"] == [(512, 704)]
    rescored = port_test.main(args + ["--eval-json", out, "--per-category"])
    np.testing.assert_equal(run["stats"], rescored["stats"])
    with open(out) as f:
        predictions = json.load(f)
    assert len(predictions) == IMAGES * TINY.select_box_nums_for_evaluation
    assert all(np.isfinite(p["bbox"]).all() and np.isfinite(p["score"]) for p in predictions)
    ann = os.path.join(coco, "annotations", "instances_val2017.json")
    jax_eval = JCocoEvaluator(ann)
    jax_eval.update(predictions)
    names = {1: "c1", 2: "c2", 3: "c3"}
    np.testing.assert_equal(run["stats"], jax_eval.accumulate_and_summarize(
        verbose=False, per_category=True, category_names=names))


def ground_truth_det_fn(loader, ann_file, seed):
    """A detections function that answers each image of ``loader``'s
    batches (in its order) with its ground-truth boxes, xyxy in the
    original image's pixels, every coordinate moved by a seeded offset in
    [-2, 2] px, scores 0.9 down by 0.01, labels the category ids; then one
    row of score 0 (a 1x1 box at the origin) an image, and the same for
    tail padding."""
    from collections import defaultdict

    with open(ann_file) as f:
        coco = json.load(f)
    boxes = defaultdict(list)
    for a in coco["annotations"]:
        x, y, w, h = a["bbox"]
        boxes[a["image_id"]].append([x, y, x + w, y + h, a["category_id"]])
    rng = np.random.RandomState(seed)
    batches = iter(loader._batches())
    first = coco["categories"][0]["id"]

    def det_fn(images, mask, orig_sizes):
        ids = [loader.dataset.ids[i] for i in next(batches)]
        rows = np.zeros((images.shape[0], 1 + max(len(boxes[i]) for i in ids), 6), np.float32)
        rows[..., 2:4], rows[..., 5] = 1.0, first
        for b, image_id in enumerate(ids):
            for k, (*xyxy, cat) in enumerate(boxes[image_id]):
                rows[b, k] = [*(np.asarray(xyxy) + rng.uniform(-2, 2, 4)), 0.9 - 0.01 * k, cat]
        return torch.from_numpy(rows).to(images.device)

    return det_fn


def test_ground_truth_control_matches_jax(setup):
    """A control with nonzero AP: the split's jittered ground truth as the
    detections, through ``test.evaluate`` (``detection_stream``,
    ``accumulate_batch``, ``--result-json``): AP50 1, AP above 0.5, the
    stats equal to its ``--eval-json`` re-score and to the JAX evaluator
    fed the same results JSON."""
    coco, out = setup["coco"], str(setup["root"] / "gt_results.json")
    ann = os.path.join(coco, "annotations", "instances_val2017.json")
    dataset = _dataset(coco)
    dataset.ids = sorted(dataset.images)
    loader = DataLoader(dataset, batch_size=3, shuffle=False)  # a padded tail batch
    run = port_test.evaluate(ground_truth_det_fn(loader, ann, seed=3), loader, ann, "cpu",
                             result_json=out)
    assert run["images"] == len(dataset.ids)
    assert run["stats"]["AP50"] == 1.0 and 0.5 < run["stats"]["AP"] < 1.0, run["stats"]
    rescored = port_test.main(["--coco-path", coco, "--eval-json", out])
    np.testing.assert_equal(run["stats"], rescored["stats"])
    with open(out) as f:
        predictions = json.load(f)
    jax_eval = JCocoEvaluator(ann)
    jax_eval.update(predictions)
    np.testing.assert_equal(run["stats"], jax_eval.accumulate_and_summarize(verbose=False))


@pytest.mark.parametrize("flags", [["--msda-impl", "tiled", "--msda-profile", "fast"],
                                   ["--msda-halos", "4,3,2,2"],
                                   ["--msda-dtype", "bf16"], ["--msda-int8-slab"],
                                   ["--clamp-check", "on"], ["--msda-profile", "fast"]])
def test_cli_refuses_what_is_not_ported(setup, flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        port_test.main(["--coco-path", setup["coco"], "--device", "cpu", *flags])
