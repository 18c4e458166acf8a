"""The port's ``CocoEvaluator`` and the detection pack / merge of
``utils/evaluation.py`` against the JAX package's, on the same seeded
detections over the synthetic val split: the 12 stats and the per-category
table equal, not close."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from relation_detr_tpu.utils import evaluation as jevaluation
from relation_detr_tpu.utils.coco_eval import CocoEvaluator as JCocoEvaluator
from relation_detr_tpu_torch.utils import evaluation
from relation_detr_tpu_torch.utils.coco_eval import CocoEvaluator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def val_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_coco")
    subprocess.run([sys.executable, os.path.join(REPO, "tests", "make_synth_coco.py"),
                    str(root)], check=True, capture_output=True)
    return os.path.join(root, "annotations", "instances_val2017.json")


def _annotations(path, variant, tmp_path):
    """The split as made, or with crowd regions, small objects, a missing
    area and a category without ground truth."""
    if variant == "as made":
        return path
    with open(path) as f:
        coco = json.load(f)
    anns = coco["annotations"]
    anns[0]["iscrowd"] = 1
    anns[3]["iscrowd"] = 1
    anns[1]["bbox"] = [10, 12, 20, 25]
    anns[1]["area"] = 500
    del anns[2]["area"]
    anns.append({"id": 999, "image_id": anns[4]["image_id"], "category_id": 2,
                 "bbox": [1, 1, 30, 30], "area": 900, "iscrowd": 0})
    coco["categories"].append({"id": 4, "name": "c4"})
    out = tmp_path / "instances_variant.json"
    out.write_text(json.dumps(coco))
    return str(out)


def _detections(ann_file, seed):
    """Per image: noisy copies of its boxes (right and wrong labels) and
    random boxes, with scores; xyxy in pixels, as post_process gives."""
    with open(ann_file) as f:
        coco = json.load(f)
    rng = np.random.RandomState(seed)
    out = []
    for img in coco["images"]:
        gts = np.asarray([a["bbox"] for a in coco["annotations"]
                          if a["image_id"] == img["id"]], np.float64).reshape(-1, 4)
        xyxy = np.concatenate([gts[:, :2], gts[:, :2] + gts[:, 2:]], 1)
        noisy = np.repeat(xyxy, 6, 0) + rng.randn(len(xyxy) * 6, 4) * 6.0
        rand = rng.uniform(0, [img["width"], img["height"]] * 2, (40, 4))
        boxes = np.concatenate([noisy, np.concatenate(
            [np.minimum(rand[:, :2], rand[:, 2:]), np.maximum(rand[:, :2], rand[:, 2:])], 1)])
        boxes = boxes.astype(np.float32)
        scores = rng.rand(len(boxes)).astype(np.float32)
        labels = rng.randint(1, 5, len(boxes))
        out.append((img["id"], boxes, scores, labels))
    return out


def _names(ann_file):
    with open(ann_file) as f:
        return {c["id"]: c["name"] for c in json.load(f)["categories"]}


@pytest.mark.parametrize("variant", ["as made", "crowd and small"])
@pytest.mark.parametrize("route", ["arrays", "json"])
@pytest.mark.parametrize("seed", [0, 1])
def test_coco_evaluator_matches_jax(val_split, tmp_path, variant, route, seed):
    """The 12 stats and the per-category APs, fed as arrays (one
    update_from_arrays per image, one image repeated) or as a results JSON."""
    ann = _annotations(val_split, variant, tmp_path)
    dets = _detections(ann, seed)
    port, jax_eval = CocoEvaluator(ann), JCocoEvaluator(ann)
    for ev in (port, jax_eval):
        if route == "arrays":
            for img_id, boxes, scores, labels in dets + dets[:1]:
                ev.update_from_arrays(img_id, boxes, scores, labels, skip_if_seen=True)
        else:
            ev.update([{"image_id": i, "category_id": int(lab),
                        "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]),
                                 float(b[3] - b[1])], "score": float(s)}
                       for i, boxes, scores, labels in dets
                       for b, s, lab in zip(boxes, scores, labels)])
    got = port.accumulate_and_summarize(verbose=False, per_category=True,
                                        category_names=_names(ann))
    want = jax_eval.accumulate_and_summarize(verbose=False, per_category=True,
                                             category_names=_names(ann))
    assert len(want) == 12 + len(_names(ann))
    np.testing.assert_equal(got, want)
    assert 0.0 < got["AP50"] < 1.0


def test_pack_merge_round_trip_matches_jax(val_split):
    """Half the images in one evaluator, half in another; packing the second
    and merging it into the first (and merging the first's own images back,
    which are skipped) gives the JAX package's packed arrays and stats."""
    dets = _detections(val_split, 2)
    results = []
    for ev_cls, mod in ((CocoEvaluator, evaluation), (JCocoEvaluator, jevaluation)):
        first, second = ev_cls(val_split), ev_cls(val_split)
        for k, (img_id, boxes, scores, labels) in enumerate(dets):
            (first if k % 2 else second).update_from_arrays(img_id, boxes, scores, labels,
                                                            skip_if_seen=True)
        packed = mod.pack_local_detections(second)
        own = mod.pack_local_detections(first)
        mod.merge_packed_detections(first, [packed, own])
        results.append((packed, own, first.accumulate_and_summarize(verbose=False)))
    (p_packed, p_own, p_stats), (j_packed, j_own, j_stats) = results
    np.testing.assert_array_equal(p_packed, j_packed)
    np.testing.assert_array_equal(p_own, j_own)
    assert p_packed.shape[1] == 7 and p_packed.dtype == np.float64
    np.testing.assert_equal(p_stats, j_stats)
    assert evaluation.pack_local_detections(CocoEvaluator(val_split)).shape == (0, 7)


def test_gather_is_a_no_op_for_one_process(val_split):
    ev = CocoEvaluator(val_split)
    evaluation.gather_detections_across_processes(ev)
    assert not ev.dets
