"""The port's multi-image transforms, segmentation masks, Objects365 and the
thread safety of the raw read, against the JAX package on the committed
train split (its segmentation annotations where masks are read).

- ``get_raw`` from one thread while four others read transformed samples:
  every transformed read comes back transformed (the swap of
  ``self.transforms`` the raw read used to make lost some).
- ``return_masks``: every mask equal to the JAX dataset's (polygons through
  ``cv_ops.fill_poly``, the uncompressed RLE, the crowd left out).
- ``MixUp``, ``Mosaic``, ``CachedMosaic``, ``CachedMixUp`` and
  ``SimpleCopyPaste`` (mask form and box form) with the JAX transform's
  generator at the port's: images, boxes, labels (and the copy-paste's
  masks) equal.
- ``update_dataset`` reaches every mix transform of nested ``Compose``s; a
  cached read equals a fresh one; the loader gives the same batches with 1
  and 4 reader threads under ``CachedMosaic``.
- ``Object365Detection`` skips an unreadable file to the next image as the
  JAX one does, and lets any other error through.

The decode is cv2's here (``decode=``), PNG the port's own.
"""
import os
import random
import sys
import threading

import cv2
import numpy as np
import pytest

from relation_detr_tpu.data import coco as jcoco
from relation_detr_tpu.data import mix_transforms as jmix
from relation_detr_tpu_torch.data import coco, image_io, loader, mix_transforms, transforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(REPO, "tests", "data", "torch_port", "synth_coco")
FOLDER = os.path.join(SPLIT, "train2017")
ANN = os.path.join(SPLIT, "annotations", "instances_train2017.json")
SEGM = os.path.join(SPLIT, "annotations", "instances_train2017_segm.json")
SEEDS = (3, 11, 19)


def cv2_decode(data):
    return cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.fixture(scope="module")
def plain():
    return (coco.CocoDetection(FOLDER, ANN, train=True, device="cpu", decode=cv2_decode),
            jcoco.CocoDetection(FOLDER, ANN, train=True))


@pytest.fixture(scope="module")
def masked():
    return (coco.CocoDetection(FOLDER, SEGM, train=True, return_masks=True, device="cpu",
                               decode=cv2_decode),
            jcoco.CocoDetection(FOLDER, SEGM, train=True, return_masks=True))


class Marking:
    """A transform that marks its samples and yields the interpreter while
    it runs."""

    def __call__(self, sample, rng=None):
        threading.Event().wait(0.0005)
        return {**sample, "marked": True}


def test_get_raw_is_thread_safe_beside_transformed_reads():
    """One thread calls ``get_raw`` in a loop (as a Mosaic does) while four
    threads read transformed samples: every transformed read is marked,
    every raw one is not."""
    dataset = coco.CocoDetection(FOLDER, ANN, Marking(), train=True, device="cpu",
                                 decode=cv2_decode)
    stop, raws, reads, errors = threading.Event(), [], [], []

    def raw_loop():
        try:
            while not stop.is_set():
                raws.append("marked" in dataset.get_raw(len(raws) % len(dataset)))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    def reader(k):
        try:
            for i in range(24):
                reads.append("marked" in dataset.read((i + k) % len(dataset), random.Random(i)))
        except Exception as exc:
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        raw_thread = threading.Thread(target=raw_loop)
        raw_thread.start()
        readers = [threading.Thread(target=reader, args=(k,)) for k in range(4)]
        for t in readers:
            t.start()
        for t in readers:
            t.join(timeout=60)
        stop.set()
        raw_thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not raw_thread.is_alive() and not any(t.is_alive() for t in readers)
    assert len(reads) == 96 and all(reads), f"{reads.count(False)} reads came back raw"
    assert raws and not any(raws)


def test_masks_match_jax(masked):
    """Every image's masks (N, H, W) uint8, boxes and labels equal to the
    JAX dataset's; the RLE annotation and the polygons with several parts
    among them."""
    port, jax_ds = masked
    assert port.ids == jax_ds.ids
    for index in range(len(port)):
        got, want = port.get_raw(index), jax_ds.get_raw(index)
        for key in ("image", "boxes", "labels", "masks"):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{index} {key}")
        assert len(got["masks"]) == len(got["boxes"]) and got["masks"].any(axis=(1, 2)).all()


def _held(port_t, jax_t, port_ds, jax_ds, seed, index, keys=("image", "boxes", "labels")):
    """The port transform with generator ``seed`` against the JAX one with
    its generator at that state, on sample ``index``'s raw read."""
    jax_t.update_dataset(jax_ds)
    port_t.update_dataset(port_ds)
    jax_t.rng = random.Random(seed)
    got = port_t(port_ds.get_raw(index), random.Random(seed))
    want = jax_t(jax_ds.get_raw(index))
    for key in keys:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{seed} {key}")
    return got


@pytest.mark.parametrize("name,kwargs", [
    ("MixUp", dict(p=1.0)),
    ("Mosaic", {}),
    ("Mosaic", dict(target_size=320)),
    ("CachedMosaic", dict(cache_capacity=4)),
    ("CachedMixUp", dict(p=1.0, cache_capacity=4)),
])
def test_mix_transform_matches_jax(plain, name, kwargs):
    for k, seed in enumerate(SEEDS):
        _held(getattr(mix_transforms, name)(**kwargs), getattr(jmix, name)(**kwargs), *plain,
              seed, 2 * k + 1)


@pytest.mark.parametrize("blending", [True, False])
def test_copy_paste_masks_match_jax(masked, blending):
    """The mask form: image, masks, the recomputed boxes and labels equal,
    the blurred alpha bit-equal (its > 0.5 cut flips nothing)."""
    for k, seed in enumerate(SEEDS):
        got = _held(mix_transforms.SimpleCopyPaste(p=1.0, blending=blending),
                    jmix.SimpleCopyPaste(p=1.0, blending=blending), *masked, seed, k,
                    keys=("image", "boxes", "labels", "masks"))
        assert len(got["masks"]) == len(got["boxes"])


def test_copy_paste_boxes_match_jax(plain):
    """The box form (no masks): pasted rectangles, boxes and labels equal."""
    for k, seed in enumerate(SEEDS):
        _held(mix_transforms.SimpleCopyPaste(p=1.0), jmix.SimpleCopyPaste(p=1.0), *plain, seed,
              k + 4)


def test_masks_follow_mosaic_and_detr_into_copy_paste(masked):
    """``mosaic_detr`` then the mask copy-paste on masked samples: one mask
    a box, on the canvas, none empty, each mask inside its box (the
    annotation box or the one recomputed from the mask) up to 2 pixels of
    resize rounding, and at least one box its mask's own."""
    port_ds, _ = masked
    chain = transforms.Compose(transforms.mosaic_detr(normalize_host=False),
                               mix_transforms.SimpleCopyPaste(p=1.0))
    chain.update_dataset(port_ds)
    for seed in SEEDS:
        out = chain(port_ds.get_raw(seed % len(port_ds)), random.Random(seed))
        masks, boxes = out["masks"], out["boxes"]
        assert masks.shape[1:] == out["image"].shape[:2] and len(masks) == len(boxes) > 0
        assert masks.any(axis=(1, 2)).all()
        tight = mix_transforms._masks_to_boxes(masks)
        assert (tight[:, :2] >= boxes[:, :2] - 2).all() and (tight[:, 2:] <= boxes[:, 2:] + 2).all()
        assert (tight == boxes).all(axis=1).any()


def test_update_dataset_reaches_nested_mix_transforms():
    inner = mix_transforms.CachedMosaic(cache_capacity=2)
    paste = mix_transforms.SimpleCopyPaste(p=1.0)
    dataset = coco.CocoDetection(FOLDER, ANN, transforms.Compose(
        transforms.Compose(inner, transforms.detr(normalize_host=False)), paste),
        train=True, device="cpu", decode=cv2_decode)
    assert inner.dataset is None and paste.dataset is None
    out = dataset.read(0, random.Random(1))
    assert inner.dataset is dataset and paste.dataset is dataset
    assert out["image"].dtype == np.uint8 and len(inner.cache.store) == 2


def test_cached_read_equals_a_fresh_one(plain):
    port, _ = plain
    cache = mix_transforms._RawCache(capacity=2)
    for index in (0, 1, 2, 0, 5):  # a miss, a hit, an eviction
        got, fresh = cache.get(port, index), port.get_raw(index)
        for key in ("image", "boxes", "labels"):
            np.testing.assert_array_equal(got[key], fresh[key])
    assert sorted(cache.store) == [0, 5]


def test_loader_batches_under_cached_mosaic_do_not_depend_on_threads():
    def batches(workers):
        dataset = coco.CocoDetection(
            FOLDER, ANN, transforms.Compose(mix_transforms.CachedMosaic(cache_capacity=3),
                                            transforms.detr(normalize_host=False)),
            train=True, device="cpu", decode=cv2_decode)
        dataset.ids = dataset.ids[:8]
        return list(loader.DataLoader(dataset, batch_size=2, shuffle=True, seed=4,
                                      num_workers=workers, fixed_canvas=(800, 1344)))

    one, four = batches(1), batches(4)
    assert len(one) == len(four) == 4
    for a, b in zip(one, four):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.fixture(scope="module")
def png_split(tmp_path_factory):
    """The first 6 train images as PNG (decoded by the port itself), the
    third one truncated."""
    import json

    root = tmp_path_factory.mktemp("o365")
    os.makedirs(root / "images")
    with open(ANN) as f:
        ann = json.load(f)
    ann["images"] = ann["images"][:6]
    for img in ann["images"]:
        data = np.fromfile(os.path.join(FOLDER, img["file_name"]), np.uint8)
        img["file_name"] = img["file_name"].replace(".jpg", ".png")
        cv2.imwrite(str(root / "images" / img["file_name"]), cv2.imdecode(data, cv2.IMREAD_COLOR))
    broken = root / "images" / ann["images"][2]["file_name"]
    broken.write_bytes(broken.read_bytes()[:100])
    ids = {img["id"] for img in ann["images"]}
    ann["annotations"] = [a for a in ann["annotations"] if a["image_id"] in ids]
    with open(root / "ann.json", "w") as f:
        json.dump(ann, f)
    return str(root / "images"), str(root / "ann.json")


def test_object365_skips_unreadable_files_as_jax(png_split):
    """Reading index 2 (truncated) gives image 3 in both packages, the other
    indices their own; a read error of another kind propagates."""
    folder, ann = png_split
    port = coco.Object365Detection(folder, ann, device="cpu")
    jax_ds = jcoco.Object365Detection(folder, ann)
    for index in range(len(port)):
        got, want = port[index], jax_ds[index]
        assert got["image_id"] == want["image_id"]
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["boxes"], want["boxes"])
    assert port[2]["image_id"] == port.ids[3]
    with pytest.raises(image_io.UnreadableImage):
        coco.CocoDetection(folder, ann, device="cpu")[2]

    def card_failure(data):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="CUDA error"):
        coco.Object365Detection(folder, ann, device="cpu", decode=card_failure)[0]
