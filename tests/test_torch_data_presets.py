"""The port's train presets, its numpy counterparts of cv2 and its PNG decode
against the JAX package and cv2 on the same inputs.

- ``data/cv_ops.py`` against cv2's outputs in ``cv_ops_golden.npz``
  (written by ``tests/data/torch_port/make_fixtures.py``): bytes equal on
  uint8; ``gaussian_blur5`` bit-equal on the 0/1 alpha map and within two
  float32 ulps of cv2's value on other input; ``fill_poly`` equal on all 400
  golden masks, and on seeded polygons leaving a 480x640 image, against
  cv2 itself; the JPEG round trip bit-equal at quality 85, 90 and 95.
- ``image_io.decode_png`` against cv2's ``IMREAD_COLOR`` as RGB on every PNG
  fixture: equal.
- Every registered train preset against the JAX preset on the committed
  train split, with the JAX stages' generators set to the port's child
  states: images, boxes and labels equal (uint8 bytes; floats after the
  host normalisation). ``strong_album``'s JAX JPEG step is held in the
  reference's channel order by a cv2 shim (its decode returned reversed,
  which the JAX BGR->RGB turns back); unshimmed, the JAX step's output is
  the port's with R and B swapped (Motivation point 2 of the port's data
  slice, a standing difference).
- A batch of each preset through both packages' ``collate`` on a canvas
  that holds it: equal.

The JAX side is numpy and cv2 here: nothing compiles.
"""
import os
import random

import cv2
import numpy as np
import pytest
import torch

from relation_detr_tpu.data import coco as jcoco
from relation_detr_tpu.data import loader as jloader
from relation_detr_tpu.data import transforms as jtransforms
from relation_detr_tpu_torch.data import coco, cv_ops, image_io, loader, transforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "torch_port")
SPLIT = os.path.join(DATA, "synth_coco")
PNG_FIXTURES = ("gray", "rgb", "rgba", "rgb16", "gray16", "palette", "palette4", "gray1",
                "gray_alpha", "filters")
PRESETS = ("lsj", "lsj_1536", "multiscale", "ssd", "ssdlite", "rtdetr_transform",
           "strong_album", "strong_album_1200_2000", "mosaic_detr")
SAMPLES = (0, 3, 7, 12)  # dataset indices read through each preset


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cv2_decode(data):
    return cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(os.path.join(DATA, "cv_ops_golden.npz")))


def _polygons(g):
    verts = np.split(g["poly_vertices"], np.cumsum(g["poly_lengths"])[:-1])
    ends = np.cumsum(np.concatenate([[0], g["poly_counts"]]))
    return [verts[a:b] for a, b in zip(ends[:-1], ends[1:])]


CASES = {
    "rgb2hsv": lambda g: (cv_ops.rgb2hsv(g["image"]), g["rgb2hsv"]),
    "hsv2rgb": lambda g: (cv_ops.hsv2rgb(g["hsv_in"]), g["hsv2rgb"]),
    "rgb2gray": lambda g: (cv_ops.rgb2gray(g["image"]), g["rgb2gray"]),
    "blur3": lambda g: (cv_ops.blur3(g["image"]), g["blur3"]),
    "median3": lambda g: (cv_ops.median3(g["image"]), g["median3"]),
    "gaussian_alpha": lambda g: (cv_ops.gaussian_blur5(g["alpha"]), g["gaussian_alpha"]),
    "shift_image": lambda g: (np.stack([cv_ops.shift(g["image"], dx, dy)
                                        for dx, dy in g["shifts"]]), g["shift_image"]),
    "shift_mask": lambda g: (np.stack([cv_ops.shift(g["mask"], dx, dy)
                                       for dx, dy in g["shifts"]]), g["shift_mask"]),
    "resize_nearest": lambda g: (
        np.concatenate([cv_ops.resize_nearest(g["image"], h, w).ravel()
                        for h, w in g["nearest_sizes"]]),
        np.concatenate([g[f"nearest_{h}x{w}"].ravel() for h, w in g["nearest_sizes"]])),
    "fill_poly": lambda g: (
        np.stack([cv_ops.fill_poly(np.zeros((96, 128), np.uint8), p, 1) for p in _polygons(g)]),
        np.unpackbits(g["fill_poly"]).reshape(-1, 96, 128)),
    **{f"jpeg_{q}": (lambda q: lambda g: (cv_ops.jpeg_roundtrip(g["image"], q), g[f"jpeg_{q}"]))(q)
       for q in (85, 90, 95)},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cv_ops_match_cv2(golden, name):
    """Each counterpart gives cv2's bytes on the golden inputs."""
    assert sorted(golden["jpeg_qualities"]) == [85, 90, 95]
    got, want = CASES[name](golden)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    if name == "fill_poly":
        assert len(want) >= 200 and want.any(axis=(1, 2)).sum() >= 200


@pytest.mark.parametrize("reach", [0, 1, 40])
def test_fill_poly_matches_cv2_on_a_large_image(reach):
    """Seeded polygons (1-3 a mask) on a 480x640 mask with vertices up to
    ``reach`` pixels outside it (1: on the border lines, as rounded COCO
    vertices can be), against cv2.fillPoly itself: equal."""
    rng = np.random.RandomState(reach)
    h, w = 480, 640
    for _ in range(40):
        polys = [np.stack([rng.uniform(-reach, w - 1 + reach, k),
                           rng.uniform(-reach, h - 1 + reach, k)], 1).round().astype(np.int32)
                 for k in rng.randint(3, 14, size=int(rng.randint(1, 4)))]
        if reach == 1:
            polys = [np.clip(p, 0, [w, h]).astype(np.int32) for p in polys]
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, polys, 1)
        np.testing.assert_array_equal(cv_ops.fill_poly(np.zeros((h, w), np.uint8), polys, 1), want)


def test_gaussian_blur5_within_two_ulps_on_float_input(golden):
    """On float input (not the 0/1 alpha the copy-paste blurs) cv2's row
    pass rounds in an order the port does not copy: the result is within two
    float32 ulps of cv2's value (tolerance 2 * np.spacing; measured 2 ulps,
    1.2e-7, on the golden noise in [0, 2))."""
    got = cv_ops.gaussian_blur5(golden["noise"])
    want = golden["gaussian_noise"]
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()


@pytest.mark.parametrize("name", PNG_FIXTURES)
def test_png_decode_matches_cv2(name):
    """``decode_png`` equals cv2's IMREAD_COLOR as RGB, through the decode
    entry the datasets and CLIs call (no card, no decode=)."""
    path = os.path.join(DATA, "png", name + ".png")
    got = image_io.read_image(path, device="cpu")
    np.testing.assert_array_equal(got, np.load(os.path.join(DATA, "png", name + ".npy")))


def test_png_interlaced_and_broken_files_raise_with_their_name():
    data = bytearray(np.fromfile(os.path.join(DATA, "png", "rgb.png"), np.uint8).tobytes())
    data[28] = 1  # IHDR's interlace method: Adam7
    with pytest.raises(image_io.UnreadableImage, match="a.png: Adam7"):
        image_io.decode_image(np.frombuffer(bytes(data), np.uint8), "a.png")
    with pytest.raises(image_io.UnreadableImage, match="b.png"):
        image_io.decode_image(np.frombuffer(bytes(data[:60]), np.uint8), "b.png")
    with pytest.raises(image_io.UnreadableImage, match="c.gif: not a JPEG or PNG"):
        image_io.decode_image(np.frombuffer(b"GIF89a" + bytes(20), np.uint8), "c.gif")


class ReferenceJpegCv2:
    """cv2 for the JAX transforms, its decode returned in reversed channel
    order: the JAX JPEG step's BGR->RGB then gives the reference's (and the
    port's) channel order. Everything else is cv2's."""

    def __getattr__(self, name):
        return getattr(cv2, name)

    @staticmethod
    def imdecode(buf, flags):
        return cv2.imdecode(buf, flags)[..., ::-1]


@pytest.fixture(scope="module")
def datasets():
    folder = os.path.join(SPLIT, "train2017")
    ann = os.path.join(SPLIT, "annotations", "instances_train2017.json")
    return (coco.CocoDetection(folder, ann, train=True, device="cpu", decode=cv2_decode),
            jcoco.CocoDetection(folder, ann, train=True))


def _pair(name, port_ds, jax_ds, seed, normalize_host):
    """The port preset and the JAX one with its stages' generators at the
    port's states for sample generator ``seed``."""
    if name == "mosaic_detr":
        port = transforms.mosaic_detr(port_ds, normalize_host=normalize_host)
        jax = jtransforms.mosaic_detr(jax_ds)
        stages = [jax.transforms[0], jax.transforms[1]]
    elif name.startswith("strong_album"):
        port = getattr(transforms, name)(normalize_host=normalize_host)
        jax = getattr(jtransforms, name)()
        stages = [jax, jax.color]
    else:
        port = getattr(transforms, name)(normalize_host=normalize_host)
        jax = getattr(jtransforms, name)()
        jax.rng.setstate(random.Random(seed).getstate())
        return port, jax
    for stage, child in zip(stages, transforms.children(random.Random(seed), len(stages))):
        stage.rng.setstate(child.getstate())
    return port, jax


def _preset_outputs(name, datasets, index, normalize_host=None):
    port_ds, jax_ds = datasets
    # JAX's strong_album never normalises; the others always do
    if normalize_host is None:
        normalize_host = not name.startswith("strong_album")
    port, jax = _pair(name, port_ds, jax_ds, 1000 + index, normalize_host)
    raw = port_ds.get_raw(index)
    got = port(raw, random.Random(1000 + index))
    want = jax(jax_ds.get_raw(index))
    return got, want


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax(name, datasets, monkeypatch):
    """Images, boxes and labels equal to the JAX preset's on the committed
    split for matched generator states: uint8 bytes for ``strong_album``
    (normalised on the card here, never in JAX), the host-normalised floats
    for the others; ``mosaic_detr`` draws extra images from the dataset."""
    monkeypatch.setattr(jtransforms, "cv2", ReferenceJpegCv2())
    for index in SAMPLES:
        got, want = _preset_outputs(name, datasets, index)
        for key in ("image", "boxes", "labels"):
            assert got[key].dtype == want[key].dtype, (index, key)
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{index} {key}")


def test_image_compression_is_the_jax_step_channel_reversed():
    """The JPEG step alone (p forced): the port's output is cv2's round trip
    in the input's order, the JAX step's with R and B swapped."""
    rng = np.random.RandomState(2)
    img = cv2.GaussianBlur(rng.randint(0, 256, (64, 80, 3)).astype(np.uint8), (5, 5), 0)
    img[10:30, 10:40] = (200, 0, 20)
    sample = {"image": img, "boxes": np.zeros((0, 4), np.float32),
              "labels": np.zeros((0,), np.int64)}
    # a generator state whose draws skip the shift, the brightness, take
    # RGBShift, then the JPEG step, no shuffle and no blur
    for seed in range(500):
        r = random.Random(seed)
        draws = [r.random() for _ in range(2)]
        if draws[0] >= 0.5 and draws[1] >= 0.2:
            r2 = random.Random(seed)
            r2.random(), r2.random()
            if r2.random() < 0.5:
                [r2.randint(-10, 10) for _ in range(3)]
                if r2.random() < 0.2:
                    r2.randint(85, 95)
                    if r2.random() >= 0.1 and r2.random() >= 0.1:
                        break
    else:
        pytest.fail("no generator state takes the JPEG step alone")
    got = transforms.ColorAugmentations()(sample, random.Random(seed))["image"]
    jax = jtransforms.ColorAugmentations()
    jax.rng = random.Random(seed)
    want = jax(sample)["image"]
    assert not np.array_equal(got, want)
    np.testing.assert_array_equal(got, want[..., ::-1])


def test_collate_of_each_preset_matches_jax(datasets, monkeypatch):
    """A batch of two samples of each preset through both packages'
    ``collate`` on a 2048x2048 canvas, which holds every preset's images,
    uint8 on both sides (the JAX presets' host normalisation made the
    identity, the port's ``normalize_host=False``, as its train config
    runs them): every key equal. (An image larger than the canvas, as
    lsj_1536's and strong_album_1200_2000's are on the train CLI's
    800x1344, shrinks within one level of the JAX collate's cv2 resize:
    ``tests/test_torch_data.py::test_collate_matches_jax``.)"""
    monkeypatch.setattr(jtransforms, "cv2", ReferenceJpegCv2())
    monkeypatch.setattr(jtransforms, "normalize", lambda sample: sample)
    for name in PRESETS:
        pairs = [_preset_outputs(name, datasets, index, normalize_host=False)
                 for index in (1, 5)]
        got = loader.collate([dict(g) for g, _ in pairs], fixed_canvas=(2048, 2048))
        want = jloader.collate([dict(w) for _, w in pairs], fixed_canvas=(2048, 2048))
        assert sorted(got) == sorted(want) and got["images"].dtype == np.uint8
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
