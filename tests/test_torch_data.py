"""The port's data path (``data/coco.py``, ``data/loader.py``, the eval
``EvalPreset``, the EXIF handling of ``data/image_io.py``) against the JAX
package's on the same inputs: samples, batches and batch order exact.

The CPU has no JPEG decoder, so the port's dataset decodes with cv2 here
(``decode=``, as the JAX dataset decodes); the nvJPEG decode itself runs on
the card (``tests/test_torch_no_jax.py``, ``chip_smoke.py``).
"""
import io
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from relation_detr_tpu.data import coco as jcoco
from relation_detr_tpu.data import loader as jloader
from relation_detr_tpu.data.transforms import EvalPreset as JEvalPreset
from relation_detr_tpu_torch.data import coco, image_io, loader
from relation_detr_tpu_torch.data.transforms import EvalPreset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cv2_decode(data):
    """The JAX dataset's decode: cv2 IMREAD_COLOR, BGR -> RGB."""
    return cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.fixture(scope="module")
def synth_coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_coco")
    subprocess.run([sys.executable, os.path.join(REPO, "tests", "make_synth_coco.py"),
                    str(root)], check=True, capture_output=True)
    return str(root)


def _datasets(root, split, preset, **kwargs):
    folder = os.path.join(root, split)
    ann = os.path.join(root, "annotations", f"instances_{split}.json")
    port_t = jax_t = None
    if preset is not None:
        port_t = EvalPreset(224, 320, normalize_host=preset)
        jax_t = JEvalPreset(224, 320, normalize_host=preset)
    return (coco.CocoDetection(folder, ann, port_t, device="cpu", decode=cv2_decode, **kwargs),
            jcoco.CocoDetection(folder, ann, jax_t, **kwargs))


@pytest.mark.parametrize("split,preset,kwargs", [
    ("val2017", None, {}),
    ("val2017", False, {}),
    ("train2017", True, dict(train=True)),
    ("train2017", None, dict(train=True, class_agnostic=True)),
])
def test_coco_detection_matches_jax(synth_coco, split, preset, kwargs):
    """Same ids, and per sample the same image (cv2 decode; raw, or after
    EvalPreset with or without host normalisation), boxes, labels, image
    id and orig_size; get_raw too."""
    port, jax_ds = _datasets(synth_coco, split, preset, **kwargs)
    assert port.ids == jax_ds.ids and port.categories == jax_ds.categories
    for index in (0, 3, len(port) - 1):
        got, want = port[index], jax_ds[index]
        assert sorted(got) == sorted(want)
        for key in ("image", "boxes", "labels", "orig_size"):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["image_id"] == want["image_id"]
    np.testing.assert_array_equal(port.get_raw(1)["image"], jax_ds.get_raw(1)["image"])


def test_prepare_matches_jax_on_edge_boxes(synth_coco, tmp_path):
    """Crowd, out-of-image, degenerate and clamped boxes, as _prepare keeps
    or drops them in the JAX package."""
    port, jax_ds = _datasets(synth_coco, "val2017", None)
    img_id = port.ids[0]
    anns = [dict(bbox=[-5, -5, 20, 30], category_id=1),
            dict(bbox=[10, 10, 0, 5], category_id=2),
            dict(bbox=[400, 300, 500, 500], category_id=3),
            dict(bbox=[5, 5, 9, 9], iscrowd=1, category_id=1),
            dict(bbox=[700, 700, 5, 5], category_id=1),
            dict(bbox=[1.5, 2.25, 7.5, 3], category_id=2)]
    for ds in (port, jax_ds):
        ds.anns_by_image[img_id] = anns
    for args in ((img_id, 320, 480), (img_id, 10, 10)):
        got, want = port._prepare(*args), jax_ds._prepare(*args)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype


def test_decode_needs_a_decoder_on_cpu(synth_coco):
    """The CPU has no JPEG decoder: without decode= the read raises, it
    does not fall back; with ``return_masks`` the read fails the same way
    (masks are ported: ``tests/test_torch_mix_transforms.py``)."""
    folder = os.path.join(synth_coco, "val2017")
    ann = os.path.join(synth_coco, "annotations", "instances_val2017.json")
    with pytest.raises(RuntimeError, match="no JPEG decoder"):
        coco.CocoDetection(folder, ann, device="cpu")[0]
    with pytest.raises(RuntimeError, match="no JPEG decoder"):
        coco.CocoDetection(folder, ann, return_masks=True, device="cpu")[0]


@pytest.mark.parametrize("normalize_host", [True, False])
def test_eval_preset_matches_jax(normalize_host):
    rng = np.random.RandomState(3)
    sample = {"image": rng.randint(0, 256, (333, 500, 3)).astype(np.uint8),
              "boxes": (rng.rand(3, 4) * 300).astype(np.float32),
              "labels": np.arange(3), "image_id": 7, "orig_size": np.asarray((333, 500))}
    got = EvalPreset(800, 1333, normalize_host=normalize_host)(dict(sample))
    want = JEvalPreset(800, 1333, normalize_host=normalize_host)(dict(sample))
    assert got["image"].dtype == want["image"].dtype
    assert got["image"].dtype == (np.float32 if normalize_host else np.uint8)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["boxes"], want["boxes"])


def _samples(rng, dtype, sizes, counts):
    out = []
    for i, ((h, w), n) in enumerate(zip(sizes, counts)):
        xy = rng.uniform(0, [w * 0.6, h * 0.6], (n, 2))
        wh = rng.uniform(2, [w * 0.3, h * 0.3], (n, 2))
        image = rng.randint(0, 256, (h, w, 3))
        out.append({"image": image.astype(np.uint8) if dtype == "uint8"
                    else (image / 64.0 - 2.0).astype(np.float32),
                    "boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
                    "labels": rng.randint(1, 91, n).astype(np.int64), "image_id": 10 + i,
                    "orig_size": np.asarray([h + 7, w + 3], np.int64)})
    return out


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("counts,kwargs", [
    ((3, 0), {}),  # GT bucket 16
    ((20, 5), {}),  # GT bucket 100
    ((120, 1), dict(gt_buckets=None)),  # capacity MAX_GT, boxes cut at it
    ((4, 2), dict(buckets=((96, 128), (128, 96)))),  # a bucket of its own
    ((4, 2), dict(fixed_canvas=(60, 80))),  # the oversize branch: downscale
])
def test_collate_matches_jax(dtype, counts, kwargs):
    """Every key, dtype and value of the batch; in the oversize branch the
    port's bilinear resize against cv2.resize (INTER_LINEAR): images within
    one level (uint8) or 1e-5 (float32), the rest exact."""
    rng = np.random.RandomState(sum(counts))
    samples = _samples(rng, dtype, [(90, 120), (70, 75)], counts)
    got = loader.collate([dict(s) for s in samples], **kwargs)
    want = jloader.collate([dict(s) for s in samples], **kwargs)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        if key == "images" and "fixed_canvas" in kwargs:
            diff = np.abs(got[key].astype(np.float64) - want[key].astype(np.float64))
            assert diff.max() <= (1 if dtype == "uint8" else 1e-5), diff.max()
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


class _Sizes:
    """An indexable dataset of tiny samples with COCO-like image metadata
    (for the aspect grouping)."""

    def __init__(self, n, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = list(range(100, 100 + n))
        self.images = {i: {"height": int(rng.randint(200, 600)),
                           "width": int(rng.randint(200, 800))} for i in self.ids}

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index):
        return {"image": np.full((4, 6, 3), index, np.uint8), "boxes": np.zeros((1, 4), np.float32),
                "labels": np.ones(1, np.int64), "image_id": self.ids[index],
                "orig_size": np.asarray([4, 6], np.int64)}


@pytest.mark.parametrize("n,kwargs", [
    (11, dict(batch_size=3)),
    (11, dict(batch_size=3, drop_last=True)),
    (13, dict(batch_size=2, shuffle=True, seed=5)),
    (13, dict(batch_size=4, shuffle=True, seed=1, aspect_ratio_group_factor=3)),
    (10, dict(batch_size=3, aspect_ratio_group_factor=1, drop_last=True)),
    (11, dict(batch_size=3, process_index=0, process_count=1, shuffle=True, seed=2)),
    (11, dict(batch_size=2, process_index=1, process_count=3, shuffle=True, seed=2)),
    (12, dict(batch_size=3, process_index=1, process_count=3, aspect_ratio_group_factor=3)),
])
def test_dataloader_order_matches_jax(n, kwargs):
    """Over two epochs: the same batches of image ids (tail padding -1
    included), the same images, and the same length."""
    ds = _Sizes(n)
    kwargs = dict(kwargs, fixed_canvas=(8, 8), num_workers=3)
    if "process_index" not in kwargs:
        kwargs.update(process_index=0, process_count=1)
    port, jax_loader = loader.DataLoader(ds, **kwargs), jloader.DataLoader(ds, **kwargs)
    assert len(port) == len(jax_loader)
    for _ in range(2):
        got, want = list(port), list(jax_loader)
        assert [b["image_ids"].tolist() for b in got] == [b["image_ids"].tolist() for b in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["images"], b["images"])
            np.testing.assert_array_equal(a["gt_valid"], b["gt_valid"])


def test_dataloader_defaults_to_one_process_and_surfaces_errors():
    port = loader.DataLoader(_Sizes(5), batch_size=2, fixed_canvas=(8, 8))
    assert (port.process_index, port.process_count) == (0, 1)

    class Broken(_Sizes):
        def __getitem__(self, index):
            raise OSError(f"unreadable {index}")

    with pytest.raises(OSError, match="unreadable"):
        list(loader.DataLoader(Broken(5), batch_size=2, fixed_canvas=(8, 8)))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(orientation):
    """A JPEG written by PIL with EXIF Orientation 1-8: decoded without the
    rotation (IMREAD_IGNORE_ORIENTATION) and turned by the port's EXIF code,
    it equals cv2's IMREAD_COLOR decode (which applies the tag)."""
    rng = np.random.RandomState(orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (40, 60, 3)).astype(np.uint8)).save(
        buf, format="JPEG", quality=95, exif=exif)
    data = np.frombuffer(buf.getvalue(), np.uint8)
    assert image_io.exif_orientation(data) == orientation
    want = cv2.imdecode(data, cv2.IMREAD_COLOR)
    raw = cv2.imdecode(data, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    got = image_io.apply_orientation(raw, image_io.exif_orientation(data))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_exif_orientation_absent_or_foreign():
    """No APP1, a foreign APP1 and a bad TIFF header read as 1; a non-JPEG
    file is refused by name before any decode."""
    data = np.fromfile(os.path.join(REPO, "tests", "data", "torch_port", "decode_444.jpg"),
                       np.uint8)
    assert image_io.exif_orientation(data) == 1
    foreign = b"\xff\xd8\xff\xe1\x00\x10http://ns.ad\x00\xff\xda"
    assert image_io.exif_orientation(np.frombuffer(foreign, np.uint8)) == 1
    bad_tiff = b"\xff\xd8\xff\xe1\x00\x10Exif\x00\x00XX\x00\x2a\x00\x00\xff\xda"
    assert image_io.exif_orientation(np.frombuffer(bad_tiff, np.uint8)) == 1
    with pytest.raises(ValueError, match="x.png: not a JPEG"):
        image_io.decode_image(np.frombuffer(b"\x89PNG\r\n", np.uint8), "x.png", device="cuda")


def test_folder_cli_decodes_through_image_io(tmp_path, capsys):
    """The folder CLI reads images through data/image_io.py: with cv2's
    decode on the CPU it answers the EXIF fixture with the config's
    ``select_box_nums_for_evaluation`` boxes (the tiny config's 30); without
    a decoder on the CPU it raises rather than fall back."""
    from relation_detr_tpu_torch import inference

    fixture = os.path.join(REPO, "tests", "data", "torch_port", "decode_exif6.jpg")
    (tmp_path / "a.jpg").write_bytes(open(fixture, "rb").read())
    cfg = os.path.join(REPO, "relation_detr_tpu_torch", "configs", "relation_detr",
                       "relation_detr_resnet50_tiny_test.py")
    argv = ["--image-dir", str(tmp_path), "--model-config", cfg, "--device", "cpu",
            "--score-threshold", "0"]
    inference.main(argv, decode=cv2_decode)
    assert "a.jpg: 30 detections" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no JPEG decoder"):
        inference.main(argv)


def _libjpeg_ycc_to_rgb(y, cb, cr, hf, vf):
    """libjpeg-turbo's C loops, transcribed: h2v1_fancy_upsample and
    h2v2_fancy_upsample (jdsample.c; the rows above the first and below the
    last duplicate them, jdmainct.c) and ycc_rgb_convert (jdcolor.c)."""
    def fix(x):
        return int(x * 65536 + 0.5)

    def up(c):
        ch, cw = c.shape
        c = c.astype(np.int64)
        if (hf, vf) == (1, 1):
            return c
        out = np.zeros((ch * vf, cw * 2), np.int64)
        for inrow in range(ch):
            for v in range(vf):
                if vf == 2:
                    far = max(inrow - 1, 0) if v == 0 else min(inrow + 1, ch - 1)
                    sums = [c[inrow, k] * 3 + c[far, k] for k in range(cw)]
                    row = out[2 * inrow + v]
                    this, nxt = sums[0], sums[1]
                    row[0], row[1] = (this * 4 + 8) >> 4, (this * 3 + nxt + 7) >> 4
                    last, this = this, nxt
                    for k in range(2, cw):
                        nxt = sums[k]
                        row[2 * k - 2] = (this * 3 + last + 8) >> 4
                        row[2 * k - 1] = (this * 3 + nxt + 7) >> 4
                        last, this = this, nxt
                    row[2 * cw - 2] = (this * 3 + last + 8) >> 4
                    row[2 * cw - 1] = (this * 4 + 7) >> 4
                else:
                    src, row = c[inrow], out[inrow]
                    row[0], row[1] = src[0], (src[0] * 3 + src[1] + 2) >> 2
                    for k in range(1, cw - 1):
                        row[2 * k] = (src[k] * 3 + src[k - 1] + 1) >> 2
                        row[2 * k + 1] = (src[k] * 3 + src[k + 1] + 2) >> 2
                    row[2 * cw - 2] = (src[cw - 1] * 3 + src[cw - 2] + 1) >> 2
                    row[2 * cw - 1] = src[cw - 1]
        return out

    h, w = y.shape
    cbu, cru = up(cb)[:h, :w] - 128, up(cr)[:h, :w] - 128
    luma = y.astype(np.int64)
    r = luma + ((fix(1.40200) * cru + 32768) >> 16)
    g = luma + ((-fix(0.34414) * cbu + 32768 + -fix(0.71414) * cru) >> 16)
    b = luma + ((fix(1.77200) * cbu + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("hf,vf", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("h,w", [(7, 9), (8, 10), (5, 4)])
def test_ycc_to_rgb_matches_libjpeg(hf, vf, h, w):
    """ycc_to_rgb's plain version (the CPU route of its wrapper) against
    libjpeg-turbo's upsampling and colour conversion loops, bit for bit, at
    even and odd sizes; saturated planes reach the clamp."""
    rng = np.random.RandomState(h * w + hf + vf)
    ch, cw = -(-h // vf), -(-w // hf)
    y = rng.randint(0, 256, (h, w)).astype(np.uint8)
    cb = rng.choice([0, 16, 128, 240, 255], (ch, cw)).astype(np.uint8)
    cr = rng.randint(0, 256, (ch, cw)).astype(np.uint8)
    want = _libjpeg_ycc_to_rgb(y, cb, cr, hf, vf)
    planes = [torch.from_numpy(a) for a in (y, cb, cr)]
    got = image_io.ycc_to_rgb(*planes, hf, vf)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert image_io.ycc_to_rgb.launches == 0
    with pytest.raises(ValueError, match="do not match"):
        image_io.ycc_to_rgb(planes[0], planes[1][:1, :1].clone(), planes[2][:1, :1].clone(),
                            hf, vf)
    with pytest.raises(ValueError, match="chroma factors"):
        image_io.ycc_to_rgb(*planes, 1, 2)
