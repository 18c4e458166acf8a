"""The port's decode (``data/image_io.py``) where it once differed from
``cv2.imdecode(IMREAD_COLOR)`` + BGR->RGB, against cv2's decodes recorded by
``tests/data/torch_port/make_fixtures.py``: Adam7-interlaced PNGs of every
colour type and bit depth, PNGs with an ``eXIf`` orientation, and the host
conversion of a four-component JPEG's decoded planes (Adobe CMYK and
YCCK). All equal byte for byte, shapes included. The JPEG fixtures' nvJPEG
decode runs on the card (``tests/test_torch_no_jax.py``, ``chip_smoke.py``
phase 7 (a)).
"""
import os

import numpy as np
import pytest
import torch

from relation_detr_tpu_torch.data import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "torch_port")
# (colour type, bit depth) of every Adam7 file, and a 2x3 one with empty passes
ADAM7 = tuple(f"adam7_c{color}_{depth}" for color, depths in (
    (0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16)))
    for depth in depths) + ("adam7_tiny",)


@pytest.mark.parametrize("name", ADAM7 + ("exif3", "exif6", "exif8"))
def test_png_adam7_and_exif_match_cv2(name):
    """``read_image`` (the entry the datasets call; no card, no decode=)
    equals cv2's IMREAD_COLOR as RGB: Adam7's passes put back, an eXIf
    Orientation 3, 6 or 8 turned upright."""
    path = os.path.join(DATA, "png", name + ".png")
    want = np.load(os.path.join(DATA, "png", name + ".npy"))
    got = image_io.read_image(path, device="cpu")
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    data = np.fromfile(path, np.uint8)
    stored = (int.from_bytes(data[20:24].tobytes(), "big"),  # IHDR's height, width
              int.from_bytes(data[16:20].tobytes(), "big"))
    if name.startswith("exif"):  # 6 and 8 turn the stored pixels a quarter
        assert stored == (want.shape[:2] if name == "exif3" else want.shape[1::-1])
    else:
        assert data[28] == 1 and stored == want.shape[:2]  # IHDR's interlace method: Adam7


@pytest.mark.parametrize("name,transform", [("decode_cmyk", 0), ("decode_ycck", 2)])
def test_four_component_conversion_matches_cv2(name, transform):
    """``cmyk_to_rgb`` of a CMYK or YCCK file's four decoded planes (as
    libjpeg decodes them, CPU tensors) by the file's Adobe transform flag
    equals cv2's decode of the file."""
    data = np.fromfile(os.path.join(DATA, name + ".jpg"), np.uint8)
    assert image_io.adobe_transform(data) == transform
    planes = torch.from_numpy(np.load(os.path.join(DATA, name + "_planes.npy")))
    got = image_io.cmyk_to_rgb(planes, image_io.adobe_transform(data))
    assert image_io.ycc_to_rgb.launches == 0  # CPU planes: the plain version
    np.testing.assert_array_equal(got, np.load(os.path.join(DATA, name + ".npy")))
    assert image_io.adobe_transform(np.fromfile(os.path.join(DATA, "decode_444.jpg"),
                                                np.uint8)) is None
    with pytest.raises(ValueError, match="4, H, W"):
        image_io.cmyk_to_rgb(planes[:3], transform)
