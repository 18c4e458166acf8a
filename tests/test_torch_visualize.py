"""The port's drawing and image writers against cv2 and the JAX package:
``utils/visualize.py::plot_bounding_boxes_on_image`` against
``relation_detr_tpu.utils.visualize`` byte for byte, text included;
``data/cv_ops.py``'s ``rectangle``, ``get_text_size``, ``put_text`` and
``add_weighted`` against cv2's; ``data/image_io.py``'s ``encode_jpeg``
against ``cv2.imencode`` byte for byte (decoded by cv2 to
``cv_ops.jpeg_roundtrip``'s pixels), ``encode_png`` read back by cv2 and the
port's decoder, and ``write_image``'s extensions. numpy and cv2 only: no
model, no JAX program."""
import cv2
import numpy as np
import pytest

from relation_detr_tpu.utils import visualize as jax_visualize
from relation_detr_tpu_torch.data import cv_ops, image_io
from relation_detr_tpu_torch.utils import visualize

CHARS = [chr(c) for c in range(32, 127)]


def _boxes(rng, h, w, n):
    """Seeded xyxy float boxes: inside, across and past the image's edges,
    reversed corners, and the first two near the top edge (their labels go
    above it)."""
    boxes = rng.uniform(-30, max(h, w) + 30, (n, 4)).astype(np.float32)
    boxes[:2, 1] = rng.uniform(-3, 12, min(n, 2))
    if n > 2:
        boxes[2] = (0, 0, w - 1, h - 1)  # the whole image, edge to edge
    return boxes


@pytest.mark.parametrize("seed", range(4))
def test_plot_matches_jax_byte_for_byte(seed):
    """Labels past the class names (drawn as their number), no names, boxes
    at and past the image edge, labels above the top edge, long names: the
    whole drawing equals JAX's, text pixels included (this cv2 draws
    ``FONT_HERSHEY_SIMPLEX`` from a TrueType outline; the port's glyph table
    holds what it draws)."""
    rng = np.random.RandomState(seed)
    names = ["person", "traffic light", "a", "Zebra crossing {x}", "~!@#$%^&*()_+|"]
    for h, w in ((60, 90), (240, 320), (17, 400)):
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        n = int(rng.randint(3, 14))
        boxes, scores = _boxes(rng, h, w, n), rng.rand(n).astype(np.float32)
        labels = rng.randint(0, 9, n)
        for class_names in (names, None):
            want = jax_visualize.plot_bounding_boxes_on_image(image, boxes, scores, labels,
                                                              class_names=class_names)
            got = visualize.plot_bounding_boxes_on_image(image, boxes, scores, labels,
                                                         class_names=class_names)
            np.testing.assert_array_equal(got, want)
    assert [visualize._class_color(k) for k in range(5)] == \
        [jax_visualize._class_color(k) for k in range(5)]


def test_rectangle_matches_cv2():
    """Filled and thickness-2 rectangles on 3,000 seeded corner pairs:
    inside, clipped, reversed and degenerate (a point, a line)."""
    rng = np.random.RandomState(0)
    for i in range(3000):
        h, w = (int(v) for v in rng.randint(1, 40, 2))
        p0 = tuple(int(v) for v in rng.randint(-15, 55, 2))
        p1 = tuple(int(v) for v in rng.randint(-15, 55, 2))
        if i % 4 == 0:
            p1 = (p0[0] + int(rng.randint(-2, 3)), p0[1] + int(rng.randint(-2, 3)))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        for thickness in (-1, 2):
            want = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            got = want.copy()
            cv2.rectangle(want, p0, p1, color, thickness)
            cv_ops.rectangle(got, p0, p1, color, thickness)
            np.testing.assert_array_equal(got, want, err_msg=f"{p0} {p1} {thickness}")
    with pytest.raises(NotImplementedError, match="thickness"):
        cv_ops.rectangle(np.zeros((4, 4, 3), np.uint8), (0, 0), (2, 2), (1, 2, 3), 3)


def test_text_matches_cv2():
    """``get_text_size`` exact and ``put_text`` byte for byte on seeded
    printable-ASCII strings at seeded origins (partly off the image) and
    colours over noise; other fonts, scales and characters raise."""
    rng = np.random.RandomState(1)
    face, scale, thickness, line = cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1, cv2.LINE_AA
    assert cv_ops.get_text_size("", face, scale, thickness) == \
        cv2.getTextSize("", face, scale, thickness)
    for _ in range(300):
        text = "".join(CHARS[j] for j in rng.randint(0, len(CHARS), rng.randint(1, 40)))
        assert cv_ops.get_text_size(text, face, scale, thickness) == \
            cv2.getTextSize(text, face, scale, thickness), text
        want = rng.randint(0, 256, (40, 200, 3)).astype(np.uint8)
        got = want.copy()
        org = (int(rng.randint(-30, 190)), int(rng.randint(-5, 55)))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        cv2.putText(want, text, org, face, scale, color, thickness, line)
        cv_ops.put_text(got, text, org, face, scale, color, thickness, line)
        np.testing.assert_array_equal(got, want, err_msg=f"{text!r} at {org}")
    with pytest.raises(NotImplementedError, match="scale 0.5"):
        cv_ops.get_text_size("a", face, 1.0, thickness)
    with pytest.raises(ValueError, match="printable ASCII"):
        cv_ops.put_text(np.zeros((20, 20, 3), np.uint8), "café", (0, 10))


@pytest.mark.parametrize("alpha,gamma", [(0.2, 0.0), (0.3, 0.0), (0.55, 0.0), (0.3, 7.5)])
def test_add_weighted_matches_cv2(alpha, gamma):
    """Every pair of uint8 values, and seeded images of odd widths and a
    strided view."""
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                       indexing="ij")
    np.testing.assert_array_equal(cv_ops.add_weighted(a, alpha, b, 1 - alpha, gamma),
                                  cv2.addWeighted(a, alpha, b, 1 - alpha, gamma))
    rng = np.random.RandomState(2)
    x, y = (rng.randint(0, 256, (13, 37, 3)).astype(np.uint8) for _ in range(2))
    for p, q in ((x, y), (x[:, ::2], y[:, ::2])):
        np.testing.assert_array_equal(cv_ops.add_weighted(p, alpha, q, 1 - alpha, gamma),
                                      cv2.addWeighted(p, alpha, q, 1 - alpha, gamma))


def _scene(rng, h, w):
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img[h // 4:h // 2, w // 4:w // 2] = (250, 10, 40)  # a saturated block: chroma edges
    return img


@pytest.mark.parametrize("quality", [70, 95])
def test_encode_jpeg_matches_cv2(quality):
    """``encode_jpeg`` gives ``cv2.imencode``'s bytes (sizes on and off the
    16-pixel MCU grid, down to 1x1), and cv2 decodes them to
    ``cv_ops.jpeg_roundtrip``'s pixels, which are cv2's own round trip."""
    rng = np.random.RandomState(quality)
    for h, w in ((96, 128), (37, 53), (1, 1), (17, 31), (200, 333)):
        img = _scene(rng, h, w)
        data = image_io.encode_jpeg(img, quality)
        want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
        assert data == want, (h, w)
        decoded = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(decoded, cv_ops.jpeg_roundtrip(img, quality))


def test_encode_png_and_write_image(tmp_path):
    """``encode_png`` of BGR and grey images reads back exactly with cv2 and
    with the port's ``decode_png`` (as RGB); ``write_image`` picks the format
    by extension as ``cv2.imwrite`` does and raises on one the port does not
    read."""
    rng = np.random.RandomState(3)
    bgr = _scene(rng, 23, 41)
    grey = rng.randint(0, 256, (9, 14)).astype(np.uint8)
    for img in (bgr, grey):
        data = np.frombuffer(image_io.encode_png(img), np.uint8)
        np.testing.assert_array_equal(cv2.imdecode(data, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(
        image_io.decode_png(np.frombuffer(image_io.encode_png(bgr), np.uint8), "x.png"),
        bgr[..., ::-1])
    for name in ("a.jpg", "b.JPEG", "c.png"):
        path = str(tmp_path / name)
        image_io.write_image(path, bgr)
        cv2.imwrite(str(tmp_path / ("cv2_" + name)), bgr)
        if name.endswith("png"):
            np.testing.assert_array_equal(cv2.imread(path), bgr)
        else:
            assert open(path, "rb").read() == open(str(tmp_path / ("cv2_" + name)), "rb").read()
    with pytest.raises(ValueError, match="writes .jpg, .jpeg and .png"):
        image_io.write_image(str(tmp_path / "d.bmp"), bgr)
