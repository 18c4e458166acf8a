"""Writes the fixtures of the port's decode and data-path checks (needs cv2
and PIL):

    python tests/data/torch_port/make_fixtures.py

- ``decode_444.jpg`` / ``decode_420.jpg``: 96x128 saturated rectangles on
  noise (the synthetic COCO's worst case for chroma upsampling), chroma
  4:4:4 and 4:2:0;
- ``decode_gray.jpg``: one channel;
- ``decode_exif6.jpg``: 4:2:0 with EXIF Orientation 6 (decodes as 128x96);
- ``<name>.npy``: cv2's ``IMREAD_COLOR`` decode of each, as RGB;
- ``synth_coco/``: the train2017 and val2017 splits of
  ``tests/make_synth_coco.py`` (16 and 8 JPEGs, and
  ``annotations/instances_train2017.json`` and ``instances_val2017.json``);
- ``synth_coco/annotations/instances_train2017_segm.json``: the train
  annotations with a segmentation each (one to three polygons inside the
  box, convex or concave; one uncompressed RLE) and one crowd annotation
  more;
- ``png/<name>.png`` and ``png/<name>.npy``: PNG files (8-bit grey, RGB,
  RGBA, palette, 4-bit palette, 1-bit grey, 16-bit RGB and grey, grey +
  alpha, and one RGB file written here with every row filter, 0-4 in turn)
  and cv2's ``IMREAD_COLOR`` decode of each, as RGB;
- ``cv_ops_golden.npz``: cv2's outputs for each function of
  ``relation_detr_tpu_torch/data/cv_ops.py`` on seeded 96x128 inputs (kept
  in the file, with the shifts, sizes and qualities), on 400 seeded
  polygon masks (300 inside the image: convex, concave, self-intersecting,
  degenerate, several per mask in some; 100 leaving it or with vertices on
  its border) and the JPEG round trip at quality 85, 90 and 95.
"""
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import zlib

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def scene(rng, h=96, w=128):
    img = rng.randint(0, 80, (h, w, 3), np.uint8)
    for color in ((255, 60, 60), (60, 255, 60), (60, 60, 255)):
        y, x = rng.randint(0, h - 30), rng.randint(0, w - 40)
        cv2.rectangle(img, (x, y), (x + int(rng.randint(15, 40)), y + int(rng.randint(10, 30))),
                      color, -1)
    return img  # RGB


def save_npy(name):
    data = np.fromfile(os.path.join(HERE, name + ".jpg"), np.uint8)
    rgb = cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.save(os.path.join(HERE, name + ".npy"), rgb)


def main():
    rng = np.random.RandomState(0)
    for name, factor in (("decode_444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                         ("decode_420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)):
        bgr = cv2.cvtColor(scene(rng), cv2.COLOR_RGB2BGR)
        cv2.imwrite(os.path.join(HERE, name + ".jpg"), bgr,
                    [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
    gray = cv2.cvtColor(scene(rng), cv2.COLOR_RGB2GRAY)
    cv2.imwrite(os.path.join(HERE, "decode_gray.jpg"), gray, [cv2.IMWRITE_JPEG_QUALITY, 90])
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(scene(rng)).save(os.path.join(HERE, "decode_exif6.jpg"), quality=90,
                                     exif=exif)
    for name in ("decode_444", "decode_420", "decode_gray", "decode_exif6"):
        save_npy(name)

    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([sys.executable, os.path.join(REPO, "tests", "make_synth_coco.py"), tmp],
                       check=True, capture_output=True)
        out = os.path.join(HERE, "synth_coco")
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(os.path.join(out, "annotations"))
        for split in ("train2017", "val2017"):
            shutil.copytree(os.path.join(tmp, split), os.path.join(out, split))
            shutil.copy(os.path.join(tmp, "annotations", f"instances_{split}.json"),
                        os.path.join(out, "annotations"))


def polygon(rng, x0, y0, x1, y1, n, concave):
    """``n`` vertices around the centre of the box, at radii inside it."""
    cx, cy, rx, ry = (x0 + x1) / 2, (y0 + y1) / 2, (x1 - x0) / 2, (y1 - y0) / 2
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(0.3 if concave else 0.8, 0.98, n)
    return np.stack([cx + rx * r * np.cos(t), cy + ry * r * np.sin(t)], 1)


def write_segm_annotations(rng):
    path = os.path.join(HERE, "synth_coco", "annotations", "instances_train2017.json")
    with open(path) as f:
        coco = json.load(f)
    for k, ann in enumerate(coco["annotations"]):
        x, y, w, h = ann["bbox"]
        if k == 5:  # uncompressed RLE of the box's inner half, column-major
            img = next(i for i in coco["images"] if i["id"] == ann["image_id"])
            m = np.zeros((img["height"], img["width"]), np.uint8)
            m[int(y + h / 4):int(y + 3 * h / 4), int(x + w / 4):int(x + 3 * w / 4)] = 1
            flat = m.T.reshape(-1)
            edges = np.flatnonzero(np.diff(np.concatenate([[0], flat, [0]])))
            runs = np.diff(np.concatenate([[0], edges, [flat.size]])).tolist()
            ann["segmentation"] = {"size": [img["height"], img["width"]],
                                   "counts": [int(v) for v in runs if v or runs.index(v) == 0]}
            continue
        polys = []
        for _ in range(int(rng.randint(1, 4)) if k % 4 == 0 else 1):
            p = polygon(rng, x, y, x + w - 1, y + h - 1, int(rng.randint(5, 14)), k % 2 == 1)
            polys.append([round(float(v), 2) for v in p.reshape(-1)])
        ann["segmentation"] = polys
    first = coco["annotations"][0]
    x, y, w, h = first["bbox"]
    coco["annotations"].append({
        "id": max(a["id"] for a in coco["annotations"]) + 1, "image_id": first["image_id"],
        "category_id": first["category_id"], "bbox": [x + 2, y + 2, w / 2, h / 2],
        "area": w * h / 4, "iscrowd": 1,
        "segmentation": [[x + 2, y + 2, x + w / 2, y + 2, x + w / 2, y + h / 2]]})
    out = os.path.join(HERE, "synth_coco", "annotations", "instances_train2017_segm.json")
    with open(out, "w") as f:
        json.dump(coco, f)


def png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def png_every_filter(rgb):
    """An 8-bit RGB PNG whose rows take the filters 0-4 in turn."""
    h, w, _ = rgb.shape
    x = rgb.astype(np.int64).reshape(h, w * 3)
    rows = []
    for y in range(h):
        kind, line = y % 5, x[y]
        up = x[y - 1] if y else np.zeros_like(line)
        left = np.concatenate([np.zeros(3, np.int64), line[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        rows.append(bytes([kind]) + ((line - pred) & 255).astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + png_chunk(b"IDAT", zlib.compress(b"".join(rows), 9)) + png_chunk(b"IEND", b""))


def write_png_fixtures(rng):
    out = os.path.join(HERE, "png")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    rgb = cv2.GaussianBlur(scene(rng, 48, 64), (3, 3), 0)
    gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    bgr = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
    alpha = rng.randint(0, 256, rgb.shape[:2]).astype(np.uint8)
    wide = rgb.astype(np.uint16) * 257 + rng.randint(0, 257, rgb.shape).astype(np.uint16)
    cv2.imwrite(os.path.join(out, "gray.png"), gray)
    cv2.imwrite(os.path.join(out, "rgb.png"), bgr)
    cv2.imwrite(os.path.join(out, "rgba.png"), np.dstack([bgr, alpha]))
    cv2.imwrite(os.path.join(out, "rgb16.png"), wide[..., ::-1].copy())
    cv2.imwrite(os.path.join(out, "gray16.png"), gray.astype(np.uint16) * 251)
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=200).save(
        os.path.join(out, "palette.png"))
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=16).save(
        os.path.join(out, "palette4.png"), bits=4)
    Image.fromarray(gray > 100).save(os.path.join(out, "gray1.png"))
    Image.fromarray(np.dstack([gray, alpha]), "LA").save(os.path.join(out, "gray_alpha.png"))
    with open(os.path.join(out, "filters.png"), "wb") as f:
        f.write(png_every_filter(rgb))
    for name in sorted(os.listdir(out)):
        data = np.fromfile(os.path.join(out, name), np.uint8)
        np.save(os.path.join(out, name[:-4] + ".npy"),
                cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))


def golden_polygons(rng, h, w, n):
    """``n`` masks' polygon lists inside an h x w image: convex, concave
    (stars), self-intersecting, degenerate (collinear, repeated, a point)."""
    out = []
    for i in range(n):
        kind = i % 5
        k = int(rng.randint(3, 14))
        if kind == 0:
            t = np.sort(rng.uniform(0, 2 * np.pi, k))
            c, r = rng.uniform([0, 0], [w, h]), rng.uniform([2, 2], [w / 2, h / 2])
            polys = [c + r * np.stack([np.cos(t), np.sin(t)], 1)]
        elif kind == 1:
            t = np.linspace(0, 2 * np.pi, k, endpoint=False)
            r = rng.uniform(2, 60, k)
            c = rng.uniform([0, 0], [w, h])
            polys = [c + r[:, None] * np.stack([np.cos(t), np.sin(t)], 1)]
        elif kind == 2:
            polys = [rng.uniform([0, 0], [w - 1, h - 1], (k, 2))]
        elif kind == 3:
            x, y = rng.uniform(0, w - 1), rng.uniform(0, h - 1)
            polys = [np.stack([np.full(k, x) + rng.randint(0, 2, k),
                               y + rng.uniform(-30, 30, k)], 1),
                     np.asarray([[x, y], [x, y], [x + 1, y]])]
        else:
            polys = [rng.uniform([0, 0], [w - 1, h - 1], (int(rng.randint(3, 8)), 2))
                     for _ in range(int(rng.randint(2, 4)))]
        out.append([np.clip(np.round(p), 0, [w - 1, h - 1]).astype(np.int32) for p in polys])
    return out


def write_cv_golden(rng):
    h, w = 96, 128
    img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), (0, 0), 1.5)
    img[20:50, 30:70] = (250, 10, 40)
    img[60:90, 90:125] = (5, 200, 220)
    hsv_in = np.dstack([rng.randint(0, 180, (h, w)), rng.randint(0, 256, (h, w)),
                        rng.randint(0, 256, (h, w))]).astype(np.uint8)
    alpha = np.zeros((h, w), np.float32)
    alpha[10:60, 20:90] = 1
    alpha[rng.rand(h, w) > 0.9] = 1
    noise = (rng.rand(h, w) * 2).astype(np.float32)
    mask = (rng.rand(h, w) > 0.5).astype(np.uint8)
    polys = golden_polygons(rng, h, w, 300) + border_polygons(rng, h, w, 100)
    filled = []
    for p in polys:
        m = np.zeros((h, w), np.uint8)
        cv2.fillPoly(m, p, 1)
        filled.append(m)
    verts = [v for p in polys for v in p]
    g = dict(
        image=img, hsv_in=hsv_in, alpha=alpha, noise=noise, mask=mask,
        rgb2hsv=cv2.cvtColor(img, cv2.COLOR_RGB2HSV),
        hsv2rgb=cv2.cvtColor(hsv_in, cv2.COLOR_HSV2RGB),
        rgb2gray=cv2.cvtColor(img, cv2.COLOR_RGB2GRAY),
        blur3=cv2.blur(img, (3, 3)), median3=cv2.medianBlur(img, 3),
        gaussian_alpha=cv2.GaussianBlur(alpha, (5, 5), 2.0),
        gaussian_noise=cv2.GaussianBlur(noise, (5, 5), 2.0),
        shift_image=np.stack([cv2.warpAffine(img, np.float32([[1, 0, dx], [0, 1, dy]]), (w, h),
                                             flags=cv2.INTER_LINEAR,
                                             borderMode=cv2.BORDER_CONSTANT, borderValue=0)
                              for dx, dy in SHIFTS]),
        shift_mask=np.stack([cv2.warpAffine(mask, np.float32([[1, 0, dx], [0, 1, dy]]), (w, h),
                                            flags=cv2.INTER_NEAREST) for dx, dy in SHIFTS]),
        poly_vertices=np.concatenate(verts), poly_lengths=np.asarray([len(v) for v in verts]),
        poly_counts=np.asarray([len(p) for p in polys]), fill_poly=np.packbits(np.stack(filled)),
        shifts=np.asarray(SHIFTS), nearest_sizes=np.asarray(NEAREST_SIZES),
        jpeg_qualities=np.asarray(JPEG_QUALITIES),
    )
    for oh, ow in NEAREST_SIZES:
        g[f"nearest_{oh}x{ow}"] = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_NEAREST)
    for q in JPEG_QUALITIES:
        enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])[1]
        g[f"jpeg_{q}"] = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
    np.savez_compressed(os.path.join(HERE, "cv_ops_golden.npz"), **g)


def border_polygons(rng, h, w, n):
    """``n`` masks' polygons that leave an h x w image: half with vertices
    up to 30 px outside (one to three polygons a mask), half with vertices
    snapped onto the border lines x = 0, x = w, y = 0, y = h (as rounded
    COCO vertices can be)."""
    out = []
    for i in range(n):
        if i % 2:
            out.append([np.stack([rng.uniform(-30, w + 30, k), rng.uniform(-30, h + 30, k)],
                                 1).round().astype(np.int32)
                        for k in rng.randint(3, 12, size=int(rng.randint(1, 4)))])
        else:
            k = int(rng.randint(3, 14))
            p = np.stack([rng.uniform(-1, w + 1, k), rng.uniform(-1, h + 1, k)], 1).round()
            out.append([np.clip(p, 0, [w, h]).astype(np.int32)])
    return out


def fill_poly_report(n=2000):
    """Prints how often ``cv_ops.fill_poly`` differs from cv2's fillPoly on
    seeded random polygons: inside a 96x128 image, leaving it, far outside
    it, and on a 480x640 image:
    ``python tests/data/torch_port/make_fixtures.py --fill-poly-report``."""
    sys.path.insert(0, REPO)
    from relation_detr_tpu_torch.data.cv_ops import fill_poly

    rng = np.random.RandomState(12)
    cases = {
        "inside 96x128": (96, 128, lambda h, w: golden_polygons(rng, h, w, 1)[0]),
        "leaving 96x128": (96, 128, lambda h, w: border_polygons(rng, h, w, 2)[rng.randint(2)]),
        "far outside 96x128": (96, 128, lambda h, w: [np.stack(
            [rng.uniform(-300, w + 300, 6), rng.uniform(-300, h + 300, 6)], 1).round()
            .astype(np.int32)]),
        "inside and leaving 480x640": (480, 640, lambda h, w: border_polygons(rng, h, w, 2)[
            rng.randint(2)] + golden_polygons(rng, h, w, 1)[0]),
    }
    for name, (h, w, make) in cases.items():
        counts = []
        for _ in range(n if h < 200 else n // 10):
            p = make(h, w)
            want = np.zeros((h, w), np.uint8)
            cv2.fillPoly(want, p, 1)
            counts.append(int((fill_poly(np.zeros((h, w), np.uint8), p, 1) != want).sum()))
        bad = [c for c in counts if c]
        print(f"{name}: {len(bad)} of {len(counts)} masks differ, by {max(bad, default=0)} "
              "pixels at most")


SHIFTS = ((3, -2), (-7, 5), (0, 6), (-1, -1))
NEAREST_SIZES = ((50, 71), (200, 300), (96, 129))
JPEG_QUALITIES = (85, 90, 95)


def main_data_path():
    rng = np.random.RandomState(15)
    write_segm_annotations(rng)
    write_png_fixtures(rng)
    write_cv_golden(rng)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fill-poly-report"]:
        fill_poly_report()
    else:
        main()
        main_data_path()
