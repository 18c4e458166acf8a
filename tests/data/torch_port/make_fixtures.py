"""Writes the JPEG fixtures of the port's decode checks (needs cv2 and PIL):

    python tests/data/torch_port/make_fixtures.py

- ``decode_444.jpg`` / ``decode_420.jpg``: 96x128 saturated rectangles on
  noise (the synthetic COCO's worst case for chroma upsampling), chroma
  4:4:4 and 4:2:0;
- ``decode_gray.jpg``: one channel;
- ``decode_exif6.jpg``: 4:2:0 with EXIF Orientation 6 (decodes as 128x96);
- ``<name>.npy``: cv2's ``IMREAD_COLOR`` decode of each, as RGB;
- ``synth_coco/``: the train2017 and val2017 splits of
  ``tests/make_synth_coco.py`` (16 and 8 JPEGs, and
  ``annotations/instances_train2017.json`` and ``instances_val2017.json``).
"""
import os
import shutil
import subprocess
import sys
import tempfile

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


if __name__ == "__main__":
    main()
