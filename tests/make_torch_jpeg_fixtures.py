"""Write the JPEG fixtures under tests/torch_fixtures/jpeg/ with Pillow (and
libjpeg, for what Pillow's encoder cannot write), and expected.json: each file's shape and the SHA-256 of Pillow's decode
(`np.asarray(Image.open(p).convert("RGB"))`, or `np.asarray(Image.open(p))`
[h, w] for a greyscale file), which the port's decoder must reproduce where
Pillow is absent.

    python tests/make_torch_jpeg_fixtures.py

- synth_000000-3.jpg: the first 4 images of
  `data.synthetic.make_voc_tree(seed=0)` (the eval CLIs' synthetic tree at
  VOC size) at quality 90, 4:2:0;
- photo_500x375.jpg: a photo-like 500x375 image (smooth shading, edges,
  sensor noise) at quality 90, 4:2:0, VOC's most common size;
- progressive.jpg, grey.jpg, q95_444.jpg, restart.jpg, keep_rgb.jpg: one
  each of the other variants the decoder takes;
- s440.jpg, s440_progressive.jpg, s411.jpg, s_cb2x2.jpg: sampling factors
  that Pillow's encoder does not offer (4:4:0, 4:1:1, chroma sampled above
  luma), and arith.jpg, arithmetic-coded (which the decoder leaves to
  Pillow; not in expected.json), written by libjpeg through
  tests/jpeg_sampling_encoder.c (built here with gcc -ljpeg).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
SYNTH = 4
ENCODER = os.path.join(ROOT, "tests", "jpeg_sampling_encoder.c")
# name -> ((h, v) of Y, Cb, Cr flattened, progressive, arithmetic)
LIBJPEG = {"s440.jpg": ((1, 2, 1, 1, 1, 1), False, False),
           "s440_progressive.jpg": ((1, 2, 1, 1, 1, 1), True, False),
           "s411.jpg": ((4, 1, 1, 1, 1, 1), False, False),
           "s_cb2x2.jpg": ((1, 1, 2, 2, 1, 1), False, False),
           "arith.jpg": ((2, 2, 1, 1, 1, 1), False, True)}
ARITHMETIC = "arith.jpg"


def photo_like(h: int, w: int, seed: int) -> np.ndarray:
    """Shading, a few hard-edged discs and noise, uint8 [h, w, 3]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([110 + 70 * np.sin(x / (40 + 9 * c) + c)
                    * np.cos(y / (55 - 7 * c)) for c in range(3)], axis=-1)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(20, 90)
        disc = (y - cy) ** 2 + (x - cx) ** 2 < r * r
        img[disc] = rng.uniform(20, 235, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pillow_decode(data: bytes) -> np.ndarray:
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    return np.asarray(im if im.mode == "L" else im.convert("RGB"))


def digest(pixels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def fixtures() -> dict[str, bytes]:
    """name -> JPEG bytes, encoded by Pillow and by libjpeg."""
    from PIL import Image

    sys.path.insert(0, ROOT)
    from excel_tpu_torch.data.png import read_png
    from excel_tpu_torch.data.synthetic import make_voc_tree

    def jpg(pixels, **kw) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, "JPEG", **kw)
        return buf.getvalue()

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        make_voc_tree(tmp, num_images=SYNTH, seed=0)
        for i in range(SYNTH):
            name = f"synth_{i:06d}"
            pixels, _ = read_png(os.path.join(tmp, "JPEGImages",
                                              name + ".jpg"))
            out[name + ".jpg"] = jpg(pixels, quality=90, subsampling=2)
    photo = photo_like(375, 500, seed=1)
    out["photo_500x375.jpg"] = jpg(photo, quality=90, subsampling=2)
    small = photo_like(75, 99, seed=2)
    out["progressive.jpg"] = jpg(small, quality=85, progressive=True)
    out["grey.jpg"] = jpg(np.asarray(Image.fromarray(small).convert("L")),
                          quality=85)
    out["q95_444.jpg"] = jpg(small, quality=95, subsampling=0)
    out["restart.jpg"] = jpg(small, quality=80, restart_marker_blocks=5)
    out["keep_rgb.jpg"] = jpg(small, quality=90, subsampling=0,
                              keep_rgb=True)
    out.update(libjpeg_fixtures(photo_like(45, 37, seed=3)))
    return out


def libjpeg_fixtures(pixels: np.ndarray) -> dict[str, bytes]:
    """LIBJPEG's files of `pixels`, encoded by libjpeg."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "encoder")
        subprocess.run(["gcc", "-O2", "-o", exe, ENCODER, "-ljpeg"],
                       check=True)
        raw = os.path.join(tmp, "in.rgb")
        np.ascontiguousarray(pixels).tofile(raw)
        h, w = pixels.shape[:2]
        for name, (factors, progressive, arithmetic) in LIBJPEG.items():
            path = os.path.join(tmp, name)
            subprocess.run([exe, raw, str(w), str(h), path, "85",
                            *map(str, factors), str(int(progressive)),
                            str(int(arithmetic))], check=True)
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def expected(files: dict[str, bytes]) -> dict:
    table = {}
    for name, data in sorted(files.items()):
        if name == ARITHMETIC:
            continue
        pixels = pillow_decode(data)
        table[name] = {"shape": list(pixels.shape), "sha256": digest(pixels)}
    return table


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    files = fixtures()
    for name, data in files.items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump(expected(files), f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} fixtures, {total} bytes -> {OUT}")


if __name__ == "__main__":
    main()
