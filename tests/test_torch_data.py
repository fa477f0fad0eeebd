"""The port's data and metrics modules against Pillow and the JAX package:
the PNG codec (data/png.py) against Pillow-written files and Pillow's
reading of the port's files, the synthetic tree, the dataset readers, the
host metrics and the visual helpers. Inputs from numpy seeds."""
import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from excel_tpu.data import EvalDataset as JaxEvalDataset
from excel_tpu.data import VocDataset as JaxVocDataset
from excel_tpu.data.synthetic import _draw_sample as jax_draw_sample
from excel_tpu.utils import metrics as jmetrics
from excel_tpu.utils import visual as jvisual
from excel_tpu_torch.data import datasets as pds
from excel_tpu_torch.data.loader import eval_samples
from excel_tpu_torch.data.png import decode_png, encode_png, read_png
from excel_tpu_torch.data.synthetic import _draw_sample, make_voc_tree
from excel_tpu_torch.utils import metrics as pmetrics
from excel_tpu_torch.utils import visual as pvisual
from torch_port_common import n, t


def _photo(rng, h=37, w=53):
    """A smooth image with noise and edges, on which Pillow's adaptive
    filtering picks every filter type."""
    ys, xs = np.mgrid[0:h, 0:w]
    base = np.stack([xs * 4, ys * 6, (xs + ys) * 3], axis=-1).astype(float)
    base += rng.normal(0, 6, base.shape)
    base[h // 3:, w // 2:] = 255 - base[h // 3:, w // 2:]
    return np.clip(base, 0, 255).astype(np.uint8)


def _pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _filter_types(data: bytes) -> set:
    """The filter byte of every row of a non-interlaced PNG."""
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, ctype = hdr[:4]
    chans = {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    stride = (w * chans * depth + 7) // 8
    raw = zlib.decompress(idat)
    return {raw[r * (stride + 1)] for r in range(h)}


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P", "P4", "P2", "P1"])
def test_png_decoder_reads_pillow_files(mode):
    """Grey, RGB, RGBA and palette (8, 4, 2 and 1 bits) as Pillow writes
    them; the indices of palette files, as Pillow's "P" mode gives them."""
    rng = np.random.default_rng(0)
    photo = _photo(rng)
    if mode == "L":
        img = Image.fromarray(photo[..., 0])
    elif mode == "RGB":
        img = Image.fromarray(photo)
    elif mode == "RGBA":
        img = Image.fromarray(np.concatenate(
            [photo, photo[..., :1] // 2], axis=-1), "RGBA")
    else:
        colors = {"P": 256, "P4": 16, "P2": 4, "P1": 2}[mode]
        idx = (photo[..., 0].astype(int) * colors // 256).astype(np.uint8)
        img = Image.fromarray(idx, "P")
        img.putpalette(rng.integers(0, 256, 3 * colors).tolist())
    data = _pil_png(img)
    pixels, palette = decode_png(data)
    ref = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(pixels, np.asarray(ref))
    if mode.startswith("P"):
        np.testing.assert_array_equal(
            palette, np.asarray(ref.getpalette()).reshape(-1, 3))
        depth = data[24]
        assert depth == {"P": 8, "P4": 4, "P2": 2, "P1": 1}[mode]
    else:
        assert palette is None


def test_png_decoder_covers_every_filter():
    """Pillow's adaptive filtering on RGB and grey photos uses filters 0-4
    between them; each row decodes to Pillow's pixels."""
    rng = np.random.default_rng(1)
    seen = set()
    for _ in range(3):
        photo = _photo(rng, 64, 96)
        for img in (Image.fromarray(photo), Image.fromarray(photo[..., 1])):
            data = _pil_png(img, optimize=True)
            seen |= _filter_types(data)
            np.testing.assert_array_equal(decode_png(data)[0],
                                          np.asarray(Image.open(
                                              io.BytesIO(data))))
    assert seen >= {1, 2, 3, 4}, seen


def _filtered(pixels: np.ndarray, kind: int, bpp: int) -> bytes:
    """Rows of `pixels` (uint8 [h, stride]) filtered with `kind`, by the
    PNG specification's forward filters."""
    h, stride = pixels.shape
    x = pixels.astype(np.int64)
    out = []
    for r in range(h):
        cur = x[r]
        up = x[r - 1] if r else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    return b"".join(out)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png(width, height, ctype, rows: bytes, interlace=0) -> bytes:
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                          ctype, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_decoder_each_filter_on_every_row(kind):
    rng = np.random.default_rng(kind)
    photo = _photo(rng, 9, 17)
    data = _png(17, 9, 2, _filtered(photo.reshape(9, -1), kind, 3))
    np.testing.assert_array_equal(decode_png(data)[0], photo)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  photo)


def test_png_decoder_refuses_what_it_does_not_read():
    photo = _photo(np.random.default_rng(2), 8, 8)
    rows = _filtered(photo.reshape(8, -1), 0, 3)
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(_png(8, 8, 2, rows, interlace=1))
    bad = bytearray(_png(8, 8, 2, rows))
    bad[20] ^= 1                                   # inside IHDR: CRC fails
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"\xff\xd8\xff\xe0 a JPEG")
    grey_alpha = _png(8, 8, 4, b"\x00" * (8 * 17))
    with pytest.raises(ValueError, match="colour type 4"):
        decode_png(grey_alpha)


@pytest.mark.parametrize("mode", ["L", "P", "RGB"])
def test_png_encoder_read_by_pillow(mode, tmp_path):
    rng = np.random.default_rng(3)
    photo = _photo(rng)
    pixels = photo if mode == "RGB" else photo[..., 0]
    palette = (rng.integers(0, 256, (256, 3)).astype(np.uint8)
               if mode == "P" else None)
    data = encode_png(pixels, palette)
    img = Image.open(io.BytesIO(data))
    assert img.mode == mode
    np.testing.assert_array_equal(np.asarray(img), pixels)
    if palette is not None:
        np.testing.assert_array_equal(
            np.asarray(img.getpalette()).reshape(-1, 3), palette)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(read_png(path)[0], pixels)


def test_synthetic_tree_matches_jax_draws(tmp_path):
    """The port's tree holds, losslessly, the arrays the JAX package's
    generator draws from the same seed, with the same split lists and
    image-level labels; its images are PNG bytes under .jpg names."""
    rng_j, rng_p = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        for a, b in zip(jax_draw_sample(rng_j, (48, 96), 5),
                        _draw_sample(rng_p, (48, 96), 5)):
            np.testing.assert_array_equal(a, b)
    root = str(tmp_path)
    split_dir = make_voc_tree(root, num_images=3, seed=5, num_fg=5,
                              size_range=(48, 96))
    rng = np.random.default_rng(5)
    for i in range(3):
        image, label = jax_draw_sample(rng, (48, 96), 5)
        name = f"synth_{i:06d}"
        path = os.path.join(root, "JPEGImages", name + ".jpg")
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(pds.read_image(path), image)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), image)
        np.testing.assert_array_equal(pds.read_label(os.path.join(
            root, "SegmentationClassAug", name + ".png")), label)
    with open(os.path.join(split_dir, "val.txt")) as f:
        assert f.read().split() == [f"synth_{i:06d}" for i in range(3)]


def test_jax_readers_see_the_ports_samples(tmp_path):
    """`excel_tpu`'s VocDataset / EvalDataset over the port's tree give the
    port's samples bit for bit (every stage)."""
    root = str(tmp_path)
    split_dir = make_voc_tree(root, num_images=4, seed=0, num_fg=5,
                              size_range=(48, 96))
    for stage in ("val", "test"):
        jds = JaxEvalDataset(JaxVocDataset(root, split_dir, "val", stage))
        pds_ = pds.EvalDataset(pds.VocDataset(root, split_dir, "val", stage))
        jds.base.num_fg = pds_.base.num_fg = 5
        assert len(pds_) == len(jds) == 4 and pds_.names() == jds.names()
        for got, ref in zip(eval_samples(pds_), (jds[i] for i in range(4))):
            assert got["name"] == ref["name"]
            for key in ("image", "label", "cls_label"):
                assert got[key].dtype == ref[key].dtype
                np.testing.assert_array_equal(got[key], ref[key])


def test_read_image_without_pillow(tmp_path, monkeypatch):
    """A JPEG goes through Pillow when it is installed (as the JAX
    package's reader), and raises a clear error when it is not; a PNG never
    needs it."""
    from excel_tpu.data.datasets import read_image as jax_read_image

    photo = _photo(np.random.default_rng(4))
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray(photo).save(jpg, quality=90)
    np.testing.assert_array_equal(pds.read_image(jpg), jax_read_image(jpg))
    png = str(tmp_path / "a.png")
    with open(png, "wb") as f:
        f.write(encode_png(photo[..., 0]))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        pds.read_image(jpg)
    np.testing.assert_array_equal(pds.read_image(png),
                                  np.repeat(photo[..., :1], 3, axis=2))


def _labels(seed, shape=(3, 40, 50), c=6):
    rng = np.random.default_rng(seed)
    lt = rng.integers(0, c, shape)
    lt[rng.random(shape) < 0.1] = 255
    lp = rng.integers(0, c, shape)
    lp[rng.random(shape) < 0.1] = 255
    return lt.astype(np.int32), lp.astype(np.int32)


def test_update_hist_np_matches_jax():
    lt, lp = _labels(0)
    lp[lp == 255] = 0
    got = pmetrics.update_hist_np(np.zeros((6, 6), np.int64), lt, lp, 6)
    ref = jmetrics.update_hist_np(np.zeros((6, 6), np.int64), lt, lp, 6)
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == (lt != 255).sum()
    with pytest.raises(ValueError, match="outside"):
        pmetrics.update_hist_np(np.zeros((6, 6), np.int64), lt, lp + 6, 6)


def test_update_hist_pseudo_matches_jax():
    lt, lp = _labels(1)
    got = pmetrics.update_hist_pseudo(pmetrics.init_hist(6), t(lt), t(lp), 6)
    ref = jmetrics.update_hist_pseudo(jmetrics.init_hist(6), lt, lp, 6)
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    assert int(got.sum()) == int(((lt != 255) & (lp != 255)).sum())


def test_format_metrics_table_matches_jax():
    lt, lp = _labels(2)
    hist = jmetrics.update_hist_np(np.zeros((6, 6), np.int64), lt,
                                   np.where(lp == 255, 0, lp), 6)
    scores = pmetrics.scores_from_hist(torch.from_numpy(hist))
    names = [f"c{i}" for i in range(6)]
    for metrics in (("iou",), ("confusion", "precision", "recall", "iou")):
        assert pmetrics.format_metrics_table(scores, names, metrics) == \
            jmetrics.format_metrics_table(jmetrics.scores_from_hist(hist),
                                          names, metrics)


def test_visual_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    np.testing.assert_array_equal(pvisual.colormap(), jvisual.colormap())
    label = rng.integers(0, 21, (30, 40))
    np.testing.assert_array_equal(pvisual.encode_cmap(label),
                                  jvisual.encode_cmap(label))
    image = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    cam = rng.random((30, 40)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(pvisual.cam_overlay(image, cam),
                                  jvisual.cam_overlay(image, cam))
    for k in (6, 21):
        pvisual.save_palette_png(label % k, str(tmp_path / "p.png"), k)
        jvisual.save_palette_png(label % k, str(tmp_path / "j.png"), k)
        got, ref = Image.open(tmp_path / "p.png"), Image.open(
            tmp_path / "j.png")
        assert got.mode == ref.mode == "P"
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        assert got.getpalette() == ref.getpalette()


def test_coco_layout_read_by_both_packages(tmp_path):
    """COCO's layout (images under JPEGImages/val, masks under
    SegmentationClass/val named without the 13-character prefix): the port's
    reader and the JAX package's give the same samples."""
    from excel_tpu.data import CocoDataset as JaxCocoDataset

    rng = np.random.default_rng(7)
    root, split_dir = tmp_path, tmp_path / "splits"
    for d in ("JPEGImages/val", "SegmentationClass/val", "splits"):
        (root / d).mkdir(parents=True)
    names = [f"COCO_val2014_{i:012d}" for i in range(2)]
    for name in names:
        with open(root / "JPEGImages/val" / (name + ".jpg"), "wb") as f:
            f.write(encode_png(_photo(rng, 20, 30)))
        with open(root / "SegmentationClass/val" / (name[13:] + ".png"),
                  "wb") as f:
            f.write(encode_png(rng.integers(0, 81, (20, 30)).astype(
                np.uint8)))
    (split_dir / "val.txt").write_text("\n".join(names) + "\n")
    got = pds.EvalDataset(pds.CocoDataset(str(root), str(split_dir), "val",
                                          "val"))
    ref = JaxEvalDataset(JaxCocoDataset(str(root), str(split_dir), "val",
                                        "val"))
    for i in range(2):
        for key in ("image", "label", "cls_label"):
            np.testing.assert_array_equal(got[i][key], ref[i][key])
    assert got[0]["cls_label"].shape == (80,)


def test_logutils_match_jax(tmp_path):
    from excel_tpu.utils import logutils as jlog
    from excel_tpu_torch.utils import logutils as plog

    got, ref = plog.AverageMeter(), jlog.AverageMeter()
    for values in ({"loss": 1.5, "lr": 0.1}, {"loss": 0.5},
                   {"loss": torch.tensor(2.0)}):
        got.add(values)
        ref.add({k: float(v) for k, v in values.items()})
    assert got.pop("loss") == ref.pop("loss") == pytest.approx(4.0 / 3)
    assert got.pop("lr") == ref.pop("lr") and got.pop("loss") == 0.0
    eta = plog.Eta(10)
    eta.start -= 3725
    assert eta(5) == ("1:02:05", "1:02:05")
    path = str(tmp_path / "log.txt")
    logger = plog.setup_logger(path)
    logger.info("hello %d", 3)
    plog.log_sweep_rate(logger, 8, 0.0)
    with open(path) as f:
        text = f.read()
    assert "hello 3" in text and "sweep: 8 images" in text
