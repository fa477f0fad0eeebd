"""The port's JPEG decoder (excel_tpu_torch/data/jpeg.py over
native/jpeg.cpp) against Pillow's decode, bit for bit, on JPEGs that Pillow
encodes here: quality 1 to 100, 4:4:4 / 4:2:2 / 4:2:0, greyscale,
optimised tables, progressive, restart markers, RGB kept (`keep_rgb`),
EXIF / ICC / comment segments, sizes 1x1 to 70x70 and 500x375, smooth
photos and uniform noise. The variants it does not take are told from the
markers and go to Pillow (or raise naming Pillow where it is absent); a
truncated stream raises ValueError. The committed fixtures decode to the
digests that Pillow gives, those that libjpeg wrote at sampling factors
Pillow's encoder does not offer (4:4:0, 4:1:1, chroma above luma) too."""
import hashlib
import io
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from excel_tpu.data.datasets import read_image as jax_read_image
from excel_tpu.data.datasets import read_label as jax_read_label
from excel_tpu_torch.data import datasets as pds
from excel_tpu_torch.data import jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "jpeg")
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _photo(rng, h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 7.0 + c) * 60 + np.cos(y / 11.0 - c) * 50
                    + 128 for c in range(3)], axis=-1)
    img += rng.normal(0, 10, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _encode(pixels: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    return np.asarray(im if im.mode == "L" else im.convert("RGB"))


def _exif() -> bytes:
    exif = Image.Exif()
    exif[0x010F] = "maker"
    exif[0x0112] = 6                     # orientation: not applied on read
    return exif.tobytes()


@settings(max_examples=500, deadline=None, derandomize=True)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       noise=st.booleans(),
       quality=st.sampled_from([1, 50, 75, 95, 100]),
       subsampling=st.sampled_from(sorted(SUBSAMPLING)),
       grey=st.booleans(), optimize=st.booleans(),
       progressive=st.booleans(),
       restart=st.sampled_from([None, ("blocks", 1), ("blocks", 7),
                                ("rows", 1), ("rows", 2)]),
       keep_rgb=st.booleans(),
       segments=st.sampled_from([(), ("exif",), ("icc",), ("comment",),
                                 ("exif", "icc", "comment")]),
       seed=st.integers(0, 2 ** 16))
def test_decode_equals_pillow(h, w, noise, quality, subsampling, grey,
                              optimize, progressive, restart, keep_rgb,
                              segments, seed):
    rng = np.random.default_rng(seed)
    pixels = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) if noise
              else _photo(rng, h, w))
    if grey:
        pixels = pixels[..., 1]
    kw = dict(quality=quality, optimize=optimize, progressive=progressive)
    if not grey:
        kw["subsampling"] = SUBSAMPLING[subsampling]
        if keep_rgb and subsampling == "4:4:4":
            kw["keep_rgb"] = True
    if restart:
        kw[f"restart_marker_{restart[0]}"] = restart[1]
    if "exif" in segments:
        kw["exif"] = _exif()
    if "icc" in segments:
        kw["icc_profile"] = bytes(range(256)) * 3
    if "comment" in segments:
        kw["comment"] = "a comment"
    data = _encode(pixels, **kw)
    assert jpeg.supported(data)
    got = jpeg.decode_jpeg(data)
    ref = _pillow(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("subsampling", sorted(SUBSAMPLING))
@pytest.mark.parametrize("progressive", [False, True])
def test_voc_sized_photo_equals_pillow(subsampling, progressive):
    rng = np.random.default_rng(7)
    for pixels in (_photo(rng, 375, 500), _photo(rng, 500, 375)):
        data = _encode(pixels, quality=90, progressive=progressive,
                       subsampling=SUBSAMPLING[subsampling])
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pillow(data))


def test_readers_take_jpeg_without_pillow(tmp_path, monkeypatch):
    """read_image and read_label through the port's decoder, with Pillow
    blocked, equal excel_tpu's readers (Pillow); grey files stacked to RGB
    by read_image and [h, w] from read_label."""
    rng = np.random.default_rng(1)
    photo = _photo(rng, 61, 45)
    colour, grey = str(tmp_path / "c.jpg"), str(tmp_path / "g.jpg")
    with open(colour, "wb") as f:
        f.write(_encode(photo, quality=80))
    with open(grey, "wb") as f:
        f.write(_encode(photo[..., 0], quality=80))
    refs = {(p, fn): ref(p) for p in (colour, grey)
            for fn, ref in (("image", jax_read_image),
                            ("label", jax_read_label))}
    monkeypatch.setitem(sys.modules, "PIL", None)
    for (path, fn), ref in refs.items():
        got = (pds.read_image if fn == "image" else pds.read_label)(path)
        np.testing.assert_array_equal(got, ref)
    assert pds.read_image(grey).shape == (61, 45, 3)
    assert pds.read_label(grey).shape == (61, 45)


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """`data` with the byte `offset` bytes into the first `marker` segment's
    body (after its length) set to `value`, or the marker code itself
    (offset -3)."""
    at = data.index(bytes([0xFF, marker])) + 4 + offset
    return data[:at] + bytes([value]) + data[at + 1:]


def _first_scan_only(data: bytes) -> bytes:
    """A progressive file cut after its first scan (the DC scan), with an
    EOI: its AC coefficients are never sent."""
    nxt = data.index(b"\xff\xda")
    while True:                     # the next marker past stuffed 0xFF00
        nxt = data.index(b"\xff", nxt + 2)
        if data[nxt + 1] not in (0x00, 0xFF):
            return data[:nxt] + b"\xff\xd9"


def test_variants_are_told_from_the_markers(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    photo = _photo(rng, 40, 48)
    base = _encode(photo, quality=80)
    cmyk_buf = io.BytesIO()
    Image.fromarray(photo).convert("CMYK").save(cmyk_buf, "JPEG")
    cases = {
        "cmyk": (cmyk_buf.getvalue(), "4-component"),
        "arithmetic": (_patched(base, 0xC0, -3, 0xC9), "arithmetic"),
        "lossless": (_patched(base, 0xC0, -3, 0xC3), "lossless"),
        "hierarchical": (_patched(base, 0xC0, -3, 0xC5), "hierarchical"),
        "12bit": (_patched(base, 0xC0, 0, 12), "12-bit"),
        "incomplete_progressive": (
            _first_scan_only(_encode(photo, quality=80, progressive=True)),
            "smooths"),
    }
    paths = {}
    for name, (data, what) in cases.items():
        assert not jpeg.supported(data), name
        assert what in jpeg.unsupported_variant(data), name
        with pytest.raises(ValueError, match="does not take"):
            jpeg.decode_jpeg(data)
        paths[name] = str(tmp_path / f"{name}.jpg")
        with open(paths[name], "wb") as f:
            f.write(data)
    assert jpeg.supported(base)
    with open(os.path.join(FIXTURES, "arith.jpg"), "rb") as f:
        cases["arithmetic_libjpeg"] = (f.read(), "arithmetic")
    paths["arithmetic_libjpeg"] = os.path.join(FIXTURES, "arith.jpg")
    assert not jpeg.supported(cases["arithmetic_libjpeg"][0])
    # with Pillow installed, such a file goes through it, as excel_tpu reads
    for name in ("cmyk", "incomplete_progressive", "arithmetic_libjpeg"):
        np.testing.assert_array_equal(pds.read_image(paths[name]),
                                      jax_read_image(paths[name]))
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name, (_, what) in cases.items():
        with pytest.raises(RuntimeError, match=f"{what}.*Pillow"):
            pds.read_image(paths[name])


def test_corrupt_or_truncated_stream_raises(tmp_path):
    data = _encode(_photo(np.random.default_rng(3), 64, 80), quality=90)
    for bad in (data[:len(data) // 2], data[:-2], data[:300],
                data[:2] + b"\xff\xc4\x00\x01" + data[2:]):
        assert jpeg.supported(bad)
        with pytest.raises(ValueError):
            jpeg.decode_jpeg(bad)
    path = str(tmp_path / "t.jpg")
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(ValueError):
        pds.read_image(path)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"GIF89a")
    huge = _patched(_patched(data, 0xC0, 1, 0xFF), 0xC0, 3, 0xFF)
    with pytest.raises(ValueError, match="pixels"):
        jpeg.decode_jpeg(huge)


@pytest.mark.parametrize("kind", ["colour", "grey", "progressive",
                                  "restart"])
def test_probe_reads_the_frame_from_the_markers(kind):
    """The decoder's parser with the entropy-coded data skipped gives the
    frame that Pillow reads, and raises where the markers are cut."""
    photo = _photo(np.random.default_rng(5), 37, 53)
    data = {"colour": lambda: _encode(photo, quality=75),
            "grey": lambda: _encode(photo[..., 2], quality=75),
            "progressive": lambda: _encode(photo, progressive=True),
            "restart": lambda: _encode(photo, restart_marker_blocks=1)}[kind]()
    header = jpeg.probe(data)
    ref = Image.open(io.BytesIO(data))
    assert (header.height, header.width) == (ref.height, ref.width)
    assert header.components == len(ref.getbands())
    assert header.unsupported is None
    with pytest.raises(ValueError, match="corrupt JPEG"):
        jpeg.probe(data[:20])


def test_threads_decode_in_parallel_to_the_same_bytes():
    rng = np.random.default_rng(4)
    files = [_encode(_photo(rng, 120, 90 + i), quality=85,
                     progressive=bool(i % 2)) for i in range(8)]
    alone = [jpeg.decode_jpeg(d) for d in files]
    with ThreadPoolExecutor(4) as pool:
        together = list(pool.map(jpeg.decode_jpeg, files * 3))
    for i, got in enumerate(together):
        np.testing.assert_array_equal(got, alone[i % 8])


def _fixtures():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["s440.jpg", "s440_progressive.jpg",
                                  "s411.jpg", "s_cb2x2.jpg"])
def test_libjpeg_sampling_factors_equal_pillow(name):
    """h1v2 fancy upsampling (4:4:0), box replication (4:1:1) and a chroma
    component sampled above luma (luma upsampled)."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    assert jpeg.supported(data)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pillow(data))


def test_fixtures_decode_to_their_recorded_digests():
    """expected.json holds Pillow's decode of each committed fixture (this
    test recomputes it), and the port's decoder gives the same bytes."""
    table = _fixtures()
    assert len(table) == 14
    total = 0
    for name, want in table.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        total += len(data)
        for pixels in (_pillow(data), jpeg.decode_jpeg(data)):
            assert list(pixels.shape) == want["shape"], name
            assert hashlib.sha256(pixels.tobytes()).hexdigest() == \
                want["sha256"], name
    assert total <= 512 * 1024
