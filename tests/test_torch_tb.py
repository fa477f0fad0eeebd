"""The port's TensorBoard writer (excel_tpu_torch.utils.tb) against the JAX
package's and the installed `tensorboard` package: the event file parses,
its CRCs are tensorboard's, its scalar records are byte-equal to the JAX
writer's at the same clock, and its PNG images decode (through the port's
codec and through Pillow) to the pixels given. Then utils.profiling on the
CPU."""
import glob
import os

import numpy as np
import pytest
import torch

from excel_tpu.utils import tb as jtb
from excel_tpu_torch.data.png import decode_png
from excel_tpu_torch.utils import profiling
from excel_tpu_torch.utils import tb as ptb


def _records(path):
    """TFRecord payloads, each length and payload checked against its
    masked CRC32C as tensorboard computes it."""
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (
        masked_crc32c)

    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = np.frombuffer(header, "<u8")
        assert int.from_bytes(data[pos + 8:pos + 12], "little") == \
            masked_crc32c(header)
        payload = data[pos + 12:pos + 12 + int(length)]
        end = pos + 12 + int(length)
        assert int.from_bytes(data[end:end + 4], "little") == \
            masked_crc32c(payload)
        out.append(payload)
        pos = end + 4
    return out


def _write(module, logdir, monkeypatch, image):
    monkeypatch.setattr(module.time, "time", lambda: 1700000000.25)
    w = module.SummaryWriter(str(logdir))
    w.add_scalar("train/seg_loss", 0.6931471805599453, 3)
    w.add_scalar("train/lr", 5e-4, 3)
    w.add_scalar("val/pseudo_miou", float(np.float32(0.25)), 10)
    w.add_image("val/panel", image, 10, dataformats="HWC")
    w.add_image("val/chw", image.transpose(2, 0, 1), 11, dataformats="CHW")
    w.close()
    (path,) = glob.glob(os.path.join(str(logdir), "events.out.tfevents.*"))
    return path


def test_event_file_parses_and_matches_the_jax_writer(tmp_path, monkeypatch):
    event_pb2 = pytest.importorskip("tensorboard.compat.proto.event_pb2")
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    port = _records(_write(ptb, tmp_path / "port", monkeypatch, image))
    ref = _records(_write(jtb, tmp_path / "jax", monkeypatch, image))
    assert len(port) == len(ref) == 6     # file_version, 3 scalars, 2 images
    # the file_version event and the scalars, byte for byte
    assert port[:4] == ref[:4]
    events = [event_pb2.Event.FromString(r) for r in port]
    assert events[0].file_version == "brain.Event:2"
    assert events[0].wall_time == 1700000000.25
    for e, (tag, value, step) in zip(events[1:4], [
            ("train/seg_loss", 0.6931471805599453, 3),
            ("train/lr", 5e-4, 3), ("val/pseudo_miou", 0.25, 10)]):
        assert e.step == step and e.summary.value[0].tag == tag
        assert e.summary.value[0].simple_value == np.float32(value)
    from PIL import Image
    import io

    for e, r, step in zip(events[4:], ref[4:], (10, 11)):
        im = e.summary.value[0].image
        jim = event_pb2.Event.FromString(r).summary.value[0].image
        assert e.step == step
        assert (im.height, im.width, im.colorspace) == (5, 7, 3) == (
            jim.height, jim.width, jim.colorspace)
        pixels, palette = decode_png(im.encoded_image_string)
        assert palette is None
        np.testing.assert_array_equal(pixels, image)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(im.encoded_image_string))),
            image)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(jim.encoded_image_string))),
            pixels)


def test_float_images_and_crc_of_large_records(tmp_path):
    """A float image in [0, 1] is scaled to bytes as the JAX writer does;
    a record of 100 kB checks against tensorboard's CRC."""
    event_pb2 = pytest.importorskip("tensorboard.compat.proto.event_pb2")
    rng = np.random.default_rng(1)
    w = ptb.SummaryWriter(str(tmp_path))
    img = rng.random((6, 4, 3)).astype(np.float32)
    w.add_image("f", img, 0)
    w.add_image("big", rng.integers(0, 256, (190, 180, 3), np.uint8), 1)
    w.close()
    (path,) = glob.glob(os.path.join(str(tmp_path), "events.out.tfevents.*"))
    records = _records(path)
    assert len(records[2]) > 100_000
    im = event_pb2.Event.FromString(records[1]).summary.value[0].image
    pixels, _ = decode_png(im.encoded_image_string)
    np.testing.assert_array_equal(
        pixels, (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))


def test_profiling_on_the_cpu(tmp_path):
    """trace writes a Chrome trace with the block's ops and the program's
    spans, and the spans' snapshot beside it; the spans are off again
    after the block."""
    import json

    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", n=2):
            profiling.count("calls", 2)
            (x @ x).sum()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::mm", "excel.outer"} <= names
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)
    assert spans["counters"] == {"calls": 2}
    assert spans["spans"]["outer"]["count"] == 1
    assert 0 < spans["spans"]["outer"]["self_s"] <= \
        spans["spans"]["outer"]["total_s"]
    assert not profiling.enabled()
