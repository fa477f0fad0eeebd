"""Pure-Python TensorBoard event-file writer (the port's copy of
excel_tpu/utils/tb.py; no tensorboard, Pillow or torch writer needed).

It writes the two formats TensorBoard reads:

* the TFRecord framing (length + masked CRC32C + payload + masked CRC32C),
* the subset of the `Event`/`Summary` protobufs the scalar and image
  dashboards need (tensorflow/core/util/event.proto,
  tensorflow/core/framework/summary.proto).

Images are PNG-encoded by the port's own codec (data/png.py). Scalar
events are byte for byte the JAX package's writer's at the same
`time.time()`; tests/test_torch_tb.py parses the files with the installed
`tensorboard` package.
"""
from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from ..data.png import encode_png

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — the TFRecord checksum
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    # protobuf varints are uint64; a negative int would shift forever
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class SummaryWriter:
    """The two SummaryWriter methods the trainer uses: `add_scalar(tag,
    value, step)` and `add_image(tag, img, step, dataformats='HWC')` (uint8
    RGB or greyscale arrays, PNG-encoded by data/png.py)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        # pid suffix (as torch's writer does): two processes starting the
        # same second on one host must not interleave one TFRecord stream
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self._f = open(os.path.join(log_dir, fname), "ab")
        # every event file starts with a file_version event
        self._write_event(_pb_double(1, time.time())
                          + _pb_bytes(3, b"brain.Event:2"))

    def _write_event(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event)
        self._f.write(struct.pack("<I", _masked_crc(event)))
        self._f.flush()

    def _summary_event(self, summary: bytes, step: int) -> None:
        self._write_event(_pb_double(1, time.time())
                          + _pb_varint(2, int(step))
                          + _pb_bytes(5, summary))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        value_msg = (_pb_bytes(1, tag.encode())
                     + _pb_float(2, float(value)))
        self._summary_event(_pb_bytes(1, value_msg), step)

    def add_image(self, tag: str, img, step: int,
                  dataformats: str = "HWC") -> None:
        img = np.asarray(img)
        if dataformats == "CHW":
            img = img.transpose(1, 2, 0)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        if img.ndim == 3 and img.shape[2] == 1:
            img = img[:, :, 0]
        h, w = img.shape[:2]
        image_msg = (_pb_varint(1, h) + _pb_varint(2, w)
                     + _pb_varint(3, img.shape[2] if img.ndim == 3 else 1)
                     + _pb_bytes(4, encode_png(img)))
        value_msg = _pb_bytes(1, tag.encode()) + _pb_bytes(4, image_msg)
        self._summary_event(_pb_bytes(1, value_msg), step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
