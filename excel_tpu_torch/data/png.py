"""PNG without Pillow: a small decoder and encoder over zlib and numpy.

The machine with the card has no Pillow, and the port reads and writes the
dataset's label masks, the synthetic trees' images, prediction PNGs and CAM
overlays itself.

Decoder: non-interlaced PNGs of 8-bit greyscale, palette (1, 2, 4 or 8
bits; the indices are returned, as Pillow's "P" mode gives them, with the
palette beside them), RGB and RGBA, scanline filters 0-4, every chunk's CRC
checked. Interlaced files, other bit depths and grey + alpha raise.
Encoder: greyscale, palette and RGB at 8 bits, filter 0 on every row.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}       # colour type -> samples a pixel


def is_png(header: bytes) -> bool:
    return header[:8] == SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: raw holds height rows of 1 filter byte +
    stride bytes; bpp is the filters' byte distance (at least 1)."""
    out = np.zeros((height, stride), np.uint8)
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError("PNG image data of the wrong size")
    rows = rows.reshape(height, stride + 1)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:                                     # Sub
            cur = np.empty(stride, np.uint8)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(line[c::bpp], dtype=np.uint8)
        elif kind == 2:                                     # Up
            cur = line + prior
        elif kind in (3, 4):                                # Average, Paeth
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + up[x]) >> 1
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind} is not 0-4")
        out[r] = cur
        prior = out[r]
    return out


def decode_png(data: bytes) -> tuple[np.ndarray, np.ndarray | None]:
    """PNG bytes -> (pixels, palette): uint8 [h, w] for greyscale and
    palette (the indices), [h, w, 3] RGB, [h, w, 4] RGBA; the palette is
    uint8 [n, 3] for palette images, else None."""
    if not is_png(data):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNGs are not supported; re-save the "
                         "file without interlacing")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported "
                         "(greyscale, palette, RGB or RGBA)")
    allowed = (1, 2, 4, 8) if ctype == 3 else (8,)
    if depth not in allowed:
        raise ValueError(f"PNG bit depth {depth} for colour type {ctype} is "
                         f"not supported ({allowed})")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride,
                     max(1, channels * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits * weights).sum(axis=-1, dtype=np.uint8)
    pixels = rows[:, :width * channels].reshape(height, width, channels)
    return (pixels[..., 0] if channels == 1 else pixels), (
        palette if ctype == 3 else None)


def read_png(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(pixels: np.ndarray, palette: np.ndarray | None = None) -> bytes:
    """uint8 [h, w] (greyscale, or palette indices when `palette` [n, 3]
    is given) or [h, w, 3] RGB -> PNG bytes."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, not {pixels.dtype}")
    if pixels.ndim == 3 and pixels.shape[2] == 3 and palette is None:
        ctype = 2
    elif pixels.ndim == 2:
        ctype = 0 if palette is None else 3
    else:
        raise ValueError(f"cannot write pixels of shape {pixels.shape}")
    h, w = pixels.shape[:2]
    rows = pixels.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                  0, 0, 0))
    if palette is not None:
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
        if not 1 <= len(palette) <= 256:
            raise ValueError("a PNG palette has 1 to 256 entries")
        out += _chunk(b"PLTE", palette.tobytes())
    return (out + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray,
              palette: np.ndarray | None = None) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels, palette))
