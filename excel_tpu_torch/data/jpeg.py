"""JPEG without Pillow: the host decoder `native/jpeg.cpp` (built with g++
at first use into the port's `_build/`, called through ctypes, which
releases the interpreter lock, so the loader's threads decode in parallel).

It gives the bytes of Pillow's decode (libjpeg-turbo with its default
parameters): `np.asarray(Image.open(p).convert("RGB"))` for colour files and
`np.asarray(Image.open(p))`, [h, w], for greyscale ones. It takes baseline,
extended-sequential and progressive Huffman JPEGs of 8-bit samples with 1
or 3 components. `supported(data)` tells, from the markers alone (the
decoder's own parser walks the frame header and every scan header and
skips the entropy-coded data), whether a file is one of those; it is not
when it is
- arithmetic-coded (SOF9-11, SOF13-15), lossless (SOF3) or hierarchical
  (SOF5-7, DHP, EXP);
- of 12-bit (or other than 8-bit) samples;
- of another component count than 1 or 3 (CMYK / YCCK have 4);
- of fractional sampling factors, or of no height (DNL);
- progressive with scans that leave any of the first 10 coefficients of a
  component incomplete, where libjpeg-turbo smooths the blocks.
A corrupt or truncated stream raises ValueError; nothing is filled in.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np

from .. import build

_lock = threading.Lock()
_lib = None

_SOF_KINDS = {0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
              0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical (SOF7)",
              0xC9: "arithmetic-coded (SOF9)",
              0xCA: "arithmetic-coded (SOF10)",
              0xCB: "arithmetic-coded (SOF11)",
              0xCD: "arithmetic-coded hierarchical (SOF13)",
              0xCE: "arithmetic-coded hierarchical (SOF14)",
              0xCF: "arithmetic-coded hierarchical (SOF15)",
              0xDE: "hierarchical (DHP)", 0xDF: "hierarchical (EXP)"}


def is_jpeg(header: bytes) -> bool:
    return header[:3] == b"\xff\xd8\xff"


def _load():
    global _lib
    with _lock:
        if _lib is None:
            build.build_host("jpeg")
            lib = ctypes.CDLL(build.host_library_path("jpeg"))
            lib.excel_jpeg_probe.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
                ctypes.c_int]
            lib.excel_jpeg_probe.restype = ctypes.c_int
            lib.excel_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                ctypes.c_int]
            lib.excel_jpeg_decode.restype = ctypes.c_int
            _lib = lib
        return _lib


@dataclasses.dataclass(frozen=True)
class JpegHeader:
    """What the markers say: size, components, and the variant that the
    decoder does not take (None when it takes the file)."""
    height: int
    width: int
    components: int
    unsupported: str | None


def _variant(code: int, precision: int, components: int) -> str | None:
    """The text of a variant code of native/jpeg.cpp (its enum Variant, or
    the marker code of a frame of another kind)."""
    if code in _SOF_KINDS:
        return _SOF_KINDS[code] + " JPEG"
    return {
        0: None,
        1: f"{precision}-bit JPEG",
        2: (f"{components}-component JPEG"
            + (" (CMYK / YCCK)" if components == 4 else "")),
        3: "JPEG whose height is given by DNL",
        4: "JPEG of fractional sampling factors",
        5: ("progressive JPEG whose scans leave coefficients incomplete "
            "(libjpeg-turbo smooths its blocks)"),
    }[code]


def probe(data: bytes) -> JpegHeader:
    """Walk the markers of a JPEG (native/jpeg.cpp's parser, the
    entropy-coded data skipped); raises ValueError where they are
    malformed."""
    info = (ctypes.c_int32 * 5)()
    err = ctypes.create_string_buffer(256)
    if _load().excel_jpeg_probe(data, len(data), info, err, len(err)):
        raise ValueError(f"corrupt JPEG: {err.value.decode()}")
    height, width, components, precision, code = info
    return JpegHeader(height, width, components,
                      _variant(code, precision, components))


def unsupported_variant(data: bytes) -> str | None:
    """The variant of this JPEG that `decode_jpeg` does not take, from its
    markers alone; None when it takes it, or when the markers are malformed
    (`decode_jpeg` then raises ValueError)."""
    try:
        return probe(data).unsupported
    except ValueError:
        return None


def supported(data: bytes) -> bool:
    """Whether `decode_jpeg` takes this JPEG, from its markers alone."""
    return unsupported_variant(data) is None


def decode_jpeg(data: bytes) -> np.ndarray:
    """uint8 [h, w, 3] RGB, or [h, w] for a greyscale file."""
    header = probe(data)
    if header.unsupported:
        raise ValueError(f"{header.unsupported}: the port's decoder does "
                         "not take it")
    shape = ((header.height, header.width) if header.components == 1 else
             (header.height, header.width, 3))
    out = np.empty(shape, np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = _load().excel_jpeg_decode(data, len(data), out.ctypes.data,
                                   header.height, header.width,
                                   header.components, err, len(err))
    if rc != 0:
        raise ValueError(f"corrupt JPEG: {err.value.decode()}")
    return out
