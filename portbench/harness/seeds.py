"""Sub-seeds of a run's --seed, one per use, so that the same seed gives
the same inputs, weights and samples."""
from __future__ import annotations

import hashlib


def sub_seed(seed: int, tag: str, bits: int = 63) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> (64 - bits)
