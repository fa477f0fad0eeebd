"""EVA-02's rotating qkv head split alone (models/layers.qkv_heads_kernel
with a rotary table, csrc/qkv_heads.cu's rope entry points on the card):
its least time from its bytes (harness/eva02_counts.qkv_rope_bytes: the
qkv product and the table read, q, k and v written) over the device time
launched under the EVA-02 sweep's `qkv_rope` wrapper, in percent."""
from portbench.harness import readers


def read(reading):
    return readers.roofline(reading, "qkv_rope", "qkv_rope_bound_s")
