"""EVA-02's SwiGLU gate and sub-LayerNorm alone (models/layers.
swiglu_gate_fused, csrc/swiglu_gate.cu on the card): its least time from
its bytes (harness/eva02_counts.swiglu_gate_bytes: 2 h read and h written
a token) over the device time launched under the EVA-02 sweep's `swiglu_gate`
wrapper, in percent."""
from portbench.harness import readers


def read(reading):
    return readers.roofline(reading, "swiglu_gate", "swiglu_gate_bound_s")
