"""EVA-02's SwiGLU MLPs (models/clip.swiglu: the W1|W2 product, the gate and
its sub-LayerNorm, W3, whatever kernels they launch): their least time from
shapes (harness/eva02_counts.swiglu_layer, 6 n c h FLOPs an image against
the input, weights, biases and output) over the device time launched under
the EVA-02 sweep's `swiglu` wrapper, in percent."""
from portbench.harness import readers


def read(reading):
    return readers.roofline(reading, "swiglu", "swiglu_bound_s")
