"""The encoder's attention layers (models/layers.attention_fused and
surgery_attention_fused, whatever kernels they launch): their least time
from shapes (harness/flops.attention_layer) over the device time launched
under them, in percent."""
from portbench.harness import readers


def read(reading):
    return readers.roofline(reading, "attn", "attn_bound_s")
