"""SigLIP's attention-pooling head (models/clip.map_head: both streams'
post_layernorm, the probe's attention over the original stream, the value
path of the dense one, the out-projection, LayerNorm and MLP over the
1 + n rows, whatever kernels they launch): its least time from shapes
(harness/siglip_counts.map_head_layer) over the device time launched under
the SigLIP sweep's `map_head` wrapper, in percent."""
from portbench.harness import readers


def read(reading):
    return readers.roofline(reading, "map_head", "map_head_bound_s")
