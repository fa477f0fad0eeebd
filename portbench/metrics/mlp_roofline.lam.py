"""The encoder blocks' MLPs (models/clip.mlp: fc, the activation, proj,
whatever kernels they launch): their least time from shapes
(harness/mlp_counts.mlp_layer) over the device time launched under the
driver's `mlp` wrapper, in percent."""
from portbench.harness import readers


def read(reading):
    return readers.roofline(reading, "mlp", "mlp_bound_s")
