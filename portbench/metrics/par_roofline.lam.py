"""PAR as a whole (ops/par.par_refine): its least time from shapes
(harness/flops.par_layer, fp32 outside the tensor cores) over the device
time launched under it, in percent."""
from portbench.harness import readers


def read(reading):
    return readers.roofline(reading, "par", "par_bound_s")
