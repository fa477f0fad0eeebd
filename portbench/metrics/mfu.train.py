"""Matrix-product FLOPs of the window's work, counted from shapes
(harness/flops.py), over the traced window and the compute type's published
peak, in percent."""
from portbench.harness import readers


def read(reading):
    return readers.mfu(reading)
