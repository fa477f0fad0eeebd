"""Images of the window's work over its wall on the host's clock: the
sweep's or the training's pace as a user waits for it, held back by the
host (PERF.md, section 2), so reported per layer, without a bound."""
from portbench.harness import readers


def read(reading):
    return readers.wall_rate(reading)
