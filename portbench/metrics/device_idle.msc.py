"""Share of the traced window in which no kernel, copy or set ran on the
device (profiler trace), in percent."""
from portbench.harness import readers


def read(reading):
    return readers.device_idle(reading)
