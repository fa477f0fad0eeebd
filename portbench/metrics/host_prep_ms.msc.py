"""Host milliseconds an MSC batch spends being prepared on prefetch_iter's
thread: the program's dataset reads and engine/evaluate._prep_msc_batch
(the base and the four scales' resizes), mean a prepared batch."""
from portbench.harness import readers


def read(reading):
    return readers.host_ms(reading, ("prep_msc", "read"))
