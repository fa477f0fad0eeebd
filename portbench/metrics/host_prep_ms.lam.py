"""Host milliseconds a LAM batch spends being prepared on prefetch_iter's
thread: the program's dataset reads (decode, labels) and
engine/evaluate._prep_batch (resize, canvas labels), mean a prepared batch."""
from portbench.harness import readers


def read(reading):
    return readers.host_ms(reading, ("prep", "read"))
