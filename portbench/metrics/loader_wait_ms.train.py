"""Host milliseconds the training loop blocks in next() on
data/loader.train_batches, mean a step of the window."""
from portbench.harness import readers


def read(reading):
    return readers.host_ms(reading, ("loader_wait",))
