"""idle_forward.train: device-idle time inside the program's
``train.forward`` spans of the training step, over the traced span, in %
(complete traces only)."""

from perfbench import spans


def read(reading):
    return spans.idle_inside(reading, "train.forward")
