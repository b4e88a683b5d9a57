"""idle_share.train: the share of the traced span in which no operation ran
on the device, in % (complete traces only)."""

from perfbench import readers


def read(reading):
    return readers.idle_share(reading)
