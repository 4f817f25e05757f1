"""The device's idle share over the stretch: 1 - (the union of its
activity intervals) / (the stretch's host wall), in percent."""

from benchmark import readers


def read(r):
    return readers.idle_share(r)
