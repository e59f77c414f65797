"""The training step's share of the chip's peak (per cent): three times
the forward's products of every knee trained in the traced window."""

from benchmark.metrics._common import mfu


def read(run):
    return mfu(run, train=True)
