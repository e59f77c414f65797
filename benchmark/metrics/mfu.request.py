"""The whole forward's share of the chip's peak (per cent), over every
knee scored in the traced window."""

from benchmark.metrics._common import mfu


def read(run):
    return mfu(run)
