"""The device's idle share of the traced window (per cent)."""

from benchmark.metrics._common import idle_share


def read(run):
    return idle_share(run)
