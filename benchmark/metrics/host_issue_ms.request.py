"""Milliseconds the host takes to hand one request to the device: the
mean of the program's ``serve.request`` spans (``Predictor.__call__``,
from the raw arrays to the last launch) in the traced window."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "serve.request")
