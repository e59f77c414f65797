"""Milliseconds the loader's producer thread takes to read and assemble
one batch: the mean of the program's ``loader.batch`` spans in the
traced window."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "loader.batch")
