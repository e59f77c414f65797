"""Milliseconds a training step's device idles inside the program's
``train.loader_wait`` spans (``train_epoch`` blocked on the loader's
queue), over the traced window's steps."""

from benchmark.metrics._spans import idle_in_ms_per


def read(run):
    return idle_in_ms_per(run, "train.loader_wait", "steps")
