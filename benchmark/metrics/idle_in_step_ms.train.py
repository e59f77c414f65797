"""Milliseconds a training step's device idles inside the program's
``train.step`` spans (``TrainRuntime.train_step``: upload, augmentation,
forward, backward, update), over the traced window's steps."""

from benchmark.metrics._spans import idle_in_ms_per


def read(run):
    return idle_in_ms_per(run, "train.step", "steps")
