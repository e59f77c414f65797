"""Milliseconds a request's device idles inside the program's
``serve.forward`` spans (the model's launches), over the traced window's
requests: the device waiting on the forward's host work."""

from benchmark.metrics._spans import idle_in_ms_per


def read(run):
    return idle_in_ms_per(run, "serve.forward", "requests")
