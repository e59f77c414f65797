"""Milliseconds a request's device idles inside the program's
``serve.forward`` spans, over the traced window's requests. On an eager
request the span holds the model's launches; on a replayed one (a CUDA
graph, the predictor's path on the card from a signature's third call) it
holds only the enqueue of the replay and two clones, and closes before
the device runs the graph. The metric is not comparable across that
change: before it, it read the device waiting on the forward's host work."""

from benchmark.metrics._spans import idle_in_ms_per


def read(run):
    return idle_in_ms_per(run, "serve.forward", "requests")
