"""Device milliseconds per global step of the traced window in which an
NCCL kernel (by name) runs on the first rank's card: the exchange between
the ranks (the gradients' all-reduce, the global BatchNorm's gathers and
sums, the loss's all-reduce). An NCCL kernel runs until every rank has
joined it, so its time holds the wait for the slowest rank."""

from benchmark.metrics._nccl import is_nccl, per_step_ms


def busy_us(trace) -> float:
    return sum(e - s for s, e in trace.intervals(is_nccl))


def read(run):
    return per_step_ms(run, busy_us)
