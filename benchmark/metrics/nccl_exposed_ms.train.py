"""Device milliseconds per global step of the traced window in which an
NCCL kernel runs on the first rank's card and no other kernel does: the
exchange's time that no computation hides, which overlapping the
all-reduce with the backward pass would shrink."""

from benchmark.metrics._nccl import (is_nccl, is_other_kernel, overlap_us,
                                     per_step_ms)


def exposed_us(trace) -> float:
    nccl = trace.intervals(is_nccl)
    return (sum(e - s for s, e in nccl)
            - overlap_us(nccl, trace.intervals(is_other_kernel)))


def read(run):
    return per_step_ms(run, exposed_us)
