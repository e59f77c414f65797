"""K5's share of its roofline (per cent): the least time of every int8
convolution of the traced window's requests (counts/k5.py) over the
device time of the kernels named ``int8_conv``."""

from benchmark.counts.k5 import request_bound_s


def is_k5(name: str, cat: str) -> bool:
    return cat == "kernel" and "int8_conv" in name


def read(run):
    requests = run.counters.get("requests")
    if run.trace is None or not requests:
        return None
    us = run.trace.device_us(is_k5)
    if us <= 0:
        return None
    bound = requests * request_bound_s(run.cell["model"],
                                       int(run.cell["traffic"]["batch"]))
    return 100.0 * bound / (us / 1e6)
