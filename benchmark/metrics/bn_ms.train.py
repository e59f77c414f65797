"""Device milliseconds of BatchNorm kernels (forward and backward, by
name) per training step of the traced window."""

KEYS = ("batch_norm", "batchnorm", "bn_fw", "bn_bw")


def is_bn(name: str, cat: str) -> bool:
    low = name.lower()
    return cat == "kernel" and "bn_relu_pool" not in low and any(
        k in low for k in KEYS)


def read(run):
    steps = run.counters.get("steps")
    if run.trace is None or not steps:
        return None
    us = run.trace.device_us(is_bn)
    return us / 1e3 / steps if us > 0 else None
