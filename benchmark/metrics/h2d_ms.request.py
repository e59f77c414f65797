"""Device milliseconds of host-to-device copies per request of the traced
window."""


def is_h2d(name: str, cat: str) -> bool:
    return cat == "gpu_memcpy" and "HtoD" in name


def read(run):
    requests = run.counters.get("requests")
    if run.trace is None or not requests:
        return None
    us = run.trace.device_us(is_h2d)
    return us / 1e3 / requests if us > 0 else None
