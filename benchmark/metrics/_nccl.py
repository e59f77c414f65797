"""What the readers of the exchange between the ranks share: NCCL's
kernels by name, and the device time in which they run alone."""


def is_nccl(name: str, cat: str) -> bool:
    return cat == "kernel" and "nccl" in name.lower()


def is_other_kernel(name: str, cat: str) -> bool:
    return cat == "kernel" and not is_nccl(name, cat)


def overlap_us(a: list, b: list) -> float:
    """µs that two lists of merged, sorted (start, end) intervals share."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def per_step_ms(run, us_of_trace):
    """``us_of_trace(trace)`` in ms over the window's steps; None without
    a trace, steps or NCCL kernels."""
    steps = run.counters.get("steps")
    t = run.trace
    if t is None or not steps or not t.intervals(is_nccl):
        return None
    return us_of_trace(t) / 1e3 / steps
