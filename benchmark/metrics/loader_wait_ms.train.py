"""Milliseconds a training step waited for the loader's batch: the
trainer's own ``timing["loader_wait"]`` over the window's steps."""


def read(run):
    steps = run.counters.get("steps")
    if not steps or "loader_wait_s" not in run.counters:
        return None
    return 1e3 * run.counters["loader_wait_s"] / steps
