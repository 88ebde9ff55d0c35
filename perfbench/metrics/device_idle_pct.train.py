"""The share of the traced window in which no operation ran on the card
(the union of the profiler's device events), in a training cell."""


def read(run):
    s = run.summary
    if s is None or s.window_us <= 0 or not s.kernels:
        return None
    return 100.0 * (1.0 - s.busy_us / s.window_us)
