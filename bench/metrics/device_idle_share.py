"""device_idle_share: the share of the profiled span (%) in which no
operation ran on the device: 1 - the union of its intervals over the
span."""


def read(run):
    span = run.span
    if span is None or not span.window_s or not span.kernels:
        return None
    return 100.0 * (1.0 - span.busy_s() / span.window_s)
