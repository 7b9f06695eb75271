"""stepper_wait_share: the share (%) of the profiled span in which the
executor's stepper thread sat blocked on its job queue with no job in
flight: the union of the program's ``stepper.wait`` spans
(``repro_torch.tracing``, recorded while the profiler runs) inside the
span, over its length. None without a profiled span, or where the program
records no spans in it."""


def read(run):
    span = run.span
    if span is None or not span.window_s:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    a, b = span.t_start, span.t_stop
    recs = tracing.spans(a, b)
    if not recs:
        return None
    waits = sorted((max(s.t_start, a), min(s.t_end, b)) for s in recs
                   if s.name == "stepper.wait")
    idle, end = 0.0, a
    for lo, hi in waits:
        lo = max(lo, end)
        if hi > lo:
            idle += hi - lo
            end = hi
    return 100.0 * idle / (b - a)
