"""prefill_ms_per_dispatch: the engine's host time around its prefill
dispatches (each ends in its host sync) over their number, in the window
(up to the profiled span in a traced run)."""


def read(run):
    n = run.delta("stats.prefill_dispatches")
    return run.delta("timing.prefill_s") / n * 1e3 if n else None
