"""decode_ms_per_step: the engine's host time around its decode segments
(each ends in its host sync) over the decode steps they ran, in the
window (up to the profiled span in a traced run)."""


def read(run):
    n = run.delta("stats.decode_steps")
    return run.delta("timing.decode_s") / n * 1e3 if n else None
