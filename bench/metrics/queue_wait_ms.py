"""queue_wait_ms: the mean wait (ms) of a query's request from its arrival
at the control plane to its first seat in an engine slot (prefill, chunked
seat or in-segment promotion), over the requests first seated in the
window (up to the profiled span in a traced run): the engine's
``timing.queue_wait_s`` over ``stats.first_seats``. None where the
program keeps no such counters."""


def read(run):
    if "stats.first_seats" not in run.counters["t0"]:
        return None
    n = run.delta("stats.first_seats")
    return run.delta("timing.queue_wait_s") / n * 1e3 if n else None
