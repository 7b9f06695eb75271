"""stepper_outside_share: the share of the window (%) that the engine spent
outside its prefill and decode dispatches: the executor's stepper, the
worker and the control plane between dispatches, and waiting for work.
In a traced run, of the window up to the profiled span."""


def read(run):
    inside = run.delta("timing.prefill_s") + run.delta("timing.decode_s")
    if not inside:
        return None
    return 100.0 * (1.0 - inside / (run.t_read - run.t0))
