"""mfu: the operations the window's work needs over the engine's dispatch
time at the chip's bf16 peak (%). The work is counted from the client's
record: the prefill of every prompt whose first token arrived in the
window (its projections over the valid tokens, causal attention, the head
once) and the decode step of every later token that arrived in it (every
projection, attention over the real context, the head). The dispatch time
is the engine's host time around its prefill and decode dispatches over
the window, each ending in its host sync. In a traced run the window ends
where the profiled span opens."""


def read(run):
    c, cfg = run.costs, run.cfg
    flops = 0.0
    for q in run.queries:
        first = q.first()
        if first is not None and run.t0 <= first < run.t_read:
            flops += c.prefill_flops(cfg, q.plen)
    for q, i in run.tokens_in(run.t0, run.t_read):
        if i >= 1:
            flops += c.decode_flops(cfg, q.plen + i)
    busy = run.delta("timing.prefill_s") + run.delta("timing.decode_s")
    if not busy or not flops:
        return None
    return 100.0 * flops / (busy * c.BF16_FLOPS)
