"""int8_roofline: the least time the chip could take for the int8
projections of the profiled span, over the int8 kernels' device time (%).
Each decode step and each prefill dispatch reads every int8 weight and
its scales once (the engine's step and dispatch counts over the span);
x and y count at the live rows only: one a token that arrived in the span,
and the valid prompt tokens of the prompts whose first token did."""


def read(run):
    span = run.span
    cfg = run.cfg
    if span is None or cfg.get("quantize") != "int8":
        return None
    c = run.costs
    dev_s = span.class_s("int8_matmul")
    a, b = span.marks["start"], span.marks["stop"]
    dispatches = (b["stats.decode_steps"] - a["stats.decode_steps"]
                  + b["stats.prefill_dispatches"]
                  - a["stats.prefill_dispatches"])
    rows = sum(1 for _, i in run.tokens_in(span.t_start, span.t_stop)
               if i >= 1)
    rows += sum(q.plen for q in run.queries
                if q.first() is not None
                and span.t_start <= q.first() < span.t_stop)
    w_flops, w_bytes = c.int8_step(cfg, 0)
    r_flops, r_bytes = c.int8_step(cfg, 1)
    flops = rows * (r_flops - w_flops)
    nbytes = dispatches * w_bytes + rows * (r_bytes - w_bytes)
    if not dev_s or not dispatches:
        return None
    t, _ = c.roofline_s(flops, nbytes)
    return 100.0 * t / dev_s
