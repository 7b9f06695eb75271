"""flash_roofline: the least time the chip could take for the prefill
attention of the prompts whose first token arrived in the profiled span
(each layer's causal attention over the valid prompt), over the device time
of the flash kernels in that span (%)."""


def read(run):
    span = run.span
    if span is None:
        return None
    c, cfg = run.costs, run.cfg
    dev_s = span.class_s("flash_attention")
    flops = nbytes = 0.0
    for q in run.queries:
        first = q.first()
        if first is not None and span.t_start <= first < span.t_stop:
            f, b = c.flash(q.plen, cfg["num_attention_heads"],
                           cfg["num_key_value_heads"], cfg["head_dim"])
            flops += f
            nbytes += b
    if not dev_s or not flops:
        return None
    L = cfg["num_hidden_layers"]
    t, _ = c.roofline_s(L * flops, L * nbytes)
    return 100.0 * t / dev_s
