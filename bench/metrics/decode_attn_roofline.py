"""decode_attn_roofline: the least time the chip could take for the KV
write and the attention of every decode step of the tokens that arrived in
the profiled span, each at its row's real context, over the device time of
the fused paged decode kernel in that span (%)."""


def read(run):
    span = run.span
    if span is None:
        return None
    c, cfg = run.costs, run.cfg
    dev_s = span.class_s("fused_paged_decode")
    flops = nbytes = 0.0
    for q, i in run.tokens_in(span.t_start, span.t_stop):
        if i >= 1:
            f, b = c.decode_attn(q.plen + i, cfg["num_attention_heads"],
                                 cfg["num_key_value_heads"], cfg["head_dim"])
            flops += f
            nbytes += b
    if not dev_s or not flops:
        return None
    L = cfg["num_hidden_layers"]
    t, _ = c.roofline_s(L * flops, L * nbytes)
    return 100.0 * t / dev_s
