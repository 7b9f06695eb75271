"""gen_tokens_per_s: generated tokens that arrived at the clients inside
the window, over the window's seconds."""


def read(run):
    n = sum(1 for _ in run.tokens_in(run.t0, run.t1))
    return n / run.seconds
