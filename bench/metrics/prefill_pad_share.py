"""prefill_pad_share: the share (%) of the prompt tokens that the window's
prefill dispatches computed as padding (rows past the live ones of an
admit batch, positions past a prompt within its bucket): 1 - the engine's
``stats.prefill_tokens`` over ``stats.prefill_tokens_padded`` (nbatch x
bucket a dispatch), up to the profiled span in a traced run. None where
the program keeps no such counters."""


def read(run):
    if "stats.prefill_tokens_padded" not in run.counters["t0"]:
        return None
    padded = run.delta("stats.prefill_tokens_padded")
    if not padded:
        return None
    return 100.0 * (1.0 - run.delta("stats.prefill_tokens") / padded)
