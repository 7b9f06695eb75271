"""latency_p95_ms: the 95th percentile, over every query sent in an open
loop's window, of the time from when it was due to the arrival of its last
token. A query that failed, or whose last token never came, counts as
waiting until the answers stopped being awaited."""
import numpy as np


def read(run):
    if run.loop != "open" or not run.queries:
        return None
    v = [((q.last() if q.ok and q.last() is not None else run.t_end)
          - q.due) for q in run.queries]
    return float(np.percentile(v, 95)) * 1e3
