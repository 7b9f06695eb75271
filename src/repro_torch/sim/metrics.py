"""Steady-state serving metrics of a cluster run: the port's own copy of
the two helpers ``repro``'s launcher takes from ``benchmarks/common.py``
(which imports ``repro``, so the port cannot)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.worker import Query


def pct(xs: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of ``xs``; NaN for an empty sequence."""
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def steady_metrics(queries: List[Query], t0: float, t1: float,
                   warmup: float = 20.0) -> Dict[str, float]:
    """Throughput and SLO-violation rate over [t0 + warmup, t1] (paper
    Fig. 13): completed queries, inputs per second, the violated share and
    the p50/p99 latency in ms."""
    done = [q for q in queries
            if t0 + warmup <= q.finish <= t1 and not q.failed]
    viol = [q for q in done if q.violated]
    lat = [q.latency for q in done]
    span = max(t1 - t0 - warmup, 1e-9)
    return {
        "completed": len(done),
        "throughput_qps": sum(q.n_inputs for q in done) / span,
        "violation_rate": len(viol) / max(len(done), 1),
        "p50_ms": pct(lat, 50) * 1e3,
        "p99_ms": pct(lat, 99) * 1e3,
    }
