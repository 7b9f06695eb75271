"""Workload generation (paper §8.5): Poisson arrivals, Zipf model popularity,
time-varying load levels."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.sim.clock import EventLoop


def poisson_arrivals(loop: EventLoop, rate_fn: Callable[[float], float],
                     fire: Callable[[float], None], t_end: float,
                     seed: int = 0, rate_cap: float = 1e4) -> None:
    """Schedule a non-homogeneous Poisson process by thinning.

    ``rate_fn(t)`` in events/s; ``fire(t)`` called per arrival.
    """
    rng = np.random.default_rng(seed)
    lam_max = max(rate_cap * 1e-9 + max(
        rate_fn(t) for t in np.linspace(0, t_end, 257)), 1e-9)

    t = 0.0
    while t < t_end:
        t += rng.exponential(1.0 / lam_max)
        if t >= t_end:
            break
        if rng.random() < rate_fn(t) / lam_max:
            tt = t
            loop.schedule_at(tt, (lambda ts: lambda: fire(ts))(tt))


def zipf_weights(n: int, alpha: float = 1.0) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** alpha
    return w / w.sum()


@dataclasses.dataclass
class PopularitySplit:
    """Paper §8.5: 20% of models are popular and share 80% of the load."""
    popular: List[str]
    cold: List[str]
    weights: Dict[str, float]


def popularity_split(archs: Sequence[str], seed: int = 0,
                     popular_frac: float = 0.2,
                     popular_load: float = 0.8) -> PopularitySplit:
    archs = list(archs)
    n_pop = max(1, int(round(popular_frac * len(archs))))
    popular, cold = archs[:n_pop], archs[n_pop:]
    weights: Dict[str, float] = {}
    pw = zipf_weights(len(popular)) * popular_load
    for a, w in zip(popular, pw):
        weights[a] = float(w)
    if cold:
        cw = (1.0 - popular_load) / len(cold)
        for a in cold:
            weights[a] = cw
    else:
        for a in popular:
            weights[a] /= popular_load
    return PopularitySplit(popular, cold, weights)


def step_rate(levels: Sequence[Tuple[float, float]]) -> Callable[[float], float]:
    """levels: [(duration_s, rate), ...] -> piecewise-constant rate_fn."""
    bounds = []
    t = 0.0
    for dur, rate in levels:
        t += dur
        bounds.append((t, rate))

    def rate_fn(tt: float) -> float:
        for end, rate in bounds:
            if tt < end:
                return rate
        return bounds[-1][1] if bounds else 0.0
    return rate_fn


def ramp_rate(t_end: float, start: float, peak: float,
              symmetric: bool = True) -> Callable[[float], float]:
    """Linear ramp start->peak (->start if symmetric) over t_end seconds."""
    def rate_fn(t: float) -> float:
        if not symmetric:
            return start + (peak - start) * min(t / t_end, 1.0)
        half = t_end / 2
        if t <= half:
            return start + (peak - start) * (t / half)
        return peak - (peak - start) * ((t - half) / half)
    return rate_fn
