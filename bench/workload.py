"""The one traffic generator: reads a mix's parameters and draws the
requests of a run from its seed.

A mix (``traffic/<name>.json``) is open or closed:

* ``"loop": "open"``: ``rate_qps`` queries a second arrive as a Poisson
  process over the whole window, each due at a fixed time whether or not
  the system keeps up;
* ``"loop": "closed"``: ``clients`` callers, each sending its next query
  when its previous one has completed.

``prompt`` and ``output`` give the length distributions (``lognormal`` by
``median`` and ``sigma``, ``loguniform`` or ``uniform``), clipped to
``[min, max]``. Prompt tokens are uniform over the vocabulary.

Every seed gets the same multiset of lengths and of gaps between arrivals,
in another order: the i-th of n values is the distribution's quantile at
(i + 1/2) / n, and the seed shuffles them and draws the tokens. So two
seeds run the same amount of work and differ only in its order and its
token ids. A closed loop uses only the head of its stream, so its mix
may give a ``block``: then every run of ``block`` requests in the stream
holds the same multiset of lengths (the quantiles of ``block`` draws),
each block shuffled on its own.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np

STREAM_PER_CLIENT = 32   # requests drawn for each client of a closed loop


@dataclasses.dataclass
class Request:
    prompt: np.ndarray       # int32 token ids
    max_new: int
    due: float = 0.0         # seconds after the window opens (open loop)


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n stratified quantiles of a length distribution, as ints."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = dist["min"], dist["max"]
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
        v = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    elif kind == "loguniform":
        v = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    elif kind == "uniform":
        v = lo + q * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def count(mix: dict, seconds: float) -> int:
    """Requests a run draws: the open loop's arrivals in the window, or
    the closed loop's stream (enough that no client runs out)."""
    if mix["loop"] == "open":
        return max(1, round(mix["rate_qps"] * seconds))
    if mix["loop"] == "closed":
        return mix["clients"] * STREAM_PER_CLIENT
    raise ValueError(f"unknown loop {mix['loop']!r}")


def draw(mix: dict, seconds: float, seed: int, vocab: int) -> List[Request]:
    """The run's requests, in the order they are sent."""
    n = count(mix, seconds)
    rng = np.random.default_rng(seed)
    block = mix.get("block", n)
    plens, outs = (np.concatenate([
        rng.permutation(quantiles(mix[key], block))
        for _ in range(-(-n // block))])[:n] for key in ("prompt", "output"))
    due = np.zeros(n)
    if mix["loop"] == "open":
        q = (np.arange(n) + 0.5) / n
        gaps = rng.permutation(-np.log1p(-q) / mix["rate_qps"])
        # the first query is due at 0, the last before the window closes:
        # n arrivals over the window, at rate_qps on average
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        due *= seconds * (n - 0.5) / n / max(float(np.sum(gaps[:-1])), 1e-9) \
            if n > 1 else 0.0
    return [Request(rng.integers(0, vocab, size=int(p), dtype=np.int32),
                    int(m), float(t)) for p, m, t in zip(plens, outs, due)]
