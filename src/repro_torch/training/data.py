"""Synthetic but deterministic data (the port's copy of
``repro.training.data``).

A reproducible token stream per (seed, shard) with next-token structure (a
noisy linear-congruential language), so the training loss falls: enough
signal to check the training path end to end without a dataset. Shards
are indexed by data-parallel rank, and a restart resumes mid-stream from
the step index. Pure numpy: ``batch_at_step`` gives ``repro``'s arrays bit
for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    noise: float = 0.05


def _lcg_tokens(rng: np.random.Generator, n: int, vocab: int,
                noise: float) -> np.ndarray:
    """x_{t+1} = (a*x_t + c) % vocab, with occasional random resets."""
    a = 6364136223846793005 % vocab or 1
    c = 1442695040888963407 % vocab
    x = np.empty(n, np.int64)
    x[0] = rng.integers(0, vocab)
    noise_mask = rng.random(n) < noise
    rand = rng.integers(0, vocab, n)
    for t in range(1, n):
        x[t] = rand[t] if noise_mask[t] else (a * x[t - 1] + c) % vocab
    return x


def batch_at_step(cfg: ArchConfig, dcfg: DataConfig,
                  step: int) -> Dict[str, np.ndarray]:
    """The batch of a global step (restart-safe): int32 ``"tokens"`` and
    ``"targets"`` (B, S), and the family's f32 encoder input."""
    rng = np.random.default_rng(
        (dcfg.seed * 1_000_003 + step) * 97 + dcfg.shard)
    n = dcfg.batch * (dcfg.seq + 1)
    toks = _lcg_tokens(rng, n, cfg.vocab, dcfg.noise)
    toks = toks.reshape(dcfg.batch, dcfg.seq + 1)
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "targets": toks[:, 1:].astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (dcfg.batch, dcfg.seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (dcfg.batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def stream(cfg: ArchConfig, dcfg: DataConfig,
           start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at_step(cfg, dcfg, step)
        step += 1
