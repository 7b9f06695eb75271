"""Assigned input-shape set (the port's own copy of ``repro.configs.shapes``;
it applies to every LM architecture).

Each shape names the entry point it lowers:
  * ``train_4k``    -> train_step   (training)
  * ``prefill_32k`` -> prefill_step (inference prefill, builds the cache)
  * ``decode_32k``  -> serve_step   (one new token, KV cache of seq_len)
  * ``long_500k``   -> serve_step   (sub-quadratic archs only)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def entry_point(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step",
                "decode": "serve_step"}[self.kind]


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; else the reason for the
    skip.

    ``long_500k`` needs sub-quadratic attention, so it is skipped for pure
    full-attention archs and runs for SSM/hybrid/linear-attention archs.
    No encoder-only archs are assigned, so decode shapes always apply.
    """
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skip: pure full-attention arch; 524k context requires "
                       "sub-quadratic sequence mixing (DESIGN.md §4)")
    return True, ""
