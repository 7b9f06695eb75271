"""Model interface over the ported families (``repro.models.model``).

``build_model(cfg, device)`` returns a ``Model`` with

* ``init(seed) -> params``: seeded random weights on the model's device;
* ``prefill(params, batch) -> (logits, cache)``: ``batch`` carries
  ``"tokens"`` (B, S) and optionally ``"length"`` (B,) valid prefix lengths
  of right-padded prompts;
* ``decode(params, cache, token, pos) -> (logits, cache)``: one token per
  slot against a paged cache (``"k"``, ``"v"`` pools and a ``"bt"`` block
  table), updated in place.

Only the dense family is ported; the others raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (default CUDA; raises without it)."""
    dev = resolve_device(device)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    if dev.type == "cpu" and (cfg.attention_impl == "cuda"
                              or cfg.quantize == "int8_cuda"):
        raise ValueError(f"config {cfg.name!r} asks for the CUDA kernels "
                         "but the device is the CPU")

    def init(seed: int = 0):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return T.init_dense(cfg, gen, dev)

    return Model(
        cfg=cfg,
        device=dev,
        init=init,
        prefill=lambda p, b: T.prefill_dense(cfg, p, b["tokens"],
                                             length=b.get("length")),
        decode=lambda p, c, t, pos: T.decode_dense(cfg, p, c, t, pos),
    )
