"""Model interface over the ported families (``repro.models.model``).

``build_model(cfg, device)`` returns a ``Model`` with

* ``init(seed) -> params``: seeded random weights on the model's device;
* ``prefill(params, batch) -> (logits, cache)``: ``batch`` carries
  ``"tokens"`` (B, S), optionally ``"length"`` (B,) valid prefix lengths
  of right-padded prompts, and the stub encoder input of its family:
  ``"frames"`` (B, S, d_model) for audio, ``"image_embeds"``
  (B, n_image_tokens, d_model) for vlm;
* ``decode(params, cache, token, pos) -> (logits, cache)``: one token per
  slot against a paged cache (pools for every paged leaf and a ``"bt"``
  block table), updated in place;
* ``cache_shapes(batch, max_len, enc_len=None)``: name -> (shape, dtype)
  of every cache leaf in its contiguous layout, as ``repro``'s
  ``cache_shapes`` gives them. The serving engine finds each leaf's batch
  and sequence axes from it and pages the leaves that have a sequence axis.

The dense, audio and vlm families are ported; the others raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import decode_body
from repro_torch.kernels.flash_attention import flash_body
from repro_torch.models import transformer as T

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    cache_shapes: Callable[..., Dict[str, Tuple[Tuple[int, ...],
                                                torch.dtype]]]


def _cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                  enc_len: Optional[int] = None):
    dtype = T.DTYPES[cfg.dtype]
    kv = (cfg.n_kv_heads, cfg.head_dim)
    if cfg.family == "dense":
        sh = (cfg.n_layers, batch, max_len) + kv
        return {"k": (sh, dtype), "v": (sh, dtype)}
    if cfg.family == "audio":
        sh = (cfg.n_layers, batch, max_len) + kv
        xsh = (cfg.n_layers, batch, enc_len or max_len) + kv
        return {"k": (sh, dtype), "v": (sh, dtype), "xk": (xsh, dtype),
                "xv": (xsh, dtype), "enc_len": ((batch,), torch.int32)}
    n_cross, per = T._vlm_groups(cfg)
    sh = (n_cross, per, batch, max_len) + kv
    xsh = (n_cross, batch, cfg.n_image_tokens) + kv
    return {"k": (sh, dtype), "v": (sh, dtype), "xk": (xsh, dtype),
            "xv": (xsh, dtype)}


_FAMILIES = {
    # family -> (init, prefill(cfg, params, batch), decode)
    "dense": (T.init_dense,
              lambda cfg, p, b: T.prefill_dense(cfg, p, b["tokens"],
                                                length=b.get("length")),
              T.decode_dense),
    "audio": (T.init_audio,
              lambda cfg, p, b: T.prefill_audio(cfg, p, b["tokens"],
                                                b["frames"],
                                                length=b.get("length")),
              T.decode_audio),
    "vlm": (T.init_vlm,
            lambda cfg, p, b: T.prefill_vlm(cfg, p, b["tokens"],
                                            b["image_embeds"],
                                            length=b.get("length")),
            T.decode_vlm),
}


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (default CUDA; raises without it)."""
    if cfg.attention_impl == "cuda":
        # no quiet fall back to the plain path: a geometry that no kernel
        # body takes (phi3-mini's head_dim 96) is refused here
        dtype = T.DTYPES[cfg.dtype]
        try:
            flash_body(dtype, cfg.head_dim)
            decode_body(dtype, cfg.q_per_kv, cfg.head_dim)
        except ValueError as e:
            raise ValueError(
                f"config {cfg.name!r}: no CUDA attention body takes "
                f"head_dim {cfg.head_dim} with G={cfg.q_per_kv} in "
                f"{cfg.dtype} ({e})") from e
    dev = resolve_device(device)
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(_FAMILIES)})")
    if dev.type == "cpu" and (cfg.attention_impl == "cuda"
                              or cfg.quantize == "int8_cuda"):
        raise ValueError(f"config {cfg.name!r} asks for the CUDA kernels "
                         "but the device is the CPU")

    init_fn, prefill_fn, decode_fn = _FAMILIES[cfg.family]

    def init(seed: int = 0):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_fn(cfg, gen, dev)

    return Model(
        cfg=cfg,
        device=dev,
        init=init,
        prefill=lambda p, b: prefill_fn(cfg, p, b),
        decode=lambda p, c, t, pos: decode_fn(cfg, p, c, t, pos),
        cache_shapes=lambda batch, max_len, enc_len=None: _cache_shapes(
            cfg, batch, max_len, enc_len),
    )
