"""Model interface over the ported families (``repro.models.model``).

``build_model(cfg, device)`` returns a ``Model`` with

* ``init(seed) -> params``: seeded random weights on the model's device;
* ``forward(params, batch) -> logits``: the full-sequence causal forward
  of training, (B, S, V) f32; ``batch`` carries ``"tokens"`` and the
  family's encoder input (below). With ``cfg.remat`` each block is
  recomputed in backward;
* ``loss(params, batch) -> scalar``: the mean token cross-entropy of
  ``forward`` against ``batch["targets"]``;
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
  and sequence axes from it and pages the leaves that have a sequence axis;
* ``empty_state(batch, max_len, enc_len=None)``: the cache of a sequence
  that has seen no tokens, the slot reset of chunked prefill, in-segment
  admission and recovery: zeros for every family but ssm, whose xLSTM
  stabilizers start at -1e30 and sLSTM normalizer at 1e-6
  (``xlstm.xlstm_empty_state``); the hybrid family's SSM and conv states
  start at 0;
* ``decode_window(params, cache, tokens (B, S), pos (B,))``: the
  teacher-forced S-token window of the speculative verifier, set for the
  dense family only (its KV write and attend have an exact batched form);
  the other families verify one token at a time through ``decode``.

Every family of ``repro`` is ported: dense, moe, hybrid, ssm, audio and
vlm (an unknown family fails in ``ArchConfig``).

With ``parallel`` (a ``distributed.parallel.ParallelConfig``) the model runs
on its mesh: the caller places params, batches and caches as DTensors
(``distributed.sharding.shard_tree`` by ``param_specs``, ``batch_specs``
and ``cache_specs``, a contiguous cache), and every entry point runs with
the activation-sharding context set and inside ``implicit_replication()``,
so the plain tensors made inside it (rope's angles, masks, ``arange``s)
count as replicated. The moe family takes the expert-parallel lowering
(``moe.moe_ffn_ep``) on the mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.parallel import (activation_sharding_from,
                                              get_activation_sharding,
                                              using_activation_sharding)
from repro_torch.kernels.decode_attention import decode_body
from repro_torch.kernels.flash_attention import flash_body
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable[..., Any]
    forward: Callable[..., torch.Tensor]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    cache_shapes: Callable[..., Dict[str, Tuple[Tuple[int, ...],
                                                torch.dtype]]]
    empty_state: Optional[Callable[..., Dict[str, torch.Tensor]]] = None
    decode_window: Optional[Callable[..., Any]] = None
    parallel: Optional[Any] = None

    def loss(self, params, batch: Batch) -> torch.Tensor:
        with self.mesh_context():
            return L.cross_entropy(self.forward(params, batch),
                                   batch["targets"])

    def mesh_context(self):
        """The context every entry point runs in: on a mesh, the activation
        sharding and ``implicit_replication()``; else nothing. A backward
        through the model on a mesh runs in it too (``loss_and_grads``)."""
        return _mesh_context(self.parallel)


@contextlib.contextmanager
def _mesh_context(parallel):
    """Enter the mesh context once: ``implicit_replication()`` does not
    nest (its exit turns it off), so a nested entry point (``loss`` around
    ``forward``) leaves it to the outer one."""
    if parallel is None or get_activation_sharding() is not None:
        yield
        return
    with using_activation_sharding(activation_sharding_from(parallel)), \
            implicit_replication():
        yield


def _cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                  enc_len: Optional[int] = None):
    dtype = T.DTYPES[cfg.dtype]
    kv = (cfg.n_kv_heads, cfg.head_dim)
    if cfg.family in ("dense", "moe"):
        sh = (cfg.n_layers, batch, max_len) + kv
        return {"k": (sh, dtype), "v": (sh, dtype)}
    if cfg.family == "hybrid":
        return SSM.zamba_cache_shapes(cfg, batch, max_len)
    if cfg.family == "ssm":
        return X.xlstm_cache_shapes(cfg, batch, max_len)
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
    # family -> (init, forward(cfg, params, batch[, parallel]),
    #            prefill(cfg, params, batch[, parallel]), decode); the moe
    #            family's entry points take the ParallelConfig last
    "dense": (T.init_dense,
              lambda cfg, p, b: T.forward_dense(cfg, p, b["tokens"]),
              lambda cfg, p, b: T.prefill_dense(cfg, p, b["tokens"],
                                                length=b.get("length")),
              T.decode_dense),
    "moe": (MOE.init_moe,
            lambda cfg, p, b, par=None: MOE.forward_moe(cfg, p, b["tokens"],
                                                        par),
            lambda cfg, p, b, par=None: MOE.prefill_moe(
                cfg, p, b["tokens"], par, length=b.get("length")),
            MOE.decode_moe),
    "hybrid": (SSM.init_zamba,
               lambda cfg, p, b: SSM.forward_zamba(cfg, p, b["tokens"]),
               lambda cfg, p, b: SSM.prefill_zamba(cfg, p, b["tokens"],
                                                   length=b.get("length")),
               SSM.decode_zamba),
    "ssm": (X.init_xlstm,
            lambda cfg, p, b: X.forward_xlstm(cfg, p, b["tokens"]),
            lambda cfg, p, b: X.prefill_xlstm(cfg, p, b["tokens"],
                                              length=b.get("length")),
            X.decode_xlstm),
    "audio": (T.init_audio,
              lambda cfg, p, b: T.forward_audio(cfg, p, b["tokens"],
                                                b["frames"]),
              lambda cfg, p, b: T.prefill_audio(cfg, p, b["tokens"],
                                                b["frames"],
                                                length=b.get("length")),
              T.decode_audio),
    "vlm": (T.init_vlm,
            lambda cfg, p, b: T.forward_vlm(cfg, p, b["tokens"],
                                            b["image_embeds"]),
            lambda cfg, p, b: T.prefill_vlm(cfg, p, b["tokens"],
                                            b["image_embeds"],
                                            length=b.get("length")),
            T.decode_vlm),
}


def build_model(cfg: ArchConfig, device="cuda", parallel=None) -> Model:
    """The model of ``cfg`` on ``device`` (default CUDA; raises without it);
    on ``parallel``'s mesh when given (the module docstring). A mesh takes
    the plain impls only: the kernel wrappers launch on raw pointers of
    whole tensors, and ``repro`` lowers sharded code with its plain impl,
    so ``attention_impl="cuda"`` and ``quantize="int8_cuda"`` are refused
    by name."""
    if parallel is not None and (cfg.attention_impl == "cuda"
                                 or cfg.quantize == "int8_cuda"):
        raise ValueError(
            f"config {cfg.name!r}: a mesh takes the plain impls; "
            f"attention_impl={cfg.attention_impl!r} and quantize="
            f"{cfg.quantize!r} ask for a kernel, whose wrapper launches on "
            "a whole tensor (use attention_impl='torch_chunked')")
    if cfg.attention_impl == "cuda" and cfg.family != "ssm":
        # no quiet fall back to the plain path: a geometry that no kernel
        # body takes (head_dim 80, G = 32, bf16 at head_dim 16/32, f32 at
        # G > 8 with head_dim 128) is refused here; every config of the
        # registry has its bodies. The ssm family (xLSTM) has no attention
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
    if dev.type == "cpu" and (cfg.attention_impl == "cuda"
                              or cfg.quantize == "int8_cuda"):
        raise ValueError(f"config {cfg.name!r} asks for the CUDA kernels "
                         "but the device is the CPU")

    init_fn, forward_fn, prefill_fn, decode_fn = _FAMILIES[cfg.family]

    def init(seed: int = 0):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_fn(cfg, gen, dev)

    def cache_shapes(batch, max_len, enc_len=None):
        return _cache_shapes(cfg, batch, max_len, enc_len)

    def empty_state(batch, max_len, enc_len=None):
        if cfg.family == "ssm":
            return X.xlstm_empty_state(cfg, batch, dev)
        return {n: torch.zeros(sh, dtype=dt, device=dev)
                for n, (sh, dt) in cache_shapes(batch, max_len,
                                                enc_len).items()}

    window = None
    if cfg.family == "dense":
        def window(p, c, t, pos):
            return T.decode_window_dense(cfg, p, c, t, pos)

    par = () if parallel is None or cfg.family != "moe" else (parallel,)

    def on_mesh(fn):
        """``fn`` with the mesh context around it (``parallel`` only)."""
        if parallel is None:
            return fn

        def run(*args):
            with _mesh_context(parallel):
                return fn(*args)
        return run

    return Model(
        cfg=cfg,
        device=dev,
        init=init,
        forward=on_mesh(lambda p, b: forward_fn(cfg, p, b, *par)),
        prefill=on_mesh(lambda p, b: prefill_fn(cfg, p, b, *par)),
        decode=on_mesh(lambda p, c, t, pos: decode_fn(cfg, p, c, t, pos,
                                                      *par)),
        cache_shapes=cache_shapes,
        empty_state=empty_state,
        decode_window=window and on_mesh(window),
        parallel=parallel,
    )


def make_batch(cfg: ArchConfig, gen: torch.Generator, batch: int, seq: int,
               with_targets: bool = True) -> Batch:
    """A random batch for smoke tests and examples, drawn from ``gen`` on
    its device: int32 ``"tokens"`` (and ``"targets"``) and the family's
    encoder input in ``cfg.dtype``. ``repro``'s ``make_batch`` draws from
    ``jax.random``, whose bits no torch generator gives, so tests that
    compare the two packages feed both the same numpy batch."""
    dev = gen.device
    b: Batch = {"tokens": torch.randint(0, cfg.vocab, (batch, seq),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)}
    if with_targets:
        b["targets"] = torch.randint(0, cfg.vocab, (batch, seq),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)
    dtype = T.DTYPES[cfg.dtype]
    if cfg.family == "audio":
        b["frames"] = torch.randn((batch, seq, cfg.d_model), generator=gen,
                                  device=dev).to(dtype)
    if cfg.family == "vlm":
        b["image_embeds"] = torch.randn(
            (batch, cfg.n_image_tokens, cfg.d_model), generator=gen,
            device=dev).to(dtype)
    return b
