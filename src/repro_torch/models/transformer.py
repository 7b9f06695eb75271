"""Dense decoder-only transformer, plus the VLM (cross-attention image
layers) and audio (enc-dec) backbones that reuse its blocks
(``repro.models.transformer``).

Parameters are stacked on a leading layer axis, as in the JAX package, and
the layer loop is a Python loop over per-layer views. The full-sequence
forwards of training (``forward_dense``, ``forward_vlm``,
``forward_audio``) unbind each stack once (``unstack``) and, with
``cfg.remat``, recompute each block in backward (``remat``) at the
granularity of ``repro``'s ``_maybe_remat``. Prefill returns the
per-layer k/v of the prompt (and the cross-attention k/v of the context);
decode runs one token per slot against the cache, which it updates in
place: paged KV pools read and written through a ``"bt"`` block table, or,
for a cache without one, the contiguous layout's per-slot rows.

The encoder inputs are stubs, as in ``repro``: audio takes precomputed
frame embeddings (B, S, d_model), vlm precomputed patch embeddings
(B, n_image_tokens, d_model).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models.quantize import QuantizedWeight, qimpl_for

Params = Dict[str, Any]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _attn_stack_init(cfg: ArchConfig, gen: torch.Generator, n: int,
                     dtype, device) -> Params:
    """``n`` stacked attention projections, grouped (K, G) head layout."""
    d, hd, nk = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    g = cfg.n_heads // nk
    kw = dict(device=device)
    return {
        "wq": L.dense_init(gen, (n, d, nk, g, hd), dtype, 1, **kw),
        "wk": L.dense_init(gen, (n, d, nk, hd), dtype, 1, **kw),
        "wv": L.dense_init(gen, (n, d, nk, hd), dtype, 1, **kw),
        "wo": L.dense_init(gen, (n, nk, g, hd, d), dtype, -1, **kw),
    }


def _block_stack_init(cfg: ArchConfig, gen: torch.Generator, n: int,
                      dtype, device) -> Params:
    """``n`` stacked self-attention + SwiGLU blocks."""
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(device=device)
    return {
        "attn": _attn_stack_init(cfg, gen, n, dtype, device),
        "mlp": {
            "w_gate": L.dense_init(gen, (n, d, f), dtype, 1, **kw),
            "w_up": L.dense_init(gen, (n, d, f), dtype, 1, **kw),
            "w_down": L.dense_init(gen, (n, f, d), dtype, 1, **kw),
        },
        "ln1": torch.zeros((n, d), dtype=dtype, device=device),
        "ln2": torch.zeros((n, d), dtype=dtype, device=device),
    }


def _init(cfg: ArchConfig, gen: torch.Generator, device,
          stacks: Dict[str, int]) -> Params:
    """Embedding, the named block stacks (name -> depth), final norm, head."""
    dtype = DTYPES[cfg.param_dtype]
    d = cfg.d_model
    p: Params = {"embed": L.embed_init(gen, (cfg.vocab, d), dtype,
                                       device=device)}
    for name, n in stacks.items():
        p[name] = _block_stack_init(cfg, gen, n, dtype, device)
    p["ln_f"] = torch.zeros((d,), dtype=dtype, device=device)
    p["head"] = L.embed_init(gen, (cfg.vocab, d), dtype, device=device)
    return p


def init_dense(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    """Seeded random init on ``device`` (the generator must live there)."""
    return _init(cfg, gen, device, {"layers": cfg.n_layers})


def init_vlm(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    """Self layers and one cross layer per ``cross_attn_every`` layers."""
    n_cross = cfg.n_layers // cfg.cross_attn_every
    return _init(cfg, gen, device, {"layers": cfg.n_layers - n_cross,
                                    "cross_layers": n_cross})


def init_audio(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    """Encoder blocks, decoder self blocks and decoder cross blocks."""
    return _init(cfg, gen, device, {"encoder": cfg.n_encoder_layers,
                                    "decoder": cfg.n_layers,
                                    "cross": cfg.n_layers})


def unstack(stack: Params, n: int) -> List[Params]:
    """The ``n`` layers of a stacked tree (nested dicts; int8 weights
    sliced per layer), as views, each leaf unbound once.

    Under autograd, ``unbind``'s backward stacks the layer grads in one
    pass, where indexing each layer would write a zero tensor the size of
    the whole stack per layer."""
    def split(w):
        if isinstance(w, QuantizedWeight):
            return [w.layer(i) for i in range(n)]
        if isinstance(w, dict):
            return unstack(w, n)
        return torch.unbind(w, 0)

    leaves = {k: split(w) for k, w in stack.items()}
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]


def remat(cfg: ArchConfig, fn: Callable, *args):
    """``fn(*args)``, recomputed in backward when ``cfg.remat`` and grad
    mode are on (``repro``'s ``jax.checkpoint`` of a scan body). Nothing in
    a remat body writes into a tensor that autograd saved."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _ffn_residual(x, out_attn, blk, qi):
    x = x + L.attn_out(out_attn, blk["attn"], qimpl=qi)
    return x + L.swiglu(L.rmsnorm(x, blk["ln2"]), blk["mlp"], qimpl=qi)


def _constrained(x, out_attn, blk, qi):
    """``_ffn_residual``, its output pinned by ``L.constrain_residual``
    (a no-op off a mesh): the end of a full-sequence self or cross block,
    where ``repro`` constrains the residual stream."""
    return L.constrain_residual(_ffn_residual(x, out_attn, blk, qi))


def _self_attn(cfg: ArchConfig, x, blk, positions, *, causal=True,
               kv_valid_len=None, impl: Optional[str] = None):
    """The attention half of a self block over the whole sequence: norm,
    projections, RoPE and attention under the config's impl. Returns (o
    (B, S, K, G, D), k, v) with the block's roped k/v (B, S, K, D)."""
    h = L.rmsnorm(x, blk["ln1"])
    q, k, v = L.attn_qkv(h, blk["attn"], qimpl=qimpl_for(cfg.quantize))
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.attention_core(q, k, v, causal=causal, kv_valid_len=kv_valid_len,
                         impl=impl or cfg.attention_impl)
    return o, k, v


def _self_block(cfg: ArchConfig, x, blk, positions, *, causal=True,
                kv_valid_len=None, impl: Optional[str] = None):
    """One self-attention block over the whole sequence; returns (x, k, v)
    with the block's roped k/v (B, S, K, D)."""
    o, k, v = _self_attn(cfg, x, blk, positions, causal=causal,
                         kv_valid_len=kv_valid_len, impl=impl)
    return _constrained(x, o, blk, qimpl_for(cfg.quantize)), k, v


def _cross_kv(ctx, blk):
    """Cross-attention k/v (B, T, K, D) of a context (no RoPE)."""
    ctx = L.gather_seq(ctx)
    k = L.project("btd,dkh->btkh", ctx, blk["attn"]["wk"])
    v = L.project("btd,dkh->btkh", ctx, blk["attn"]["wv"])
    return k, v


def _cross_block(x, blk, attend):
    """Cross-attention block: queries from x, ``attend(q)`` against the
    context's k/v (no RoPE, no causality), then the SwiGLU MLP."""
    h = L.rmsnorm(x, blk["ln1"])
    q = L.project("bsd,dkgh->bskgh", h, blk["attn"]["wq"])
    return _constrained(x, attend(q), blk, "torch")


def decode_positions(pos, batch: int, device) -> torch.Tensor:
    """(B, 1) RoPE positions of a decode step from per-slot positions (B,)
    or from one int shared by every slot (``repro``'s ``decode_positions``);
    the int becomes a device fill, with no copy from the host."""
    if isinstance(pos, int):
        return torch.full((batch, 1), pos, dtype=torch.int32, device=device)
    return pos.reshape(-1, 1)


def _decode_attn(cfg: ArchConfig, x, blk, kc, vc, bt, pos):
    """The attention half of one decode step through a self block, writing
    its k/v into the cache in place; returns o (B, 1, K, G, D). x: (B, 1,
    d). With a (B, P) block table ``bt``, kc/vc are the shared (n_phys,
    ps, K, D) pools (the fused paged kernel under ``impl="cuda"``); with
    ``bt`` None they are the contiguous (B, S_max, K, D) slot rows, written
    at ``pos`` and attended up to ``pos + 1``: per slot for a (B,) ``pos``
    (the contiguous kernel's per-slot form), or, for one int shared by
    every slot (the run-to-completion ``WaveEngine``'s), at one length (its
    scalar form, which takes the length as a launch argument)."""
    positions = decode_positions(pos, x.shape[0], x.device)
    h = L.rmsnorm(x, blk["ln1"])
    q, k, v = L.attn_qkv(h, blk["attn"], qimpl=qimpl_for(cfg.quantize))
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if bt is None:
        KV.update_layer_cache(kc, vc, k, v, pos)
        return L.attention_core(q, kc, vc, causal=False,
                                kv_valid_len=pos + 1,
                                impl=cfg.attention_impl)
    o, _, _ = L.paged_update_attend(q, k, v, kc, vc, bt, pos,
                                    impl=cfg.attention_impl)
    return o


def _decode_block(cfg: ArchConfig, x, blk, kc, vc, bt, pos):
    """One decode step through one self block (``_decode_attn``, then the
    MLP), updating its cache in place."""
    o = _decode_attn(cfg, x, blk, kc, vc, bt, pos)
    return _ffn_residual(x, o, blk, qimpl_for(cfg.quantize))


def _head(cfg: ArchConfig, params: Params, x, length=None):
    x = L.rmsnorm(x, params["ln_f"])
    return L.lm_logits(L.select_last(x, length), params["head"])


def _positions(x: torch.Tensor) -> torch.Tensor:
    """(1, S) positions of the sequence axis of x (B, S, ...)."""
    return torch.arange(x.shape[1], device=x.device)[None, :]


def _scan_blocks(cfg: ArchConfig, x, stack: Params, n: int, positions, *,
                 causal=True, kv_valid_len=None):
    """``n`` self blocks over the whole sequence, each a remat body."""
    def body(x, blk):
        return _self_block(cfg, x, blk, positions, causal=causal,
                           kv_valid_len=kv_valid_len)[0]
    for blk in unstack(stack, n):
        x = remat(cfg, body, x, blk)
    return x


def _logits(params: Params, x):
    return L.lm_logits(L.rmsnorm(x, params["ln_f"]), params["head"])


def forward_dense(cfg: ArchConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The causal forward of training: tokens (B, S) -> logits (B, S, V)
    f32."""
    x = L.embed_tokens(tokens, params["embed"], DTYPES[cfg.dtype])
    x = _scan_blocks(cfg, x, params["layers"], cfg.n_layers,
                     _positions(tokens))
    return _logits(params, x)


def prefill_dense(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  length: Optional[torch.Tensor] = None):
    """tokens (B, S), right-padded; ``length`` (B,) valid prefix lengths.

    Returns next-token logits (B, 1, V) in f32, read at position
    ``length - 1``, and the prompt cache ``{"k", "v"}`` (L, B, S, K, D).
    """
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = L.embed_tokens(tokens, params["embed"], DTYPES[cfg.dtype])
    ks, vs = [], []
    for blk in unstack(params["layers"], cfg.n_layers):
        x, k, v = _self_block(cfg, x, blk, positions)
        ks.append(k)
        vs.append(v)
    return _head(cfg, params, x, length), {"k": torch.stack(ks),
                                           "v": torch.stack(vs)}


def decode_dense(cfg: ArchConfig, params: Params, cache, token: torch.Tensor,
                 pos: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """One new token per slot: token (B, 1), pos (B,) int32.

    ``cache`` holds the shared page pools ``"k"``/``"v"`` (L, n_phys, ps, K,
    D) and the block table ``"bt"`` (B, P) int32, or, without ``"bt"``, the
    contiguous ``"k"``/``"v"`` (L, B, S_max, K, D); either is updated in
    place. Returns (logits (B, 1, V) f32, cache).
    """
    bt = cache.get("bt")
    x = L.embed_tokens(token, params["embed"], DTYPES[cfg.dtype])
    for i, blk in enumerate(unstack(params["layers"], cfg.n_layers)):
        x = _decode_block(cfg, x, blk, cache["k"][i], cache["v"][i], bt, pos)
    return _head(cfg, params, x), cache


def decode_window_dense(cfg: ArchConfig, params: Params, cache,
                        tokens: torch.Tensor,
                        pos: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """Teacher-forced decode window, the speculative verifier: S tokens a
    slot in one forward. tokens (B, S), pos (B,) int32; window token ``s``
    of slot ``b`` sits at ``pos[b] + s``.

    Each layer writes the whole window's k/v first (the paged window write
    through ``"bt"``, or the contiguous per-slot rows), then attends each
    window token to positions ``<= pos[b] + s`` (``window_attention_core``,
    plain PyTorch). Row ``s`` of the logits is what ``decode_dense`` gives
    after feeding tokens ``0..s`` one at a time, up to the rounding of
    other GEMM shapes; at S == 1 it is the same bits. The caller keeps
    ``pos[b] + S <= S_max`` for live slots (the contiguous write clamps)
    and attaches the window's pages first. Returns (logits (B, S, V) f32,
    cache), the cache updated in place.
    """
    bt = cache.get("bt")
    B, S = tokens.shape
    qi = qimpl_for(cfg.quantize)
    positions = pos.reshape(B, 1) + torch.arange(S, device=tokens.device)
    x = L.embed_tokens(tokens, params["embed"], DTYPES[cfg.dtype])
    for i, blk in enumerate(unstack(params["layers"], cfg.n_layers)):
        kc, vc = cache["k"][i], cache["v"][i]
        h = L.rmsnorm(x, blk["ln1"])
        q, k, v = L.attn_qkv(h, blk["attn"], qimpl=qi)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        if bt is None:
            KV.update_layer_cache(kc, vc, k, v, pos)
            o = L.window_attention_core(q, kc, vc, pos)
        else:
            KV.paged_update_window(kc, vc, k, v, bt, pos)
            o = L.window_attention_core(q, KV.gather_block_kv(kc, bt),
                                        KV.gather_block_kv(vc, bt), pos)
        x = _ffn_residual(x, o, blk, qi)
    x = L.rmsnorm(x, params["ln_f"])
    return L.lm_logits(x, params["head"]), cache


# ---------------------------------------------------------------------------
# VLM: groups of (cross_attn_every - 1) self layers, then one cross layer


def _vlm_groups(cfg: ArchConfig):
    n_cross = cfg.n_layers // cfg.cross_attn_every
    return n_cross, cfg.cross_attn_every - 1


def _cross_full(cfg: ArchConfig, x, blk, ctx):
    """A cross block over a whole context: its k/v from ``ctx``, then
    ``_cross_block``."""
    xk, xv = _cross_kv(ctx, blk)
    return _cross_block(x, blk, lambda q: L.attention_core(
        q, xk, xv, causal=False, impl=cfg.attention_impl))


def forward_vlm(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                image_embeds: torch.Tensor) -> torch.Tensor:
    """tokens (B, S), image_embeds (B, n_image_tokens, d) -> logits (B, S,
    V) f32. Each self layer is a remat body, and so is each cross block on
    its own: a group-level remat would recompute the group's self layers
    a second time (``repro/models/transformer.py:337-341``)."""
    dtype = DTYPES[cfg.dtype]
    n_cross, per = _vlm_groups(cfg)
    positions = _positions(tokens)
    img = image_embeds.to(dtype)
    selfs = unstack(params["layers"], n_cross * per)
    crosses = unstack(params["cross_layers"], n_cross)
    x = L.embed_tokens(tokens, params["embed"], dtype)

    def self_body(x, blk):
        return _self_block(cfg, x, blk, positions)[0]

    def cross_body(x, blk):
        return _cross_full(cfg, x, blk, img)

    for c in range(n_cross):
        for blk in selfs[c * per:(c + 1) * per]:
            x = remat(cfg, self_body, x, blk)
        x = remat(cfg, cross_body, x, crosses[c])
    return _logits(params, x)


def prefill_vlm(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                image_embeds: torch.Tensor,
                length: Optional[torch.Tensor] = None):
    """tokens (B, S) right-padded; image_embeds (B, n_image_tokens, d).

    Returns next-token logits (B, 1, V) f32 and the cache: self k/v
    ``(n_cross, n_self_per, B, S, K, D)`` and cross k/v ``xk``/``xv``
    ``(n_cross, B, n_image_tokens, K, D)``.
    """
    dtype = DTYPES[cfg.dtype]
    n_cross, per = _vlm_groups(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    img = image_embeds.to(dtype)
    x = L.embed_tokens(tokens, params["embed"], dtype)
    selfs = unstack(params["layers"], n_cross * per)
    crosses = unstack(params["cross_layers"], n_cross)
    ks, vs, xks, xvs = [], [], [], []
    for c, blk in enumerate(crosses):
        for self_blk in selfs[c * per:(c + 1) * per]:
            x, k, v = _self_block(cfg, x, self_blk, positions)
            ks.append(k)
            vs.append(v)
        xk, xv = _cross_kv(img, blk)
        x = _cross_block(x, blk, lambda q: L.attention_core(
            q, xk, xv, causal=False, impl=cfg.attention_impl))
        xks.append(xk)
        xvs.append(xv)

    def grouped(a):
        return torch.stack(a).reshape((n_cross, per) + a[0].shape)

    cache = {"k": grouped(ks), "v": grouped(vs), "xk": torch.stack(xks),
             "xv": torch.stack(xvs)}
    return _head(cfg, params, x, length), cache


def decode_vlm(cfg: ArchConfig, params: Params, cache, token: torch.Tensor,
               pos: torch.Tensor):
    """One token per slot. ``cache``: self pools ``"k"``/``"v"`` (n_cross,
    n_self_per, n_phys, ps, K, D) and the block table ``"bt"``, or, without
    ``"bt"``, contiguous self k/v (n_cross, n_self_per, B, S_max, K, D),
    updated in place; and per-slot cross k/v ``"xk"``/``"xv"`` (n_cross,
    B, T, K, D). The cross-attention decode is the contiguous decode kernel
    with valid length T (``impl="cuda"``)."""
    bt = cache.get("bt")
    n_cross, per = _vlm_groups(cfg)
    x = L.embed_tokens(token, params["embed"], DTYPES[cfg.dtype])
    selfs = unstack(params["layers"], n_cross * per)
    crosses = unstack(params["cross_layers"], n_cross)
    for c, blk in enumerate(crosses):
        for j in range(per):
            x = _decode_block(cfg, x, selfs[c * per + j], cache["k"][c, j],
                              cache["v"][c, j], bt, pos)
        xk, xv = cache["xk"][c], cache["xv"][c]
        x = _cross_block(x, blk,
                         lambda q: L.attention_core(
                             q, xk, xv, causal=False,
                             impl=cfg.attention_impl))
    return _head(cfg, params, x), cache


# ---------------------------------------------------------------------------
# audio (enc-dec): stub frame embeddings in, decoder tokens out


def forward_audio(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  frames: torch.Tensor) -> torch.Tensor:
    """tokens (B, S), frames (B, T, d) stub frame embeddings -> logits (B,
    S, V) f32. Each encoder block is a remat body, and so is each decoder
    layer (its self block and its cross block together)."""
    dtype = DTYPES[cfg.dtype]
    enc = frames.to(dtype)
    enc = _scan_blocks(cfg, enc, params["encoder"], cfg.n_encoder_layers,
                       _positions(enc), causal=False)
    positions = _positions(tokens)
    x = L.embed_tokens(tokens, params["embed"], dtype)

    def body(x, dec, cross):
        x = _self_block(cfg, x, dec, positions)[0]
        return _cross_full(cfg, x, cross, enc)

    for dec, cross in zip(unstack(params["decoder"], cfg.n_layers),
                          unstack(params["cross"], cfg.n_layers)):
        x = remat(cfg, body, x, dec, cross)
    return _logits(params, x)


def prefill_audio(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  frames: torch.Tensor, length: Optional[torch.Tensor] = None):
    """tokens (B, S) right-padded; frames (B, S, d) stub frame embeddings.

    ``length`` (B,) is shared by the prompt and the frame stream. Encoder
    self-attention and decoder cross-attention mask by it, so padded
    encoder rows contribute exact zeros; it rides in the cache as
    ``enc_len`` for decode. Returns next-token logits (B, 1, V) f32 and the
    cache ``{"k", "v", "xk", "xv"}`` (L, B, S, K, D) plus ``"enc_len"``.
    """
    dtype = DTYPES[cfg.dtype]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :]
    # Per-slot lengths have no kernel: repro sends attention with a (B,)
    # kv_valid_len to XLA (repro/models/layers.py:295-300), so the encoder
    # and the prefill cross-attention take the plain path here, by name.
    ctx_impl = cfg.attention_impl if length is None else "torch"
    enc = frames.to(dtype)
    enc_positions = torch.arange(enc.shape[1], device=enc.device)[None, :]
    for blk in unstack(params["encoder"], cfg.n_encoder_layers):
        enc, _, _ = _self_block(cfg, enc, blk, enc_positions, causal=False,
                                kv_valid_len=length, impl=ctx_impl)
    enc_len = (length if length is not None
               else torch.full((B,), frames.shape[1], device=tokens.device))
    x = L.embed_tokens(tokens, params["embed"], dtype)
    ks, vs, xks, xvs = [], [], [], []
    for dec, blk in zip(unstack(params["decoder"], cfg.n_layers),
                        unstack(params["cross"], cfg.n_layers)):
        x, k, v = _self_block(cfg, x, dec, positions)
        xk, xv = _cross_kv(enc, blk)
        x = _cross_block(x, blk, lambda q: L.attention_core(
            q, xk, xv, causal=False, kv_valid_len=length, impl=ctx_impl))
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "xk": torch.stack(xks), "xv": torch.stack(xvs),
             "enc_len": enc_len.to(torch.int32)}
    return _head(cfg, params, x, length), cache


def decode_audio(cfg: ArchConfig, params: Params, cache, token: torch.Tensor,
                 pos: torch.Tensor):
    """One token per slot. ``cache``: decoder self pools ``"k"``/``"v"``
    and encoder pools ``"xk"``/``"xv"`` (L, n_phys, ps, K, D) sharing the
    block table ``"bt"``, or, without ``"bt"``, the contiguous (L, B, S, K,
    D) leaves; and per-slot ``"enc_len"`` (B,) int32. The cross-attention
    decode is masked by ``enc_len``: the paged decode kernel over the
    encoder pools, or the contiguous decode kernel's per-slot form over
    the contiguous ``xk``/``xv`` (``impl="cuda"``)."""
    bt = cache.get("bt")
    enc_len = cache["enc_len"]
    x = L.embed_tokens(token, params["embed"], DTYPES[cfg.dtype])
    for i, (dec, cross) in enumerate(zip(
            unstack(params["decoder"], cfg.n_layers),
            unstack(params["cross"], cfg.n_layers))):
        x = _decode_block(cfg, x, dec, cache["k"][i], cache["v"][i], bt, pos)
        xk, xv = cache["xk"][i], cache["xv"][i]
        if bt is None:
            def attend(q, xk=xk, xv=xv):
                return L.attention_core(q, xk, xv, causal=False,
                                        kv_valid_len=enc_len,
                                        impl=cfg.attention_impl)
        else:
            def attend(q, xk=xk, xv=xv):
                return L.paged_attention_core(q, xk, xv, bt,
                                              kv_valid_len=enc_len,
                                              impl=cfg.attention_impl)
        x = _cross_block(x, cross, attend)
    return _head(cfg, params, x), cache
