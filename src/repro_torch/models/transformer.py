"""Dense decoder-only transformer, plus the VLM (cross-attention image
layers) and audio (enc-dec) backbones that reuse its blocks (the serving
part of ``repro.models.transformer``).

Parameters are stacked on a leading layer axis, as in the JAX package, and
the layer loop is a Python loop over per-layer views. Prefill returns the
per-layer k/v of the prompt (and the cross-attention k/v of the context);
decode runs one token per slot against the cache, which it updates in
place: paged KV pools read and written through a ``"bt"`` block table, or,
for a cache without one, the contiguous layout's per-slot rows.

The encoder inputs are stubs, as in ``repro``: audio takes precomputed
frame embeddings (B, S, d_model), vlm precomputed patch embeddings
(B, n_image_tokens, d_model).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models.quantize import QuantizedWeight, qimpl_for

Params = Dict[str, Any]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _block_stack_init(cfg: ArchConfig, gen: torch.Generator, n: int,
                      dtype, device) -> Params:
    """``n`` stacked self-attention + SwiGLU blocks."""
    d, hd, nk, f = cfg.d_model, cfg.head_dim, cfg.n_kv_heads, cfg.d_ff
    g = cfg.n_heads // nk
    kw = dict(device=device)
    return {
        "attn": {
            "wq": L.dense_init(gen, (n, d, nk, g, hd), dtype, 1, **kw),
            "wk": L.dense_init(gen, (n, d, nk, hd), dtype, 1, **kw),
            "wv": L.dense_init(gen, (n, d, nk, hd), dtype, 1, **kw),
            "wo": L.dense_init(gen, (n, nk, g, hd, d), dtype, -1, **kw),
        },
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


def _slice(w, i: int):
    return w.layer(i) if isinstance(w, QuantizedWeight) else w[i]


def layer_params(stack: Params, i: int) -> Params:
    """Layer ``i``'s parameters as views into the stacked tree."""
    return {"attn": {k: _slice(w, i) for k, w in stack["attn"].items()},
            "mlp": {k: _slice(w, i) for k, w in stack["mlp"].items()},
            "ln1": stack["ln1"][i], "ln2": stack["ln2"][i]}


def _ffn_residual(x, out_attn, blk, qi):
    x = x + L.attn_out(out_attn, blk["attn"], qimpl=qi)
    return x + L.swiglu(L.rmsnorm(x, blk["ln2"]), blk["mlp"], qimpl=qi)


def _self_block(cfg: ArchConfig, x, blk, positions, *, causal=True,
                kv_valid_len=None, impl: Optional[str] = None):
    """One self-attention block over the whole sequence; returns (x, k, v)
    with the block's roped k/v (B, S, K, D)."""
    qi = qimpl_for(cfg.quantize)
    h = L.rmsnorm(x, blk["ln1"])
    q, k, v = L.attn_qkv(h, blk["attn"], qimpl=qi)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.attention_core(q, k, v, causal=causal, kv_valid_len=kv_valid_len,
                         impl=impl or cfg.attention_impl)
    return _ffn_residual(x, o, blk, qi), k, v


def _cross_kv(ctx, blk):
    """Cross-attention k/v (B, T, K, D) of a context (no RoPE)."""
    k = torch.einsum("btd,dkh->btkh", ctx, blk["attn"]["wk"])
    v = torch.einsum("btd,dkh->btkh", ctx, blk["attn"]["wv"])
    return k, v


def _cross_block(x, blk, attend):
    """Cross-attention block: queries from x, ``attend(q)`` against the
    context's k/v (no RoPE, no causality), then the SwiGLU MLP."""
    h = L.rmsnorm(x, blk["ln1"])
    q = torch.einsum("bsd,dkgh->bskgh", h, blk["attn"]["wq"])
    return _ffn_residual(x, attend(q), blk, "torch")


def _decode_block(cfg: ArchConfig, x, blk, kc, vc, bt, pos):
    """One decode step through one self block, updating its cache in
    place. x: (B, 1, d). With a (B, P) block table ``bt``, kc/vc are the
    shared (n_phys, ps, K, D) pools; with ``bt`` None they are the
    contiguous (B, S_max, K, D) slot rows, written at ``pos`` and attended
    up to ``pos + 1``, per slot."""
    qi = qimpl_for(cfg.quantize)
    positions = pos.reshape(-1, 1)
    h = L.rmsnorm(x, blk["ln1"])
    q, k, v = L.attn_qkv(h, blk["attn"], qimpl=qi)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if bt is None:
        KV.update_layer_cache(kc, vc, k, v, pos)
        o = L.attention_core(q, kc, vc, causal=False, kv_valid_len=pos + 1,
                             impl=cfg.attention_impl)
    else:
        o, _, _ = L.paged_update_attend(q, k, v, kc, vc, bt, pos,
                                        impl=cfg.attention_impl)
    return _ffn_residual(x, o, blk, qi)


def _head(cfg: ArchConfig, params: Params, x, length=None):
    x = L.rmsnorm(x, params["ln_f"])
    return L.lm_logits(L.select_last(x, length), params["head"])


def prefill_dense(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  length: Optional[torch.Tensor] = None):
    """tokens (B, S), right-padded; ``length`` (B,) valid prefix lengths.

    Returns next-token logits (B, 1, V) in f32, read at position
    ``length - 1``, and the prompt cache ``{"k", "v"}`` (L, B, S, K, D).
    """
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = L.embed_tokens(tokens, params["embed"], DTYPES[cfg.dtype])
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v = _self_block(cfg, x, layer_params(params["layers"], i),
                              positions)
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
    for i in range(cfg.n_layers):
        x = _decode_block(cfg, x, layer_params(params["layers"], i),
                          cache["k"][i], cache["v"][i], bt, pos)
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
    for i in range(cfg.n_layers):
        blk = layer_params(params["layers"], i)
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
    ks, vs, xks, xvs = [], [], [], []
    for c in range(n_cross):
        for j in range(per):
            x, k, v = _self_block(cfg, x, layer_params(params["layers"],
                                                       c * per + j),
                                  positions)
            ks.append(k)
            vs.append(v)
        blk = layer_params(params["cross_layers"], c)
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
    for c in range(n_cross):
        for j in range(per):
            x = _decode_block(cfg, x, layer_params(params["layers"],
                                                   c * per + j),
                              cache["k"][c, j], cache["v"][c, j], bt, pos)
        xk, xv = cache["xk"][c], cache["xv"][c]
        x = _cross_block(x, layer_params(params["cross_layers"], c),
                         lambda q: L.attention_core(
                             q, xk, xv, causal=False,
                             impl=cfg.attention_impl))
    return _head(cfg, params, x), cache


# ---------------------------------------------------------------------------
# audio (enc-dec): stub frame embeddings in, decoder tokens out


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
    for i in range(cfg.n_encoder_layers):
        enc, _, _ = _self_block(cfg, enc, layer_params(params["encoder"], i),
                                enc_positions, causal=False,
                                kv_valid_len=length, impl=ctx_impl)
    enc_len = (length if length is not None
               else torch.full((B,), frames.shape[1], device=tokens.device))
    x = L.embed_tokens(tokens, params["embed"], dtype)
    ks, vs, xks, xvs = [], [], [], []
    for i in range(cfg.n_layers):
        x, k, v = _self_block(cfg, x, layer_params(params["decoder"], i),
                              positions)
        blk = layer_params(params["cross"], i)
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
    for i in range(cfg.n_layers):
        x = _decode_block(cfg, x, layer_params(params["decoder"], i),
                          cache["k"][i], cache["v"][i], bt, pos)
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
        x = _cross_block(x, layer_params(params["cross"], i), attend)
    return _head(cfg, params, x), cache
