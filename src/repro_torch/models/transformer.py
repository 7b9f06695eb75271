"""Dense decoder-only transformer (the dense part of ``repro.models.transformer``).

Parameters are stacked on a leading layer axis, as in the JAX package, and
the layer loop is a Python loop over per-layer views. Prefill returns the
per-layer k/v of the prompt; decode runs one token per slot against the
paged KV pools, which it updates in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.quantize import QuantizedWeight, qimpl_for

Params = Dict[str, Any]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_dense(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    """Seeded random init on ``device`` (the generator must live there)."""
    dtype = DTYPES[cfg.param_dtype]
    d, hd, nk, f, n = (cfg.d_model, cfg.head_dim, cfg.n_kv_heads, cfg.d_ff,
                       cfg.n_layers)
    g = cfg.n_heads // nk
    kw = dict(device=device)
    return {
        "embed": L.embed_init(gen, (cfg.vocab, d), dtype, **kw),
        "layers": {
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
        },
        "ln_f": torch.zeros((d,), dtype=dtype, device=device),
        "head": L.embed_init(gen, (cfg.vocab, d), dtype, **kw),
    }


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


def prefill_dense(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  length: Optional[torch.Tensor] = None):
    """tokens (B, S), right-padded; ``length`` (B,) valid prefix lengths.

    Returns next-token logits (B, 1, V) in f32, read at position
    ``length - 1``, and the prompt cache ``{"k", "v"}`` (L, B, S, K, D).
    """
    dtype = DTYPES[cfg.dtype]
    qi = qimpl_for(cfg.quantize)
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]
    x = L.embed_tokens(tokens, params["embed"], dtype)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        blk = layer_params(params["layers"], i)
        h = L.rmsnorm(x, blk["ln1"])
        q, k, v = L.attn_qkv(h, blk["attn"], qimpl=qi)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        o = L.attention_core(q, k, v, causal=True, impl=cfg.attention_impl)
        x = _ffn_residual(x, o, blk, qi)
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(x, params["ln_f"])
    logits = L.lm_logits(L.select_last(x, length), params["head"])
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_dense(cfg: ArchConfig, params: Params, cache, token: torch.Tensor,
                 pos: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """One new token per slot: token (B, 1), pos (B,) int32.

    ``cache`` holds the shared page pools ``"k"``/``"v"`` (L, n_phys, ps, K,
    D) and the block table ``"bt"`` (B, P) int32; the pools are updated in
    place. Returns (logits (B, 1, V) f32, cache).
    """
    bt = cache.get("bt")
    if bt is None:
        raise NotImplementedError(
            "decode_dense: the contiguous KV layout is not ported; pass a "
            "paged cache with a 'bt' block table")
    dtype = DTYPES[cfg.dtype]
    qi = qimpl_for(cfg.quantize)
    positions = pos.reshape(-1, 1)
    x = L.embed_tokens(token, params["embed"], dtype)
    for i in range(cfg.n_layers):
        blk = layer_params(params["layers"], i)
        h = L.rmsnorm(x, blk["ln1"])
        q, k, v = L.attn_qkv(h, blk["attn"], qimpl=qi)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        o, _, _ = L.paged_update_attend(q, k, v, cache["k"][i], cache["v"][i],
                                        bt, pos, impl=cfg.attention_impl)
        x = _ffn_residual(x, o, blk, qi)
    x = L.rmsnorm(x, params["ln_f"])
    return L.lm_logits(x, params["head"]), cache
