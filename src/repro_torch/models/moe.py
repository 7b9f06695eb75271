"""Mixture-of-Experts decoder (moonshot 64 experts top-6, qwen3 128 top-8;
``repro.models.moe`` but for the expert-parallel lowering).

The FFN is ``repro``'s single-device lowering, ``moe_ffn_dense``:
capacity-bounded top-k routing with token dropping (GShard-style), every
expert run over its capacity buffer, so a step reads every expert's
weights. The routing, the dispatch, the expert GEMMs (``torch.bmm``) and
the combine are plain PyTorch, as they are XLA in the JAX package,
outside any Pallas kernel. They give the same bits on every call: the
dispatch is a plain indexed write (kept assignments have unique (expert,
position) pairs; dropped ones go to a spare row that nothing reads) and
the combine sums each token's k weighted expert outputs in one reduction
of fixed order, where ``repro`` scatter-adds both (atomics on a GPU). The
expert-parallel lowering (``moe_ffn_ep``) waits for the distributed port.

Attention reuses the dense family's self block halves
(``transformer._self_attn`` at prefill, ``transformer._decode_attn`` at
decode), so it runs under the config's impl: flash prefill (causal) and,
at decode, the fused paged kernel through ``"bt"`` or the contiguous
kernel's per-slot form. Decode routes every one of the ``max_batch``
rows, idle slots' too, as ``repro`` does: their tokens take expert
capacity.

Parameters are stacked on a leading layer axis, as in the JAX package, and
the layer loop is a Python loop over per-layer views.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init (seeded by a torch.Generator on the target device)


def _expert_init(gen: torch.Generator, shape, dtype, in_axis: int,
                 device) -> torch.Tensor:
    """``L.dense_init`` drawn one layer (leading index) at a time: a whole
    stack of moonshot's experts would need a 35 GB f32 draw."""
    w = torch.empty(shape, dtype=dtype, device=device)
    scale = 1.0 / shape[in_axis] ** 0.5
    for i in range(shape[0]):
        w[i] = (torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                            device=device) * scale).to(dtype)
    return w


def _moe_mlp_init(cfg: ArchConfig, gen: torch.Generator, n: int, dtype,
                  device) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": L.dense_init(gen, (n, d, e), torch.float32, 1,
                               device=device),
        "w_gate": _expert_init(gen, (n, e, d, f), dtype, 2, device),
        "w_up": _expert_init(gen, (n, e, d, f), dtype, 2, device),
        "w_down": _expert_init(gen, (n, e, f, d), dtype, 2, device),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": L.dense_init(gen, (n, d, fs), dtype, 1, device=device),
            "w_up": L.dense_init(gen, (n, d, fs), dtype, 1, device=device),
            "w_down": L.dense_init(gen, (n, fs, d), dtype, 1, device=device),
        }
    return p


def init_moe(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    """Embedding, the stacked attention + MoE layers, final norm, head."""
    dtype = T.DTYPES[cfg.param_dtype]
    n, d = cfg.n_layers, cfg.d_model
    return {
        "embed": L.embed_init(gen, (cfg.vocab, d), dtype, device=device),
        "layers": {
            "attn": T._attn_stack_init(cfg, gen, n, dtype, device),
            "moe": _moe_mlp_init(cfg, gen, n, dtype, device),
            "ln1": torch.zeros((n, d), dtype=dtype, device=device),
            "ln2": torch.zeros((n, d), dtype=dtype, device=device),
        },
        "ln_f": torch.zeros((d,), dtype=dtype, device=device),
        "head": L.embed_init(gen, (cfg.vocab, d), dtype, device=device),
    }


# ---------------------------------------------------------------------------
# routing


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """x2d: (T, d). Returns (weights (T, k) f32, experts (T, k) int64).

    The top k by a stable descending sort: on equal probabilities the
    lower expert id comes first, as ``lax.top_k`` orders them
    (``torch.topk`` leaves ties unordered)."""
    logits = x2d.float() @ router
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.top_k], idx[:, :cfg.top_k]
    return w / torch.sum(w, dim=-1, keepdim=True), idx


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _dispatch_indices(idx: torch.Tensor, cfg: ArchConfig, capacity: int):
    """idx: (T, k) expert ids. Returns (pos (T, k), keep (T, k) bool): each
    assignment's position in its expert's capacity buffer, a running count
    in flattened (token-major) order, the GShard dispatch order."""
    T_, k = idx.shape
    onehot = F.one_hot(idx.reshape(T_ * k), cfg.n_experts)      # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot                  # pre-count
    pos_of = torch.sum(pos * onehot, dim=-1).reshape(T_, k)
    return pos_of, pos_of < capacity


def _expert_gemm(buf: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """buf: (E, C, d) tokens grouped per expert; per-expert SwiGLU."""
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def moe_ffn_dense(x: torch.Tensor, p: Params,
                  cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), capacity computed from all B * S rows.

    Kept assignments land at (expert, position) in an (E * C + 1, d)
    buffer by a plain indexed write (their pairs are unique); dropped ones
    go to its spare last row, which the expert GEMMs never read. The
    combine gathers each token's k outputs (a dropped one's weight is 0),
    weights them in x's dtype and sums them over k in one reduction (a
    fixed order; bf16 accumulates in f32 and rounds once, where
    ``repro``'s scatter-add rounds after each add). The backward is the
    same bits every call on the card too: the repeat is an expand, whose
    backward sums over k, and the gather an indexed read, whose backward
    accumulates sorted by index (``index_select`` and
    ``repeat_interleave`` would add with atomics). This is the port's
    only lowering: ``repro``'s expert-parallel ``moe_ffn_ep`` waits for
    the distributed port."""
    B, S, d = x.shape
    n = B * S
    k, E = cfg.top_k, cfg.n_experts
    x2 = x.reshape(n, d)
    w, idx = _route(x2, p["router"], cfg)
    C = _capacity(n, cfg)
    pos, keep = _dispatch_indices(idx, cfg, C)
    flat = (idx * C + pos).masked_fill(~keep, E * C).reshape(n * k)
    buf = x.new_zeros((E * C + 1, d))
    buf.index_copy_(0, flat, x2[:, None].expand(n, k, d).reshape(n * k, d))
    out = _expert_gemm(buf[:E * C].view(E, C, d), p["w_gate"], p["w_up"],
                       p["w_down"]).reshape(E * C, d)
    gathered = out[torch.clamp(flat, max=E * C - 1)]
    w_f = (w * keep).to(x.dtype)
    y = torch.sum(gathered.reshape(n, k, d) * w_f[..., None], dim=1)
    y = y.reshape(B, S, d)
    if "shared" in p:
        y = y + L.swiglu(x, p["shared"])
    return y


# ---------------------------------------------------------------------------
# full model: forward / prefill / decode


def _moe_residual(cfg: ArchConfig, x, o, blk):
    x = x + L.attn_out(o, blk["attn"])
    return x + moe_ffn_dense(L.rmsnorm(x, blk["ln2"]), blk["moe"], cfg)


def forward_moe(cfg: ArchConfig, params: Params,
                tokens: torch.Tensor) -> torch.Tensor:
    """The causal forward of training (the dense dispatch; ``repro``'s
    expert-parallel lowering waits for the distributed port): tokens (B,
    S) -> logits (B, S, V) f32, each layer a remat body. Capacity comes
    from all B * S tokens."""
    positions = T._positions(tokens)
    x = L.embed_tokens(tokens, params["embed"], T.DTYPES[cfg.dtype])

    def body(x, blk):
        o, _, _ = T._self_attn(cfg, x, blk, positions)
        return _moe_residual(cfg, x, o, blk)

    for blk in T.unstack(params["layers"], cfg.n_layers):
        x = T.remat(cfg, body, x, blk)
    return T._logits(params, x)


def prefill_moe(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                length: Optional[torch.Tensor] = None):
    """tokens (B, S), right-padded; ``length`` (B,) valid prefix lengths.

    Expert capacity comes from the padded token count, as in ``repro``:
    padded rows are routed too. Returns next-token logits (B, 1, V) f32,
    read at ``length - 1``, and the prompt cache ``{"k", "v"}`` (L, B, S,
    K, D)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = L.embed_tokens(tokens, params["embed"], T.DTYPES[cfg.dtype])
    ks, vs = [], []
    for blk in T.unstack(params["layers"], cfg.n_layers):
        o, k, v = T._self_attn(cfg, x, blk, positions)
        x = _moe_residual(cfg, x, o, blk)
        ks.append(k)
        vs.append(v)
    return T._head(cfg, params, x, length), {"k": torch.stack(ks),
                                             "v": torch.stack(vs)}


def decode_moe(cfg: ArchConfig, params: Params, cache, token: torch.Tensor,
               pos: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """One new token per slot: token (B, 1), pos (B,) int32; every row is
    routed. ``cache`` holds the pools ``"k"``/``"v"`` (L, n_phys, ps, K, D)
    and the block table ``"bt"``, or, without ``"bt"``, the contiguous
    (L, B, S_max, K, D) rows; either is updated in place. Returns (logits
    (B, 1, V) f32, cache)."""
    bt = cache.get("bt")
    x = L.embed_tokens(token, params["embed"], T.DTYPES[cfg.dtype])
    for i, blk in enumerate(T.unstack(params["layers"], cfg.n_layers)):
        o = T._decode_attn(cfg, x, blk, cache["k"][i], cache["v"][i], bt,
                           pos)
        x = _moe_residual(cfg, x, o, blk)
    return T._head(cfg, params, x), cache
