"""Shared model layers (the ported part of ``repro.models.layers``).

Plain functions over explicit parameter dicts. Attention uses the grouped
layout throughout: q is (B, S, K, G, D) with K = n_kv_heads and G =
q_per_kv; k/v are (B, T, K, D), so GQA never repeats KV.

Numerics follow the JAX layers: RMSNorm scales by ``1 + scale`` in f32,
RoPE is split-half in f32, the plain attention takes its softmax in f32 and
casts the probabilities to ``q.dtype`` before the PV product, and the LM
head accumulates and returns f32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import kvcache as KV
from repro_torch.models.quantize import QuantizedWeight, qeinsum

Params = Dict[str, Any]
NEG_INF = -1e30

# ---------------------------------------------------------------------------
# initializers (seeded by a torch.Generator on the target device)


def dense_init(gen: torch.Generator, shape, dtype, in_axis: int = -2,
               device=None) -> torch.Tensor:
    """LeCun-normal style init, fan-in along ``in_axis``."""
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / fan_in ** 0.5)).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device=None) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms and rotary embeddings


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, [K, [G,]] D) with positions (B, S) broadcast over heads."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (B, S, d/2)
    for _ in range(x.ndim - angles.ndim):
        angles = angles[..., None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_offset: int = 0,
                   kv_valid_len: Optional[Any] = None,
                   impl: str = "torch") -> torch.Tensor:
    """Grouped-query attention. q (B, S, K, G, D), k/v (B, T, K, D).

    ``kv_valid_len`` masks kv positions ``>=`` it: an int, or a (B,) tensor
    of per-slot lengths. ``impl="cuda"`` runs the kernels: a one-token
    query goes to the contiguous decode kernel, which takes either form
    (per-slot lengths are read on the device: the contiguous layout's
    decode and whisper's contiguous cross-attention), a longer one to
    flash prefill, which takes only a scalar, so per-slot lengths there
    raise by name (the JAX layer sends them to XLA; the port's callers
    ask for ``impl="torch"``).
    """
    vec_valid = torch.is_tensor(kv_valid_len) and kv_valid_len.ndim > 0
    if impl == "cuda":
        if vec_valid and q.shape[1] != 1:
            raise NotImplementedError(
                "attention_core: the flash kernel takes a scalar kv_valid_len;"
                " per-slot lengths at prefill need impl='torch'")
        return kops.flash_attention_grouped(
            q, k, v, causal=causal, q_offset=q_offset,
            kv_valid_len=kv_valid_len, impl="cuda")
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown attention impl {impl!r}")
    B, S, K, G, D = q.shape
    T = k.shape[1]
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) \
        * (D ** -0.5)
    if causal or kv_valid_len is not None:
        t_idx = torch.arange(T, device=q.device)
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
        if causal:
            s_idx = torch.arange(S, device=q.device)[:, None] + q_offset
            mask = t_idx[None, :] <= s_idx
        if kv_valid_len is not None and not vec_valid:
            mask = mask & (t_idx[None, :] < kv_valid_len)
        if vec_valid:
            per_seq = t_idx[None, :] < kv_valid_len.reshape(-1, 1)
            mask = (mask[None] & per_seq[:, None, :])[:, None, None]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v.to(q.dtype))


def window_attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """Attention of a teacher-forced decode window (the speculative
    verify). q (B, S, K, G, D); k/v (B, T, K, D), the window's rows
    already written; pos (B,) the position of each slot's first window
    token.

    Window token ``s`` of slot ``b`` sits at ``pos[b] + s`` and attends to
    positions ``<= pos[b] + s``, itself included: the decode step's
    ``kv_valid_len = pos + 1`` masked attend, batched over the window. At
    ``S == 1`` the mask is exactly the decode step's, and so are the
    operations, so a one-token window gives the decode step's bits. Plain
    PyTorch only: no kernel takes a per-row causal offset.
    """
    B, S, K, G, D = q.shape
    T = k.shape[1]
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) \
        * (D ** -0.5)
    t_idx = torch.arange(T, device=q.device)
    s_pos = pos.reshape(-1, 1, 1) + torch.arange(S, device=q.device)[:, None]
    mask = (t_idx <= s_pos)[:, None, None]            # (B, 1, 1, S, T)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v.to(q.dtype))


def paged_attention_core(q, k_pool, v_pool, block_table, *, kv_valid_len,
                         impl: str = "torch") -> torch.Tensor:
    """One-token decode attention over a paged KV cache, attend only.

    q (B, 1, K, G, D); pools (n_phys, ps, K, D); block_table (B, P) int32;
    ``kv_valid_len`` per-slot lengths: a (B,) int32 tensor, or a scalar
    for every slot. ``impl="cuda"`` runs the paged decode kernel, which
    walks the block table itself; the plain path gathers each slot's
    logical view (entries clamped into the pool) and runs the masked
    ``attention_core``.
    """
    if impl == "cuda":
        kops.require_cuda(q, "paged_attention_core")
        return kops.paged_decode_attention(
            q[:, 0].contiguous(), k_pool, v_pool, block_table,
            kv_valid_len)[:, None]
    if impl != "torch":
        raise ValueError(f"unknown attention impl {impl!r}")
    kc = KV.gather_block_kv(k_pool, block_table)
    vc = KV.gather_block_kv(v_pool, block_table)
    return attention_core(q, kc, vc, causal=False, kv_valid_len=kv_valid_len,
                          impl="torch")


def paged_update_attend(q, k, v, k_pool, v_pool, block_table, pos, *,
                        impl: str = "torch") -> Tuple[torch.Tensor, Any, Any]:
    """One decode step's paged KV write + attend; returns (o, k_pool, v_pool).

    q (B, 1, K, G, D); k/v (B, 1, K, D); pools (n_phys, ps, K, D) updated in
    place; block_table (B, P) int32; pos (B,) int32. ``impl="cuda"`` runs
    the fused kernel, which needs the engine's kernel pool layout (a trash
    page at the sentinel index); the plain path scatters with sentinel drop
    and then runs the gathered masked attend.
    """
    if impl == "cuda":
        kops.require_cuda(q, "paged_update_attend")
        o, k_pool, v_pool = kops.fused_paged_decode_attention(
            q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
            k_pool, v_pool, block_table, pos)
        return o[:, None], k_pool, v_pool
    if impl != "torch":
        raise ValueError(f"unknown attention impl {impl!r}")
    k_pool, v_pool = KV.paged_update_layer_cache(k_pool, v_pool, k, v,
                                                 block_table, pos)
    o = paged_attention_core(q, k_pool, v_pool, block_table,
                             kv_valid_len=pos + 1)
    return o, k_pool, v_pool


def attn_qkv(x: torch.Tensor, p: Params, qimpl: str = "torch"):
    """Projections of one layer: x (B, S, d) -> q (B,S,K,G,h), k/v (B,S,K,h)."""
    if isinstance(p["wq"], QuantizedWeight):
        q = qeinsum(x, p["wq"], 1, impl=qimpl)
        k = qeinsum(x, p["wk"], 1, impl=qimpl)
        v = qeinsum(x, p["wv"], 1, impl=qimpl)
        return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)
    q = torch.einsum("bsd,dkgh->bskgh", x, p["wq"])
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"])
    return q, k, v


def attn_out(o: torch.Tensor, p: Params, qimpl: str = "torch") -> torch.Tensor:
    if isinstance(p["wo"], QuantizedWeight):
        return qeinsum(o, p["wo"], 3, impl=qimpl).to(o.dtype)
    return torch.einsum("bskgh,kghd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# SwiGLU MLP


def swiglu(x: torch.Tensor, p: Params, qimpl: str = "torch") -> torch.Tensor:
    if isinstance(p["w_gate"], QuantizedWeight):
        g = qeinsum(x, p["w_gate"], 1, impl=qimpl)       # f32
        u = qeinsum(x, p["w_up"], 1, impl=qimpl)
        h = torch.nn.functional.silu(g) * u
        return qeinsum(h, p["w_down"], 1, impl=qimpl).to(x.dtype)
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["w_up"])
    h = torch.nn.functional.silu(g) * u
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])


# ---------------------------------------------------------------------------
# embeddings / lm head


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor,
                 dtype) -> torch.Tensor:
    return table[tokens.long()].to(dtype)


def select_last(x: torch.Tensor, length: Optional[torch.Tensor]) -> torch.Tensor:
    """The last *valid* position per sequence: x (B, S, d) -> (B, 1, d)."""
    if length is None:
        return x[:, -1:]
    idx = torch.clamp(length.long() - 1, 0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))


def lm_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Logits in f32, accumulated in f32 (no rounding to the working dtype).

    On CUDA a bf16 head goes through ``torch.mm(..., out_dtype=float32)``;
    elsewhere the operands are widened first.
    """
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    if x.is_cuda and x.dtype == torch.bfloat16:
        out = torch.mm(x2, head.t(), out_dtype=torch.float32)
    else:
        out = x2.float() @ head.float().t()
    return out.reshape(B, S, -1)
