"""Plain PyTorch versions of the ported kernels (``repro.kernels.ref``).

Each function computes what its kernel computes with ordinary tensor ops.
The CPU tests hold them to the JAX kernels (interpret mode) and to
``repro.kernels.ref``; ``chip_smoke.py`` holds each CUDA kernel to them on
the card. Numerics follow ``repro.kernels.ref``: scores and softmax in f32,
probabilities cast to ``q.dtype`` before the PV product. The kernels keep
the probabilities in f32 (as the Pallas bodies do), so the two agree
exactly in f32 and to bf16 rounding in bf16.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def bf16_ulp_ratio(got: torch.Tensor, want32: torch.Tensor) -> float:
    """Worst error of a bf16 kernel result against the plain version run in
    f32 on the same (widened) inputs, over one bf16 ulp of the reference
    (rounding the f32 result to bf16 costs at most half of one) plus 1e-5
    for f32 sums taken in another order. The kernels are held to <= 1."""
    ref = want32.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -60)))
                     - 7)
    return ((got.float() - ref).abs() / (ulp + 1e-5)).max().item()


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0,
                        kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, D); k/v: (B, K, T, D) with H = K * G. Returns (B, H, S, D)."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, S, D)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg.float(), k.float()) \
        * (D ** -0.5)
    t_idx = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        s_idx = torch.arange(S, device=q.device)[:, None] + q_offset
        mask = t_idx[None, :] <= s_idx
    if kv_valid_len is not None:
        mask = mask & (t_idx[None, :] < kv_valid_len)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.to(q.dtype))
    return out.reshape(B, H, S, D)


def fused_paged_decode_attention_ref(q, k_new, v_new, k_pool, v_pool,
                                     block_table, pos):
    """One-token paged decode: scatter the new k/v row, then masked attend.

    q: (B, K, G, D); k_new/v_new: (B, K, D); pools (n_phys, ps, K, D);
    block_table (B, P); pos (B,). The same composition as
    ``repro.models.layers.paged_update_attend``'s XLA branch: the write goes
    to ``pool[bt[b, clip(pos // ps)], pos % ps]`` and is dropped when that
    entry lies outside the pool; the attend gathers each slot's pages
    (entries clamped into the pool) and masks positions ``>= pos + 1``.

    The pools are updated in place. Returns ``(out, k_pool, v_pool)`` with
    ``out`` (B, K, G, D) in ``q.dtype``.
    """
    B, K, G, D = q.shape
    n_phys, ps = k_pool.shape[:2]
    P = block_table.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.long, device=q.device)
    pos = pos.expand(B) if pos.ndim == 0 else pos.long()
    bt = block_table.long()
    blk = torch.clamp(pos // ps, 0, P - 1)
    page = torch.gather(bt, 1, blk[:, None])[:, 0]
    off = pos % ps
    keep = (page >= 0) & (page < n_phys)
    k_pool[page[keep], off[keep]] = k_new[keep].to(k_pool.dtype)
    v_pool[page[keep], off[keep]] = v_new[keep].to(v_pool.dtype)
    pages = torch.clamp(bt, 0, n_phys - 1)
    kc = k_pool[pages].reshape(B, P * ps, K, D)
    vc = v_pool[pages].reshape(B, P * ps, K, D)
    scores = torch.einsum("bkgd,btkd->bkgt", q.float(), kc.float()) \
        * (D ** -0.5)
    t_idx = torch.arange(P * ps, device=q.device)
    mask = (t_idx[None, :] < (pos + 1)[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, vc.to(q.dtype))
    return out, k_pool, v_pool


def _masked_decode(q, k, v, valid_len):
    """q (B, K, G, D); k/v (B, T, K, D); valid_len (B,) long. Rows ``>=``
    valid_len mask out; a slot with valid_len 0 gets zeros, as the kernels
    give (they divide by ``max(l, 1e-30)`` with ``l = 0``)."""
    D = q.shape[-1]
    T = k.shape[1]
    scores = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float()) \
        * (D ** -0.5)
    live = torch.arange(T, device=q.device)[None, :] < valid_len[:, None]
    scores = torch.where(live[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v.to(q.dtype))
    return torch.where((valid_len > 0)[:, None, None, None], out,
                       torch.zeros_like(out))


def _per_slot(valid_len, B: int, default: int, device) -> torch.Tensor:
    if valid_len is None:
        return torch.full((B,), default, dtype=torch.long, device=device)
    return torch.as_tensor(valid_len, device=device).long().expand(B)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len=None) -> torch.Tensor:
    """One-token decode over a contiguous cache (``repro``'s
    ``decode_attention_ref``). q: (B, K, G, D); k/v: (B, K, T, D);
    valid_len a scalar (default T). Returns (B, K, G, D) in q.dtype."""
    B, T = q.shape[0], k.shape[2]
    vlen = _per_slot(valid_len, B, T, q.device)
    return _masked_decode(q, k.transpose(1, 2), v.transpose(1, 2), vlen)


def paged_decode_attention_ref(q, k_pool, v_pool, block_table,
                               valid_len=None) -> torch.Tensor:
    """One-token decode through a block table, attend only.

    q: (B, K, G, D); pools (n_phys, ps, K, D); block_table (B, P), entries
    clamped into the pool; valid_len a scalar or (B,) per-slot lengths over
    the slot's logical P * ps positions (default all of them). Returns
    (B, K, G, D) in q.dtype.
    """
    B, P = block_table.shape
    n_phys, ps = k_pool.shape[:2]
    pages = torch.clamp(block_table.long(), 0, n_phys - 1)
    kc = k_pool[pages].reshape((B, P * ps) + tuple(k_pool.shape[2:]))
    vc = v_pool[pages].reshape((B, P * ps) + tuple(v_pool.shape[2:]))
    vlen = _per_slot(valid_len, B, P * ps, q.device)
    return _masked_decode(q, kc, vc, vlen)


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """x: (M, Kd); w_q: (Kd, N) int8; scales: (N,) f32. Returns x.dtype."""
    w = w_q.float() * scales[None, :].float()
    return (x.float() @ w).to(x.dtype)


def quantize_int8(w: torch.Tensor):
    """Per-output-channel symmetric int8 quantization. w: (Kd, N)."""
    absmax = w.float().abs().amax(dim=0)
    scales = torch.where(absmax > 0, absmax / 127.0,
                         torch.ones_like(absmax))
    w_q = torch.clamp(torch.round(w.float() / scales[None, :]), -127, 127)
    return w_q.to(torch.int8), scales
