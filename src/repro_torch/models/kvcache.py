"""Paged KV cache primitives (the paged part of ``repro.models.kvcache``).

A shared page pool ``(n_pages, page_size, K, D)`` per layer plus a per-slot
block table ``(B, P)`` of page indices: logical position ``p`` of slot ``b``
lives at ``pool[bt[b, p // page_size], p % page_size]``. Unallocated entries
hold a sentinel one past the allocated pages.

JAX drops out-of-range scatter writes (``mode="drop"``) and clamps gathers
(``mode="clip"``); torch indexing instead raises on the CPU and
device-asserts on CUDA. The functions here emulate both with explicit
masks and clamps. Unlike the JAX versions they update pools in place.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch


def page_coords(block_table: torch.Tensor, pos: Any,
                page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page, offset) of logical position ``pos`` (scalar or (B,)) per slot.

    Sentinel entries are returned as they are, so the write below drops
    them.
    """
    B, P = block_table.shape
    pos = torch.as_tensor(pos, device=block_table.device).long()
    pos = pos.expand(B) if pos.ndim == 0 else pos
    blk = torch.clamp(pos // page_size, 0, P - 1)
    page = torch.gather(block_table.long(), 1, blk[:, None])[:, 0]
    return page, pos % page_size


def paged_update_layer_cache(k_pool: torch.Tensor, v_pool: torch.Tensor,
                             k_new: torch.Tensor, v_new: torch.Tensor,
                             block_table: torch.Tensor,
                             pos: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token's (B, 1, K, D) k/v at logical ``pos`` of each slot,
    in place. Writes routed outside the pool are dropped."""
    page, off = page_coords(block_table, pos, k_pool.shape[1])
    keep = (page >= 0) & (page < k_pool.shape[0])
    k_pool[page[keep], off[keep]] = k_new[:, 0][keep].to(k_pool.dtype)
    v_pool[page[keep], off[keep]] = v_new[:, 0][keep].to(v_pool.dtype)
    return k_pool, v_pool


def sentinel_block_table(n_rows: int, pages_per_slot: int,
                         n_pages: int) -> np.ndarray:
    """All-sentinel block-table rows (host-side, int32): every entry is
    ``n_pages``, one past the allocated pages."""
    return np.full((n_rows, pages_per_slot), n_pages, np.int32)


def gather_block_kv(pool: torch.Tensor,
                    block_table: torch.Tensor) -> torch.Tensor:
    """Each slot's logical KV view (B, P * page_size, K, D) from the pool.

    Entries outside the pool clamp to its last page; their positions lie at
    or past the caller's valid length and mask out.
    """
    B, P = block_table.shape
    ps = pool.shape[1]
    idx = torch.clamp(block_table.long(), 0, pool.shape[0] - 1)
    return pool[idx].reshape((B, P * ps) + tuple(pool.shape[2:]))
