"""Paged KV cache primitives (the paged part of ``repro.models.kvcache``)
and the leaf layout helpers the serving engine pages any family's cache
with.

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

from typing import Any, Callable, Dict, Tuple

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
    in place. Writes routed outside the pool are dropped.

    The drop reads nothing back to the host, so a CUDA graph can capture
    it: a dropped row rewrites, with its own bytes, a pool row that no kept
    row of this call writes (the first of rows 0..B not taken), where a
    mask would select rows whose number only the device knows. A pool of
    at most B rows may have no such row and takes the mask.
    """
    n_phys, ps = k_pool.shape[:2]
    page, off = page_coords(block_table, pos, ps)
    keep = (page >= 0) & (page < n_phys)
    B = page.shape[0]
    if n_phys * ps <= B:
        k_pool[page[keep], off[keep]] = k_new[:, 0][keep].to(k_pool.dtype)
        v_pool[page[keep], off[keep]] = v_new[:, 0][keep].to(v_pool.dtype)
        return k_pool, v_pool
    row = torch.clamp(page, 0, n_phys - 1) * ps + off
    taken = torch.zeros(B + 2, dtype=torch.int32, device=row.device)
    taken.index_fill_(0, row.masked_fill(~(keep & (row <= B)), B + 1), 1)
    spare = torch.argmin(taken[:B + 1]).view(1)     # the first row not taken
    dst = torch.where(keep, row, spare)
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        flat = pool.view((-1,) + tuple(pool.shape[2:]))
        mask = keep.view((B,) + (1,) * (new.ndim - 2))
        flat[dst] = torch.where(mask, new[:, 0].to(pool.dtype), flat[spare])
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


def first_diff(a, b) -> int:
    """The first axis where two shapes differ, -1 where none does."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), -1)


def leaf_axes(cache_shapes: Callable[..., Dict[str, Any]],
              max_len: int) -> Dict[str, Tuple[int, int]]:
    """name -> (batch axis, sequence axis) of each cache leaf, found by
    diffing ``cache_shapes`` at two batch sizes and at two lengths, as the
    JAX engine does (``repro/serving/engine.py:782-800``). The sequence
    axis is -1 for a leaf without one (per-slot state)."""
    s2 = cache_shapes(2, max_len, enc_len=max_len)
    s3 = cache_shapes(3, max_len, enc_len=max_len)
    l2 = cache_shapes(2, max_len + 8, enc_len=max_len + 8)
    return {n: (first_diff(s2[n][0], s3[n][0]), first_diff(s2[n][0], l2[n][0]))
            for n in s2}


def pool_shape(dims, bax: int, sax: int, n_pages: int,
               page_size: int) -> Tuple[int, ...]:
    """Contiguous leaf shape -> shared-pool shape: the batch axis dropped,
    the sequence axis split into ``(n_pages, page_size)``."""
    if not 0 <= bax < sax:
        raise ValueError(f"leaf {tuple(dims)}: batch axis {bax}, sequence "
                         f"axis {sax}")
    return (tuple(dims[:bax]) + tuple(dims[bax + 1:sax])
            + (n_pages, page_size) + tuple(dims[sax + 1:]))


def scatter_pages(pool: torch.Tensor, new: torch.Tensor,
                  page_rows: np.ndarray, bax: int, sax: int) -> None:
    """Write prefill leaf ``new`` (batch at ``bax``, sequence at ``sax``)
    into its pool, in place, page by page: page ``j`` of row ``b`` goes to
    ``page_rows[b, j]`` (host-side, so no device sync). Pages outside the
    pool are dropped, as JAX's ``mode="drop"`` does."""
    nb, n_rows = page_rows.shape
    ps = pool.shape[sax]
    ids = page_rows.reshape(-1)
    keep = np.nonzero((ids >= 0) & (ids < pool.shape[sax - 1]))[0]
    if keep.size == 0:
        return
    dst = torch.from_numpy(ids[keep].astype(np.int64)).to(pool.device)
    src = torch.from_numpy(keep.astype(np.int64)).to(pool.device)
    new = new.movedim(bax, 0)                       # (nb, ..., S@sax, ...)
    pad = [0, 0] * (new.ndim - 1 - sax) + [0, n_rows * ps - new.shape[sax]]
    new = torch.nn.functional.pad(new, pad)
    new = new.reshape(new.shape[:sax] + (n_rows, ps) + new.shape[sax + 1:])
    new = new.movedim(sax, 1).reshape((nb * n_rows,) + new.shape[1:sax]
                                      + new.shape[sax + 1:])
    pool.movedim(sax - 1, 0)[dst] = new[src].to(pool.dtype)
