"""KV cache primitives (``repro.models.kvcache``): the contiguous per-slot
write, the paged write and views, the page copies of copy-on-write and
host swap, and the leaf layout helpers the serving engine pages any
family's cache with.

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

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


def update_layer_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       pos: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (B, S_new, K, D) rows at position ``pos`` of a contiguous
    (B, S_max, K, D) buffer, in place: the contiguous layout's decode
    write. ``pos`` is a shared scalar or a (B,) tensor of per-slot
    positions; as ``lax.dynamic_update_slice`` does, a start is clamped so
    that the rows fit.

    One ``index_put_`` over (slot, row) index tensors: no mask, no read
    back to the host, so a CUDA graph captures it."""
    B, S_max = k_cache.shape[:2]
    S_new = k_new.shape[1]
    pos = torch.as_tensor(pos, device=k_cache.device).long()
    pos = pos.expand(B) if pos.ndim == 0 else pos
    start = torch.clamp(pos, 0, S_max - S_new)
    rows = start[:, None] + torch.arange(S_new, device=k_cache.device)
    slots = torch.arange(B, device=k_cache.device)[:, None].expand(B, S_new)
    k_cache.index_put_((slots, rows), k_new.to(k_cache.dtype))
    v_cache.index_put_((slots, rows), v_new.to(v_cache.dtype))
    return k_cache, v_cache


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


def _page_ids(page_ids, n_pages: int, what: str) -> torch.Tensor:
    ids = np.asarray(page_ids, np.int64).reshape(-1)
    if ((ids < 0) | (ids >= n_pages)).any():
        raise ValueError(f"{what}: page ids {ids.tolist()} outside the "
                         f"{n_pages} allocatable pages")
    return torch.from_numpy(ids)


def copy_pool_page(pool: torch.Tensor, src: int, dst: int, seq_axis: int,
                   n_pages: Optional[int] = None) -> torch.Tensor:
    """Copy physical page ``src`` of a pool leaf into page ``dst`` (page
    axis at ``seq_axis - 1``), in place: the device half of copy-on-write,
    run at a host boundary when a cache-hit seat must rewrite a position
    inside a shared page. ``n_pages`` is the allocator's page count (the
    pool's by default): a ``dst`` at or past it is dropped, as JAX's
    ``mode="drop"`` drops it, so the kernel layout's trash page at index
    ``n_pages`` is never written."""
    pa = seq_axis - 1
    n = pool.shape[pa] if n_pages is None else n_pages
    if not 0 <= int(src) < n:
        raise ValueError(f"copy_pool_page: source page {src} outside the "
                         f"{n} allocatable pages")
    if 0 <= int(dst) < n:
        pool.select(pa, int(dst)).copy_(pool.select(pa, int(src)))
    return pool


def gather_pool_pages(pool: torch.Tensor, page_ids: Any, seq_axis: int,
                      n_pages: Optional[int] = None) -> torch.Tensor:
    """Copy the listed physical pages of a pool leaf to host memory: the
    swap-out payload, ``(n, page_size, ...)`` with the page and in-page
    axes leading, a plain CPU tensor. The bytes are copied, so the pages
    can be reclaimed (and rewritten) at once. Every id must be an
    allocatable page (below ``n_pages``, the pool's count by default):
    the gather never lists the trash page."""
    pa = seq_axis - 1
    n = pool.shape[pa] if n_pages is None else n_pages
    ids = _page_ids(page_ids, n, "gather_pool_pages").to(pool.device)
    return pool.movedim((pa, pa + 1), (0, 1)).index_select(0, ids).cpu()


def scatter_pool_pages(pool: torch.Tensor, host_pages: torch.Tensor,
                       page_ids: Any, seq_axis: int,
                       n_pages: Optional[int] = None) -> torch.Tensor:
    """Write host page bytes (from ``gather_pool_pages``) back into a pool
    leaf at the listed physical pages, in place: the swap-in half of host
    swap. Ids at or past ``n_pages`` (the pool's count by default) are
    dropped, as every pool scatter drops the sentinel, so the kernel
    layout's trash page is never written."""
    pa = seq_axis - 1
    n = pool.shape[pa] if n_pages is None else n_pages
    ids = np.asarray(page_ids, np.int64).reshape(-1)
    keep = np.nonzero((ids >= 0) & (ids < n))[0]
    if keep.size == 0:
        return pool
    dst = torch.from_numpy(ids[keep]).to(pool.device)
    src = host_pages[torch.from_numpy(keep)]
    view = pool.movedim((pa, pa + 1), (0, 1))
    view[dst] = src.to(device=pool.device, dtype=pool.dtype)
    return pool


def page_rows_of(new: torch.Tensor, bax: int, sax: int,
                 page_size: int) -> torch.Tensor:
    """Prefill leaf ``new`` (batch at ``bax``, sequence at ``sax``) as
    page-shaped rows ``(nb * n_rows, ..., page_size, ...)``: the sequence
    padded to whole pages and split, row ``b * n_rows + j`` holding page
    ``j`` of batch row ``b``."""
    new = new.movedim(bax, 0)                       # (nb, ..., S@sax, ...)
    nb = new.shape[0]
    n_rows = -(-new.shape[sax] // page_size)
    pad = [0, 0] * (new.ndim - 1 - sax) + [0, n_rows * page_size
                                           - new.shape[sax]]
    new = torch.nn.functional.pad(new, pad)
    new = new.reshape(new.shape[:sax] + (n_rows, page_size)
                      + new.shape[sax + 1:])
    return new.movedim(sax, 1).reshape((nb * n_rows,) + new.shape[1:sax]
                                       + new.shape[sax + 1:])


def scatter_page_rows(pool: torch.Tensor, new: torch.Tensor,
                      src: torch.Tensor, dst: torch.Tensor, bax: int,
                      sax: int) -> None:
    """Write prefill leaf ``new`` into its pool in place with index tensors
    of a fixed length: page row ``src[i]`` (``page_rows_of``) goes to
    physical page ``dst[i]``. The caller sends a page row that must be
    dropped (a sentinel page, an admit batch's padding row) to a copy of a
    kept one, its ``src`` and ``dst`` repeated, so duplicate indices carry
    the same bytes: no mask and no read back, so a CUDA graph captures
    it."""
    rows = page_rows_of(new, bax, sax, pool.shape[sax])
    pool.movedim(sax - 1, 0)[dst] = rows.index_select(0, src).to(pool.dtype)


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
