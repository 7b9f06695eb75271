"""KV cache primitives (``repro.models.kvcache``): the contiguous per-slot
write, the paged one-token and window writes and views, the page copies of
copy-on-write and host swap, the per-slot state resets and copies, and the
leaf layout helpers the serving engine pages any family's cache with.

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
from torch.distributed.tensor import DTensor, Replicate, Shard


def update_layer_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       pos: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (B, S_new, K, D) rows at position ``pos`` of a contiguous
    (B, S_max, K, D) buffer, in place: the contiguous layout's decode
    write. ``pos`` is a shared scalar or a (B,) tensor of per-slot
    positions; as ``lax.dynamic_update_slice`` does, a start is clamped so
    that the rows fit.

    A tensor ``pos`` takes one ``index_put_`` over (slot, row) index
    tensors: no mask, no read back to the host, so a CUDA graph captures
    it. An int ``pos`` takes a slice write, with no index tensor made from
    a host value. DTensor caches (on a mesh) take
    ``_sharded_update_layer_cache``."""
    if isinstance(k_cache, DTensor):
        return _sharded_update_layer_cache(k_cache, v_cache, k_new, v_new,
                                           pos)
    B, S_max = k_cache.shape[:2]
    S_new = k_new.shape[1]
    if isinstance(pos, int):
        start = min(max(pos, 0), S_max - S_new)
        k_cache[:, start:start + S_new] = k_new.to(k_cache.dtype)
        v_cache[:, start:start + S_new] = v_new.to(v_cache.dtype)
        return k_cache, v_cache
    pos = torch.as_tensor(pos, device=k_cache.device).long()
    pos = pos.expand(B) if pos.ndim == 0 else pos
    start = torch.clamp(pos, 0, S_max - S_new)
    rows = start[:, None] + torch.arange(S_new, device=k_cache.device)
    slots = torch.arange(B, device=k_cache.device)[:, None].expand(B, S_new)
    k_cache.index_put_((slots, rows), k_new.to(k_cache.dtype))
    v_cache.index_put_((slots, rows), v_new.to(v_cache.dtype))
    return k_cache, v_cache


def _sharded_update_layer_cache(k_cache, v_cache, k_new, v_new, pos):
    """``update_layer_cache`` on DTensor caches, a local region over the
    caches' placements (``sharding.cache_specs``): each rank writes the
    rows of its own slots that fall in its own span of the sequence, at
    the same clamped starts as the whole-tensor write. The new rows are
    redistributed to the cache's placements, replicated over a mesh dim
    that shards the sequence; ``pos`` is the same on every rank. The
    write takes one window row at a time, every slot at once: a slot whose
    row falls outside the rank's span writes back the value it reads at
    the clamped row, so no write depends on the data for its shape."""
    mesh = k_cache.device_mesh
    pl = tuple(k_cache.placements)
    row_pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
              for p in pl]
    B, S_max = k_cache.shape[:2]
    S_new = k_new.shape[1]
    local_shape, offset = _local_span(k_cache.shape, mesh, pl)
    kl, vl = k_cache.to_local(), v_cache.to_local()
    if isinstance(pos, DTensor):
        pos = pos.full_tensor()
    pos = torch.as_tensor(pos, device=kl.device).long()
    pos = pos.expand(B) if pos.ndim == 0 else pos
    start = torch.clamp(pos, 0, S_max - S_new)
    b0, t0 = offset[0], offset[1]
    b_local, t_local = local_shape[0], local_shape[1]
    slots = torch.arange(b_local, device=kl.device)
    for cache, new in ((kl, k_new), (vl, v_new)):
        if not isinstance(new, DTensor):
            new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        new = new.redistribute(mesh, row_pl).to_local().to(cache.dtype)
        for s in range(S_new):
            row = start[b0:b0 + b_local] - t0 + s
            live = ((row >= 0) & (row < t_local))[:, None, None]
            row = torch.clamp(row, 0, t_local - 1)
            cache.index_put_((slots, row), torch.where(
                live, new[:, s], cache[slots, row]))
    return k_cache, v_cache


def _local_span(shape, mesh, placements) -> Tuple[list, list]:
    """(local shape, global offset) of this rank's shard of an evenly
    sharded tensor: a ``Shard(d)`` splits dim ``d`` over its mesh dim, the
    mesh dims that split one tensor dim taken in mesh order, the first
    major (``sharding.to_placements``). ``cache_specs`` shards only dims
    that their mesh dims divide; any other split raises."""
    size, offset = list(shape), [0] * len(shape)
    for i, pl in enumerate(placements):
        if not isinstance(pl, Shard):
            continue
        n = mesh.size(i)
        if size[pl.dim] % n:
            raise ValueError(f"cache dim {pl.dim} of {tuple(shape)} does "
                             f"not split evenly over mesh dim {i} ({n})")
        size[pl.dim] //= n
        offset[pl.dim] += mesh.get_local_rank(i) * size[pl.dim]
    return size, offset


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


def _write_rows_drop(k_pool: torch.Tensor, v_pool: torch.Tensor,
                     page: torch.Tensor, off: torch.Tensor,
                     k_rows: torch.Tensor, v_rows: torch.Tensor) -> None:
    """Write ``N`` rows (N, K, D) at (page, off) (N,) of the pools, in
    place, dropping those whose page lies outside the pool.

    The drop reads nothing back to the host, so a CUDA graph can capture
    it: a dropped row rewrites, with its own bytes, a pool row that no kept
    row of this call writes (the first of rows 0..N not taken), where a
    mask would select rows whose number only the device knows. A pool of
    at most N rows may have no such row and takes the mask."""
    n_phys, ps = k_pool.shape[:2]
    keep = (page >= 0) & (page < n_phys)
    N = page.shape[0]
    if n_phys * ps <= N:
        k_pool[page[keep], off[keep]] = k_rows[keep].to(k_pool.dtype)
        v_pool[page[keep], off[keep]] = v_rows[keep].to(v_pool.dtype)
        return
    row = torch.clamp(page, 0, n_phys - 1) * ps + off
    taken = torch.zeros(N + 2, dtype=torch.int32, device=row.device)
    taken.index_fill_(0, row.masked_fill(~(keep & (row <= N)), N + 1), 1)
    spare = torch.argmin(taken[:N + 1]).view(1)     # the first row not taken
    dst = torch.where(keep, row, spare)
    for pool, new in ((k_pool, k_rows), (v_pool, v_rows)):
        flat = pool.view((-1,) + tuple(pool.shape[2:]))
        mask = keep.view((N,) + (1,) * (new.ndim - 1))
        flat[dst] = torch.where(mask, new.to(pool.dtype), flat[spare])


def paged_update_layer_cache(k_pool: torch.Tensor, v_pool: torch.Tensor,
                             k_new: torch.Tensor, v_new: torch.Tensor,
                             block_table: torch.Tensor,
                             pos: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token's (B, 1, K, D) k/v at logical ``pos`` of each slot,
    in place. Writes routed outside the pool are dropped, with no mask
    and no read back (``_write_rows_drop``), so a CUDA graph captures it.
    """
    page, off = page_coords(block_table, pos, k_pool.shape[1])
    _write_rows_drop(k_pool, v_pool, page, off, k_new[:, 0], v_new[:, 0])
    return k_pool, v_pool


def paged_update_window(k_pool: torch.Tensor, v_pool: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        block_table: torch.Tensor,
                        pos: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Write an S-token window's (B, S, K, D) k/v, token ``s`` of slot
    ``b`` at logical ``pos[b] + s``, through the block table into the
    shared pools, in place: the speculative verify's form of
    ``paged_update_layer_cache``. The engine attaches the window's pages
    before a round; entries at the sentinel (a free slot's) are dropped,
    as JAX's ``mode="drop"`` drops them. The B x S rows take the one-token
    write's drop: a dropped row rewrites, with its own bytes, a row that
    no kept row writes, so the write has a fixed shape and a CUDA graph
    captures it."""
    ps = k_pool.shape[1]
    B, S = k_new.shape[:2]
    pos_bs = pos.reshape(-1, 1).long() + torch.arange(
        S, device=k_new.device)
    blk = torch.clamp(pos_bs // ps, 0, block_table.shape[1] - 1)
    page = torch.gather(block_table.long(), 1, blk)            # (B, S)
    off = pos_bs % ps
    tail = tuple(k_new.shape[2:])
    _write_rows_drop(k_pool, v_pool, page.reshape(-1), off.reshape(-1),
                     k_new.reshape((B * S,) + tail),
                     v_new.reshape((B * S,) + tail))
    return k_pool, v_pool


def reset_slot_rows(leaf: torch.Tensor, batch_axis: int, take: torch.Tensor,
                    empty_row: torch.Tensor) -> torch.Tensor:
    """Replace, in place, the batch rows of a per-slot state leaf selected
    by ``take`` (B,) bool with ``empty_row`` (the leaf's one-row empty
    state, batch axis leading): the slot reset of in-segment refill and of
    a seat. A masked write of fixed shape (no boolean indexing, no read
    back), so a CUDA graph captures it."""
    view = leaf.movedim(batch_axis, 0)
    mask = take.view((-1,) + (1,) * (view.ndim - 1))
    view.copy_(torch.where(mask, empty_row.to(view.dtype), view))
    return leaf


def gather_state_rows(leaf: torch.Tensor, batch_axis: int,
                      slot: int) -> torch.Tensor:
    """Copy one slot's row of a per-slot state leaf (SSM and conv states:
    no sequence axis) to host memory: the swap payload of recurrent
    state, a plain CPU tensor."""
    return leaf.movedim(batch_axis, 0)[slot].cpu()


def scatter_state_rows(leaf: torch.Tensor, batch_axis: int, slot: int,
                       host_row: torch.Tensor) -> torch.Tensor:
    """Write a host state row (from ``gather_state_rows``) back into
    ``slot`` of a per-slot state leaf, in place."""
    leaf.movedim(batch_axis, 0)[slot] = host_row.to(device=leaf.device,
                                                    dtype=leaf.dtype)
    return leaf


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
