"""Decode attention wrappers of ``csrc/fused_paged_decode.cu``,
``csrc/paged_decode.cu`` and ``csrc/decode_attention.cu``.

They replace the three Pallas TPU kernels of
``repro/kernels/decode_attention.py``:

* ``fused_paged_decode_attention`` (``_fused_paged_decode_kernel``): one
  token's KV write into its page, then the attend over the slot's pages.
  The source states the pool contract it relies on (a trash page at
  ``n_phys - 1`` equal to the block table's sentinel; written pages
  private to their slot).
* ``paged_decode_attention`` (``_paged_decode_kernel``): attend only,
  through a block table, with per-slot valid lengths.
* ``decode_attention`` (``_decode_kernel``): attend over a contiguous cache
  with one scalar valid length or, beyond the Pallas kernel, per-slot
  lengths read on the device; here k/v come in the model layout
  ``(B, T, K, D)``.

All three are bound by the bytes of the live K/V rows; each source's note
says what its design does about that. All three split each slot's rows
into at most ``MAX_SPLIT`` spans, one block per (span, KV head, slot), and
fold them in the same launch: the spans of one slot and KV head fold their
partials as one cluster of blocks, with no workspace.

Each kernel has two bodies, picked by ``decode_body`` from the dtype, the
query heads per KV head and the head dim: bf16 at D in {64, 96, 128} runs
on the tensor cores (``csrc/decode_mma.cuh``), f32 at D in {16, 32, 64, 96,
128} on the SIMT body (``csrc/decode_split.cuh``), each at G up to
``GMAX`` = 16 (a body of 8 fragment rows for G <= 8, of 16 above), but the
f32 body at D 128, which takes G <= 8 (``SIMT_G16_DIMS``); any other triple
raises, and no call falls back from one body to the other.

On a CPU tensor a wrapper computes the plain version (``ref``); on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES, HEAD_DIMS
from repro_torch.kernels.ref import (decode_attention_ref,
                                     fused_paged_decode_attention_ref,
                                     paged_decode_attention_ref)

GMAX = 16         # query heads per KV head that one block serves
# (body, head dims) of the decode kernels for each dtype
BODIES = {torch.bfloat16: ("mma", (64, 96, 128)),
          torch.float32: ("simt", HEAD_DIMS)}
# head dims at which the SIMT body takes G of 9 to 16: at D 128 its shared
# memory would pass the 48 KB a kernel may declare statically
# (``csrc/decode_split.cuh`` ``simt_fits``)
SIMT_G16_DIMS = (16, 32, 64, 96)
# Rows of a slot's sequence one block attends over: the rows are cut into
# at most MAX_SPLIT spans, one block each, one cluster of blocks per (slot,
# KV head) that folds them in the same launch: SPLIT_ROWS each for the SIMT
# body; for the tensor-core body whole 64-row tiles, FUSED_SPLIT_ROWS for
# the two paged kernels and the contiguous kernel's per-slot form (most of
# a slot's rows lie past its length, which the host does not read; the
# per-slot form takes the fused kernel's plan so that a contiguous slot
# folds the same spans as a paged one), and, for the contiguous kernel's
# scalar form, whose rows are all live, as many spans as give its B * K
# pairs one block on each SM at most (the fold's cost grows with the
# spans, and one block per SM already streams at the card's rate). Longer
# rows get longer spans.
SPLIT_ROWS = 128
TILE_ROWS = 64
FUSED_SPLIT_ROWS = 128
MAX_SPLIT = 8     # a portable cluster (csrc/decode_split.cuh MAX_SPLIT)
_sm_counts = {}


def _sm_count(device) -> int:
    n = _sm_counts.get(device.index)
    if n is None:
        n = _sm_counts[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


def decode_body(dtype: torch.dtype, G: int, head_dim: int) -> str:
    """The body of the decode kernels that takes ``dtype`` with ``G`` query
    heads per KV head at ``head_dim``: ``"mma"`` (tensor cores, bf16) or
    ``"simt"`` (f32). Raises for any other triple."""
    if dtype not in BODIES:
        raise TypeError(f"decode attention: dtype {dtype}; want float32 or "
                        "bfloat16")
    if not 1 <= G <= GMAX:
        raise ValueError(f"decode attention: G={G} query heads per KV head; "
                         f"the kernels take 1 to {GMAX}")
    body, dims = BODIES[dtype]
    if head_dim not in dims:
        raise ValueError(f"decode attention: the {body} body takes {dtype} "
                         f"at head_dim {dims}, not {head_dim}")
    if body == "simt" and G > 8 and head_dim not in SIMT_G16_DIMS:
        raise ValueError(f"decode attention: the simt body takes G={G} "
                         f"at head_dim {SIMT_G16_DIMS}, not {head_dim}")
    return body


def _split(name: str, body: str, rows: int, q) -> tuple:
    """(n_split, split_rows) of ``rows`` logical rows for ``body`` of the
    decode kernel ``name`` (q: the query, for its slots, heads and
    device). ``"decode_attention"`` is the contiguous kernel's scalar
    form; its per-slot form plans as the fused kernel does."""
    if body != "mma":
        n = -(-rows // SPLIT_ROWS)
    elif name == "decode_attention":
        n = _sm_count(q.device) // (q.shape[0] * q.shape[1])
    else:
        n = -(-rows // FUSED_SPLIT_ROWS)
    split = -(-rows // max(1, min(n, MAX_SPLIT)))
    if body == "mma":
        split = max(TILE_ROWS, -(-split // TILE_ROWS) * TILE_ROWS)
    split = max(split, 1)
    return max(1, -(-rows // split)), split


def _check_aligned(what: str, body: str, tensors) -> None:
    if body == "mma" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the tensor-core body copies 16-byte "
                         "pieces; inputs must be 16-byte aligned")


def fused_paged_decode_attention(q, k_new, v_new, k_pool, v_pool,
                                 block_table, pos):
    """q: (B, K, G, D); k_new/v_new: (B, K, D); pools (n_phys, ps, K, D);
    block_table (B, P) int32; pos (B,) int32, the position each slot writes
    (and attends up to, inclusive).

    Returns ``(out, k_pool, v_pool)``, ``out`` (B, K, G, D) in q.dtype; the
    pools are the inputs, updated in place. The kernel drops a write whose
    page is the trash page ``n_phys - 1`` (an inactive slot's), which the
    plain version makes; the pool contract discards that page.
    """
    if not q.is_cuda:
        return fused_paged_decode_attention_ref(q, k_new, v_new, k_pool,
                                                v_pool, block_table, pos)
    B, K, G, D = q.shape
    n_phys, ps = k_pool.shape[:2]
    P = block_table.shape[1]
    if (k_new.shape != (B, K, D) or v_new.shape != (B, K, D)
            or k_pool.shape != (n_phys, ps, K, D)
            or v_pool.shape != k_pool.shape
            or block_table.shape != (B, P) or tuple(pos.shape) != (B,)):
        raise ValueError(
            f"fused_paged_decode_attention: q {tuple(q.shape)} k_new "
            f"{tuple(k_new.shape)} pool {tuple(k_pool.shape)} bt "
            f"{tuple(block_table.shape)} pos {tuple(pos.shape)}")
    dt = q.dtype
    if dt not in DTYPE_CODES or any(t.dtype != dt for t in
                                    (k_new, v_new, k_pool, v_pool)):
        raise TypeError("fused_paged_decode_attention: q, k/v rows and pools "
                        "must share one dtype, float32 or bfloat16")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("fused_paged_decode_attention: block_table and pos "
                        "must be int32")
    tensors = (q, k_new, v_new, k_pool, v_pool, block_table, pos)
    if any(t.device != q.device for t in tensors):
        raise ValueError("fused_paged_decode_attention: mixed devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_paged_decode_attention: inputs must be "
                         "contiguous")
    body = decode_body(dt, G, D)
    _check_aligned("fused_paged_decode_attention", body, tensors[:5])
    n_split, split = _split("fused_paged_decode_attention", body, P * ps, q)
    out = torch.empty_like(q)
    rc = build.kernel_fn("fused_paged_decode_attention")(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_table.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, K, G, D, n_phys, ps, P, n_split, split,
        DTYPE_CODES[dt],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("fused_paged_decode_attention", rc)
    return out, k_pool, v_pool


def _check_common(what, q, tensors):
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{what}: q and k/v must share one dtype, float32 or "
                        "bfloat16")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: mixed devices")
    if not all(t.is_contiguous() for t in (q, *tensors)):
        raise ValueError(f"{what}: inputs must be contiguous")


def slot_lengths(valid_len, B: int, rows: int, device) -> torch.Tensor:
    """``valid_len`` of the attend-only paged kernel and of the contiguous
    kernel's per-slot form as they read it: an int32 (B,) tensor on
    ``device``. Takes what ``repro``'s
    ``paged_decode_attention`` takes: None (``rows``, all of every slot's
    logical rows), an int, or a tensor of shape (), (1,) or (B,), broadcast
    to the B slots."""
    if valid_len is None:
        return torch.full((B,), rows, dtype=torch.int32, device=device)
    if (isinstance(valid_len, torch.Tensor)
            and valid_len.dtype == torch.int32 and valid_len.device == device
            and tuple(valid_len.shape) == (B,) and valid_len.is_contiguous()):
        return valid_len
    t = torch.as_tensor(valid_len, device=device).to(torch.int32)
    if t.dim() > 1 or t.numel() not in (1, B):
        raise ValueError(f"decode attention: valid_len of shape "
                         f"{tuple(t.shape)} for {B} slots")
    return t.reshape(-1).expand(B).contiguous()


def paged_decode_attention(q, k_pool, v_pool, block_table, valid_len=None):
    """q: (B, K, G, D); pools (n_phys, ps, K, D); block_table (B, P) int32,
    entries clamped into the pool; valid_len the per-slot lengths over the
    slot's logical P * ps positions: None (all of them), an int, or a 0-d
    or (B,) tensor (``slot_lengths``).

    Returns (B, K, G, D) in q.dtype; zeros for a slot with valid_len 0.
    """
    B, K, G, D = q.shape
    n_phys, ps = k_pool.shape[:2]
    P = block_table.shape[1]
    vlen = slot_lengths(valid_len, B, P * ps, q.device)
    if not q.is_cuda:
        return paged_decode_attention_ref(q, k_pool, v_pool, block_table,
                                          vlen)
    if (k_pool.shape != (n_phys, ps, K, D) or v_pool.shape != k_pool.shape
            or block_table.shape != (B, P)):
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)} pool "
            f"{tuple(k_pool.shape)} bt {tuple(block_table.shape)}")
    if block_table.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_table must be int32")
    _check_common("paged_decode_attention", q, (k_pool, v_pool))
    if block_table.device != q.device or not block_table.is_contiguous():
        raise ValueError("paged_decode_attention: block_table must be "
                         "contiguous on q's device")
    body = decode_body(q.dtype, G, D)
    _check_aligned("paged_decode_attention", body, (q, k_pool, v_pool))
    n_split, split = _split("paged_decode_attention", body, P * ps, q)
    out = torch.empty_like(q)
    rc = build.kernel_fn("paged_decode_attention")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), vlen.data_ptr(), out.data_ptr(), B, K, G, D,
        n_phys, ps, P, n_split, split, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("paged_decode_attention", rc)
    return out


def decode_attention_plain(q, k, v, valid_len=None) -> torch.Tensor:
    """The plain version in the model layout: k/v (B, T, K, D)."""
    return decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                valid_len)


def contiguous_plan(q, T: int, valid_len, body: str) -> tuple:
    """How the contiguous kernel takes ``valid_len`` over T rows: ``(lens,
    vlen, n_split, split_rows)``. A (B,) tensor is the per-slot form:
    ``lens`` the int32 device lengths (``slot_lengths``), read by the
    kernel alone, and the spans cut from T by the fused kernel's plan.
    Anything else is the scalar form: ``lens`` None, ``vlen`` the int
    (default T), the spans cut from it."""
    if torch.is_tensor(valid_len) and valid_len.ndim > 0:
        lens = slot_lengths(valid_len, q.shape[0], T, q.device)
        return (lens, T) + _split("fused_paged_decode_attention", body, T, q)
    vlen = T if valid_len is None else int(valid_len)
    if not 0 <= vlen <= T:
        raise ValueError(f"decode_attention: valid_len {vlen} outside "
                         f"[0, {T}]")
    return (None, vlen) + _split("decode_attention", body, vlen, q)


def decode_attention(q, k, v, valid_len=None) -> torch.Tensor:
    """q: (B, K, G, D); k/v: (B, T, K, D), the model layout; valid_len the
    rows each slot attends: an int <= T shared by every slot (default T),
    or a (B,) tensor of per-slot lengths (``slot_lengths``), which the
    kernel reads on the device, clamped into [0, T].

    The per-slot form reads no length on the host, so a CUDA graph
    captures it; its spans come from T alone, as the fused paged kernel's
    come from its P * ps rows.

    Returns (B, K, G, D) in q.dtype; zeros for a slot whose length is 0.
    """
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, valid_len)
    B, K, G, D = q.shape
    T = k.shape[1]
    if k.shape != (B, T, K, D) or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    _check_common("decode_attention", q, (k, v))
    body = decode_body(q.dtype, G, D)
    _check_aligned("decode_attention", body, (q, k, v))
    lens, vlen, n_split, split = contiguous_plan(q, T, valid_len, body)
    out = torch.empty_like(q)
    rc = build.kernel_fn("decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), out.data_ptr(),
        B, T, K, G, D, vlen, n_split, split,
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("decode_attention", rc)
    return out
