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
  with one scalar valid length; here k/v come in the model layout
  ``(B, T, K, D)``.

All three are bound by the bytes of the live K/V rows; each source's note
says what its design does about that.

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

# Rows of a slot's sequence one block of the split-T kernels attends over;
# the sequence is cut into ceil(rows / SPLIT_ROWS) spans, each its own
# block, combined in a second pass (csrc/decode_split.cuh).
SPLIT_ROWS = 128


def fused_paged_decode_attention(q, k_new, v_new, k_pool, v_pool,
                                 block_table, pos):
    """q: (B, K, G, D); k_new/v_new: (B, K, D); pools (n_phys, ps, K, D);
    block_table (B, P) int32; pos (B,) int32, the position each slot writes
    (and attends up to, inclusive).

    Returns ``(out, k_pool, v_pool)``, ``out`` (B, K, G, D) in q.dtype; the
    pools are the inputs, updated in place.
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
    if G > 8 or D > 128:
        raise ValueError(f"fused_paged_decode_attention: G={G} D={D}; the "
                         "kernel takes G <= 8 and D <= 128")
    out = torch.empty_like(q)
    rc = build.kernel_fn("fused_paged_decode_attention")(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_table.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, K, G, D, n_phys, ps, P, DTYPE_CODES[dt],
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
    G, D = q.shape[2], q.shape[3]
    if G > 8 or D not in HEAD_DIMS:
        raise ValueError(f"{what}: G={G} D={D}; the kernel takes G <= 8 and "
                         f"D in {HEAD_DIMS}")


def _workspace(q, n_split: int) -> torch.Tensor:
    """f32 scratch of the split pass: (m, l) per head and the (G, D)
    partial accumulator, for every (slot, KV head, span)."""
    B, K, G, D = q.shape
    return torch.empty((B * K * n_split * G * (2 + D),), dtype=torch.float32,
                       device=q.device)


def paged_decode_attention(q, k_pool, v_pool, block_table, valid_len):
    """q: (B, K, G, D); pools (n_phys, ps, K, D); block_table (B, P) int32,
    entries clamped into the pool; valid_len (B,) int32 per-slot lengths
    over the slot's logical P * ps positions (a scalar on the CPU).

    Returns (B, K, G, D) in q.dtype; zeros for a slot with valid_len 0.
    """
    if not q.is_cuda:
        return paged_decode_attention_ref(q, k_pool, v_pool, block_table,
                                          valid_len)
    B, K, G, D = q.shape
    n_phys, ps = k_pool.shape[:2]
    P = block_table.shape[1]
    if (k_pool.shape != (n_phys, ps, K, D) or v_pool.shape != k_pool.shape
            or block_table.shape != (B, P)
            or tuple(valid_len.shape) != (B,)):
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)} pool "
            f"{tuple(k_pool.shape)} bt {tuple(block_table.shape)} valid_len "
            f"{tuple(valid_len.shape)}")
    if block_table.dtype != torch.int32 or valid_len.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_table and valid_len "
                        "must be int32")
    _check_common("paged_decode_attention", q, (k_pool, v_pool))
    if any(t.device != q.device for t in (block_table, valid_len)) or \
            not (block_table.is_contiguous() and valid_len.is_contiguous()):
        raise ValueError("paged_decode_attention: block_table and valid_len "
                         "must be contiguous on q's device")
    n_split = -(-(P * ps) // SPLIT_ROWS)
    ws = _workspace(q, n_split)
    out = torch.empty_like(q)
    rc = build.kernel_fn("paged_decode_attention")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), valid_len.data_ptr(), ws.data_ptr(),
        out.data_ptr(), B, K, G, D, n_phys, ps, P, n_split, SPLIT_ROWS,
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("paged_decode_attention", rc)
    return out


def decode_attention_plain(q, k, v, valid_len=None) -> torch.Tensor:
    """The plain version in the model layout: k/v (B, T, K, D)."""
    return decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                valid_len)


def decode_attention(q, k, v, valid_len=None) -> torch.Tensor:
    """q: (B, K, G, D); k/v: (B, T, K, D), the model layout; valid_len an
    int <= T shared by every slot (default T).

    Returns (B, K, G, D) in q.dtype; zeros when valid_len is 0.
    """
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, valid_len)
    B, K, G, D = q.shape
    T = k.shape[1]
    if k.shape != (B, T, K, D) or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    _check_common("decode_attention", q, (k, v))
    vlen = T if valid_len is None else int(valid_len)
    if not 0 <= vlen <= T:
        raise ValueError(f"decode_attention: valid_len {vlen} outside "
                         f"[0, {T}]")
    n_split = max(1, -(-vlen // SPLIT_ROWS))
    ws = _workspace(q, n_split)
    out = torch.empty_like(q)
    rc = build.kernel_fn("decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ws.data_ptr(),
        out.data_ptr(), B, T, K, G, D, vlen, n_split, SPLIT_ROWS,
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("decode_attention", rc)
    return out
