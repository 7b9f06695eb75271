"""Fused paged decode (KV write + attend): wrapper of ``csrc/fused_paged_decode.cu``.

Replaces ``repro/kernels/decode_attention.py::fused_paged_decode_attention``
(the Pallas TPU kernel ``_fused_paged_decode_kernel``). It is bound by the
bytes of each slot's live KV pages; the source's note says what its design
does about that and states the pool contract it relies on (a trash page at
``n_phys - 1`` equal to the block table's sentinel; written pages private to
their slot).

The attend-only ``paged_decode_attention`` and the contiguous
``decode_attention`` kernels of that module are not ported yet.

On a CPU tensor the wrapper computes the plain version
(``ref.fused_paged_decode_attention_ref``); on a CUDA tensor it launches the
kernel or raises. Either way the pools are updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels.ref import fused_paged_decode_attention_ref


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
