"""Causal GQA flash attention for prefill: wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
TPU kernel ``_flash_kernel``). The CUDA kernel reads the model layout
``q (B, S, K, G, D)``, ``k/v (B, T, K, D)`` through its strides, so this
wrapper takes that layout directly (the Pallas adapter transposes to
``(B, H, S, D)`` first).

The source has two bodies, picked by ``flash_body`` from the dtype and the
head dim: bf16 at D in {64, 96, 128} runs on the tensor cores (wgmma fed
by TMA, probabilities split into two bf16 halves for the PV product; D 96
as two 64-column boxes, the columns past 96 zero-filled by TMA); f32 runs
the SIMT body at D in {16, 32, 64, 96, 128}. Any other pair raises; no
call falls back from one body to the other. The query heads per KV head
take any count. See the source's note for what bounds each.

On a CPU tensor the wrapper computes the plain version
(``ref.flash_attention_ref``); on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128)
# (body, head dims) of the CUDA source for each dtype
BODIES = {torch.bfloat16: ("wgmma", (64, 96, 128)),
          torch.float32: ("simt", HEAD_DIMS)}


def flash_body(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel body that takes ``dtype`` at ``head_dim``: ``"wgmma"``
    (tensor cores, bf16) or ``"simt"`` (f32). Raises for any other pair."""
    if dtype not in BODIES:
        raise TypeError(f"flash_attention: dtype {dtype}; want float32 or "
                        "bfloat16")
    body, dims = BODIES[dtype]
    if head_dim not in dims:
        raise ValueError(f"flash_attention: the {body} body takes {dtype} "
                         f"at head_dim {dims}, not {head_dim}")
    return body


def flash_attention_plain(q, k, v, *, causal=True, q_offset=0,
                          valid_len: Optional[int] = None) -> torch.Tensor:
    """The plain version in the model layout: q (B, S, K, G, D)."""
    B, S, K, G, D = q.shape
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, D)
    out = flash_attention_ref(qh, k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, q_offset=q_offset,
                              kv_valid_len=valid_len)
    return out.reshape(B, K, G, S, D).permute(0, 3, 1, 2, 4)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    valid_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, K, G, D); k/v: (B, T, K, D). Returns (B, S, K, G, D) in q.dtype.

    Key ``t`` is live for query row ``s`` iff ``t < valid_len`` and, when
    ``causal``, ``t <= s + q_offset``.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, valid_len=valid_len)
    B, S, K, G, D = q.shape
    T = k.shape[1]
    if k.shape != (B, T, K, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; want all float32 or all bfloat16")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    body = flash_body(q.dtype, D)
    if body == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: TMA needs 16-byte-aligned q, k, v")
    vlen = T if valid_len is None else min(int(valid_len), T)
    if vlen < 1 or int(q_offset) < 0:
        raise ValueError(f"flash_attention: valid_len {vlen} q_offset "
                         f"{q_offset}")
    out = torch.empty_like(q)
    rc = build.kernel_fn("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, K,
        G, D, int(q_offset), vlen, int(bool(causal)), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("flash_attention", rc)
    return out
