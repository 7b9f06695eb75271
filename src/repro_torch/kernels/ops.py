"""Model-layout entry to the attention kernels, with device dispatch.

The counterpart of ``repro.kernels.ops``. ``flash_attention_grouped`` takes
the model layout (q ``(B, S, K, G, D)``, k/v ``(B, T, K, D)``), which the
CUDA kernel reads through its strides, so no transpose is made on the way
in or out. ``impl`` is the config's ``attention_impl``: ``"cuda"`` launches
the kernel and refuses a CPU tensor; ``"torch"`` runs the plain version on
whatever device the tensors are on.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import fused_paged_decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)


def require_cuda(t: torch.Tensor, what: str) -> None:
    """A kernel impl on a CPU tensor is a caller error, never a fallback."""
    if not t.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel impl was asked for a "
                         f"tensor on {t.device}; use the plain impl on CPU")


def flash_attention_grouped(q, k, v, *, causal=True, q_offset=0,
                            kv_valid_len=None, impl="cuda"):
    """q: (B, S, K, G, D); k/v: (B, T, K, D). Returns (B, S, K, G, D)."""
    if impl == "cuda":
        require_cuda(q, "flash_attention_grouped")
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, q_offset=q_offset,
                               valid_len=kv_valid_len)
    if impl != "torch":
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                 valid_len=kv_valid_len)


__all__ = ["fused_paged_decode_attention", "flash_attention_grouped",
           "require_cuda"]
