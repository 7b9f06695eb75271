"""Model-layout entry to the attention kernels, with device dispatch.

The counterpart of ``repro.kernels.ops``. ``flash_attention_grouped`` takes
the model layout (q ``(B, S, K, G, D)``, k/v ``(B, T, K, D)``), which the
CUDA kernels read through their strides, so no transpose is made on the
way in or out. As in ``repro.kernels.ops``, a one-token query (S == 1)
goes to the decode kernel, which ignores ``causal`` and ``q_offset``.
``impl`` is the config's ``attention_impl``: ``"cuda"`` launches the
kernel and refuses a CPU tensor; ``"torch"`` runs the plain version on
whatever device the tensors are on.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_plain, fused_paged_decode_attention,
    paged_decode_attention)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)


def require_cuda(t: torch.Tensor, what: str) -> None:
    """A kernel impl on a CPU tensor is a caller error, never a fallback."""
    if not t.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel impl was asked for a "
                         f"tensor on {t.device}; use the plain impl on CPU")


def require_no_grad(what: str, *tensors: torch.Tensor) -> None:
    """A kernel impl asked for a gradient raises. The wrappers launch
    through raw pointers into fresh outputs, so autograd would record no
    edge through the kernel and the gradient would be silently wrong;
    training runs the plain impls. Serving runs under ``no_grad`` or
    ``inference_mode``, where this never fires."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: an input requires grad with grad "
            "mode on; train on the plain impls (attention_impl 'torch' or "
            "'torch_chunked', quantize 'none' or 'int8')")


def flash_attention_grouped(q, k, v, *, causal=True, q_offset=0,
                            kv_valid_len=None, impl="cuda"):
    """q: (B, S, K, G, D); k/v: (B, T, K, D). Returns (B, S, K, G, D)."""
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "cuda":
        require_cuda(q, "flash_attention_grouped")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.shape[1] == 1:
        decode = decode_attention if impl == "cuda" else decode_attention_plain
        return decode(q[:, 0], k, v, kv_valid_len)[:, None]
    flash = flash_attention if impl == "cuda" else flash_attention_plain
    return flash(q, k, v, causal=causal, q_offset=q_offset,
                 valid_len=kv_valid_len)


__all__ = ["fused_paged_decode_attention", "paged_decode_attention",
           "flash_attention_grouped", "require_cuda", "require_no_grad"]
