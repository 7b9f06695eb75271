"""PyTorch/CUDA port of the INFaaS reproduction (``repro``).

The package mirrors ``repro``'s layout module for module. It imports
``torch`` and never ``jax`` or ``repro``: where it needs something from a
pure-Python ``repro`` module it keeps its own copy. Every TPU kernel of the
ported path has a hand-written Hopper kernel under ``csrc/`` with a plain
PyTorch version beside its wrapper (``repro_torch.kernels``).

Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
CUDA is absent unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Validate an entry point's ``device`` argument.

    Never falls back: asking for CUDA on a machine without it raises.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
