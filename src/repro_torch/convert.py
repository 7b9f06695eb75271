"""Carry weights from the JAX package's parameter tree into the port.

The input is a nested dict whose leaves are arrays (anything ``np.asarray``
accepts, such as JAX arrays) or quantized weights. A quantized weight is
read by duck typing — any object with ``.w_q`` and ``.scales`` — so no
``repro`` class is imported. Quantized projections are laid out once, here,
in the int8 GEMM's 2-D ``(Kd, N)`` form (``models.quantize``); the JAX
package flattens them inside every ``qeinsum`` call instead.

bf16 leaves arrive as numpy's ``bfloat16`` extension type, which
``torch.from_numpy`` does not take: they are widened to f32 on the host and
narrowed back to bf16 on the device, which is exact.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.quantize import STACKED_AXES, flatten_quantized


def to_tensor(a: Any, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree: Any, device="cuda") -> Any:
    """JAX param tree (nested dicts) -> the port's tree on ``device``."""
    dev = resolve_device(device)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if hasattr(node, "w_q") and hasattr(node, "scales"):
            if name not in STACKED_AXES:
                raise ValueError(f"quantized leaf {name!r} has no known "
                                 "contraction axes")
            return flatten_quantized(to_tensor(node.w_q, dev),
                                     to_tensor(node.scales, dev),
                                     STACKED_AXES[name])
        return to_tensor(node, dev)

    return walk(tree)
