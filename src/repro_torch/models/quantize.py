"""Weight-only int8 quantization of the projection matmuls
(``repro.models.quantize``).

A quantized projection is a ``QuantizedWeight``: the int8 weight flattened
once, at quantization or load time, to the GEMM kernel's 2-D ``(Kd, N)``
layout (contracted dims first), its per-output-channel f32 scales ``(N,)``,
and the shape of the output dims. The JAX package keeps the original shape
and flattens inside every ``qeinsum`` call; the numbers are the same.

Two execution paths, selected by the config's ``quantize`` mode:

``int8`` (plain)
    ``(x.float() @ w_q.float()) * scales`` — accumulate, then scale, the
    order of the JAX XLA path and of the kernel.
``int8_cuda``
    the hand-written GEMM ``kernels.int8_matmul``, x read in its own dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.ops import require_no_grad


class QuantizedWeight(NamedTuple):
    """Int8 weight as ``(Kd, N)`` (or ``(L, Kd, N)`` stacked) + scales."""

    w_q: torch.Tensor            # int8 (..., Kd, N)
    scales: torch.Tensor         # float32 (..., N)
    out_dims: Tuple[int, ...]    # the output dims that N flattens

    def layer(self, i: int) -> "QuantizedWeight":
        return QuantizedWeight(self.w_q[i], self.scales[i], self.out_dims)


# Contraction axes per stacked (leading n_layers axis) projection weight:
# wq (n,d,k,g,h) contracts d; wo (n,k,g,h,d) contracts k,g,h; MLP mats
# contract their input dim.
STACKED_AXES = {
    "wq": (1,), "wk": (1,), "wv": (1,),
    "wo": (1, 2, 3),
    "w_gate": (1,), "w_up": (1,),
    "w_down": (1,),
}


def flatten_quantized(w_q: torch.Tensor, scales: torch.Tensor,
                      axes: Tuple[int, ...]) -> QuantizedWeight:
    """Lay a stacked int8 weight out as ``(L, Kd, N)`` (contracted axes
    first), its scales (the non-contracted dims) as ``(L, N)``."""
    out_axes = tuple(i for i in range(1, w_q.ndim) if i not in axes)
    kd = 1
    for i in axes:
        kd *= w_q.shape[i]
    out_dims = tuple(w_q.shape[i] for i in out_axes)
    n = 1
    for s in out_dims:
        n *= s
    L = w_q.shape[0]
    w2 = w_q.permute((0,) + tuple(axes) + out_axes).reshape(L, kd, n)
    return QuantizedWeight(w2.contiguous(),
                           scales.reshape(L, n).float().contiguous(),
                           out_dims)


def quantize_weight(w: torch.Tensor, axes: Tuple[int, ...]) -> QuantizedWeight:
    """Symmetric per-output-channel int8 quantization of a stacked weight.

    ``axes`` are the contraction axes; one scale per remaining output
    channel, absmax / 127 with a 1.0 floor on all-zero channels, exactly as
    ``repro.models.quantize.quantize_weight`` rounds. The channels never
    span the leading (layer) axis, so the weight is quantized one layer at
    a time: the f32 working copies are one layer's, not the stack's (yi-9b's
    stacked ``w_gate`` is 8.7 GB in f32).
    """
    w_q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scales = torch.empty(tuple(1 if i in axes else n
                               for i, n in enumerate(w.shape)),
                         dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        wf = w[i:i + 1].float()
        absmax = wf.abs().amax(dim=axes, keepdim=True)
        sc = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        w_q[i:i + 1] = torch.clamp(torch.round(wf / sc), -127, 127)
        scales[i:i + 1] = sc
    return flatten_quantized(w_q, scales.squeeze(axes), axes)


def quantize_params_dense(params) -> dict:
    """Quantize the seven stacked projection weights of a dense param tree.

    Embedding, norms and the LM head stay in the working dtype. Returns a
    new tree; the input is not mutated.
    """
    out = dict(params)
    layers = dict(params["layers"])
    attn = dict(layers["attn"])
    mlp = dict(layers["mlp"])
    for name in ("wq", "wk", "wv", "wo"):
        attn[name] = quantize_weight(attn[name], STACKED_AXES[name])
    for name in ("w_gate", "w_up", "w_down"):
        mlp[name] = quantize_weight(mlp[name], STACKED_AXES[name])
    layers["attn"] = attn
    layers["mlp"] = mlp
    out["layers"] = layers
    return out


def qimpl_for(quantize_mode: str) -> str:
    """Map a config ``quantize`` mode to a ``qeinsum`` impl name."""
    return {"none": "torch", "int8": "torch", "int8_cuda": "cuda"}[quantize_mode]


def qeinsum(x: torch.Tensor, qw: QuantizedWeight, n_contract: int,
            impl: str = "torch") -> torch.Tensor:
    """``x``'s trailing ``n_contract`` dims times the dequantized weight.

    Returns ``x.shape[:-n_contract] + qw.out_dims`` in f32.
    """
    batch = x.shape[:x.ndim - n_contract]
    x2 = x.reshape(-1, qw.w_q.shape[0])
    if impl == "cuda":
        require_no_grad("qeinsum impl 'cuda' (quantize 'int8_cuda')", x)
        if not x.is_cuda:
            raise ValueError("qeinsum: the CUDA int8 impl was asked for a "
                             f"tensor on {x.device}; use quantize='int8'")
        o = int8_matmul(x2.contiguous(), qw.w_q, qw.scales)
    elif impl == "torch":
        o = (x2.float() @ qw.w_q.float()) * qw.scales
    else:
        raise ValueError(f"unknown qeinsum impl {impl!r}")
    return o.reshape(tuple(batch) + tuple(qw.out_dims))
