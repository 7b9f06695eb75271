"""Weight-only int8 GEMM: wrapper of ``csrc/int8_matmul.cu``.

Replaces ``repro/kernels/int8_matmul.py::int8_matmul`` (the Pallas TPU
kernel ``_int8_mm_kernel``). At decode (M = batch slots) it is bound by the
weight bytes it streams; the source's note says what its design does about
that.

``(x @ w_q) * scales`` with an f32 accumulator and f32 output (the dtype
``qeinsum``'s kernel path returns). At small M the library's
``int8_matmul_splits`` splits the reduction over Kd, and the wrapper gives
the kernel the f32 workspace it asks for; a second kernel adds the partial
sums in a fixed order. x is read in its own dtype, bf16 or f32. On a CPU
tensor the wrapper computes the plain version (``ref.int8_matmul_ref`` on
f32 x); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels.ref import int8_matmul_ref


def int8_splits(M: int, N: int, Kd: int, device: torch.device) -> int:
    """How many ways the kernel splits Kd for this product on ``device``
    (the policy and the tile it depends on live in the CUDA source)."""
    splits = ctypes.c_int(0)
    rc = build.helper_fn("int8_matmul_splits")(
        M, N, Kd, device.index, ctypes.byref(splits))
    if rc != 0:
        raise RuntimeError(f"int8_matmul_splits failed with CUDA error {rc}")
    return splits.value


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """x: (M, Kd) bf16/f32; w_q: (Kd, N) int8; scales: (N,) f32 -> (M, N) f32."""
    if not x.is_cuda:
        return int8_matmul_ref(x.float(), w_q, scales)
    M, Kd = x.shape
    N = w_q.shape[1]
    if w_q.shape != (Kd, N) or scales.shape != (N,):
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} w_q "
                         f"{tuple(w_q.shape)} scales {tuple(scales.shape)}")
    if x.dtype not in DTYPE_CODES or w_q.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise TypeError(f"int8_matmul: dtypes {x.dtype}/{w_q.dtype}/"
                        f"{scales.dtype}; want bf16|f32, int8, f32")
    if w_q.device != x.device or scales.device != x.device:
        raise ValueError("int8_matmul: mixed devices")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("int8_matmul: inputs must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    splits = int8_splits(M, N, Kd, x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    rc = build.kernel_fn("int8_matmul")(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), M, N, Kd, splits,
        DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("int8_matmul", rc)
    return out
