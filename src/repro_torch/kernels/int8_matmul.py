"""Weight-only int8 GEMM: wrapper of ``csrc/int8_matmul.cu``.

Replaces ``repro/kernels/int8_matmul.py::int8_matmul`` (the Pallas TPU
kernel ``_int8_mm_kernel``): ``(x @ w_q) * scales`` with an f32
accumulator, the scale applied once in the epilogue, and f32 output (the
dtype ``qeinsum``'s kernel path returns). x is read in its own dtype, bf16
or f32; w_q keeps the JAX package's row-major (Kd, N) layout.

The source has two bodies, picked by ``int8_body`` from M and the dtype,
one launch per call either way, both on the tensor cores (bf16 products
of the exactly widened int8 weights, f32 x split exactly into three bf16
terms, f32 sums):

- ``"gemv"`` at M <= 16 (decode) is bound by the weight bytes it streams:
  a producer warp keeps TMA-loaded 16 KB weight tiles in flight, and K
  is split over the blocks of a thread-block cluster, whose partial sums
  are added in a fixed order through distributed shared memory (no
  workspace, no second launch);
- ``"mma"`` above (prefill) is bound by operations: ``wgmma`` over
  128 x 128 output tiles fed by TMA, with each k tile's int8 weights
  widened to bf16 in shared memory while the tensor cores run the last.

Any other dtype raises; no call falls back from one body to the other.
See the source's note for the design.

On a CPU tensor the wrapper computes the plain version
(``ref.int8_matmul_ref`` on f32 x); on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels.ref import int8_matmul_ref

GEMV_MAX_M = 16   # the largest M that the gemv body takes


def int8_body(M: int, dtype: torch.dtype) -> str:
    """The kernel body that takes an (M, Kd) x of ``dtype``: ``"gemv"`` for
    M <= 16, ``"mma"`` (tensor cores) above. Raises for any dtype but bf16
    and f32 and for M < 1."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"int8_matmul: x dtype {dtype}; want bfloat16 or "
                        "float32")
    if M < 1:
        raise ValueError(f"int8_matmul: M = {M}")
    return "gemv" if M <= GEMV_MAX_M else "mma"


def int8_plan(M: int, N: int, Kd: int, dtype: torch.dtype) -> dict:
    """The launch the CUDA source makes for this product: its body, the
    column tile, the cluster size and the dynamic shared memory per block."""
    body = int8_body(M, dtype)
    plan = (ctypes.c_int * 4)()
    rc = build.helper_fn("int8_matmul_plan")(M, N, Kd, DTYPE_CODES[dtype],
                                             plan)
    if rc != 0:
        raise RuntimeError(f"int8_matmul_plan failed with CUDA error {rc}")
    return dict(body=body, block_n=plan[1], cluster=plan[2],
                smem_bytes=plan[3])


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
    int8_body(M, x.dtype)
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"int8_matmul: dtypes {x.dtype}/{w_q.dtype}/"
                        f"{scales.dtype}; want bf16|f32, int8, f32")
    if w_q.device != x.device or scales.device != x.device:
        raise ValueError("int8_matmul: mixed devices")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("int8_matmul: inputs must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = build.kernel_fn("int8_matmul")(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(), M,
        N, Kd, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("int8_matmul", rc)
    return out
