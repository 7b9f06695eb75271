"""What the work needs: operations and bytes of each kernel call and of a
whole decode or prefill, from the real lengths, and the chip's peaks.

Every count is of what the inputs need (each input byte read once, each
output byte written once, attention over the valid positions only), never
of the padded shapes a program happens to run. The peaks are NVIDIA's data
sheet for the H100 SXM at its 700 W limit, dense rates; the int8 GEMM's
product is bf16 (its weights are widened), so its peak is bf16's too.
"""
from __future__ import annotations

from typing import Tuple

BF16_FLOPS = 989e12          # dense bf16 tensor-core operations a second
HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth
BF16 = 2                     # bytes of a bf16 element
F32 = 4


def roofline_s(flops: float, nbytes: float,
               peak_flops: float = BF16_FLOPS) -> Tuple[float, str]:
    """The least time the chip could take, and which bound sets it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash(S: int, H: int, K: int, D: int) -> Tuple[float, float]:
    """One causal prefill attention over S valid positions: H query heads
    on K KV heads of size D. (operations, bytes): q, k, v read, o written;
    two products over the S (S + 1) / 2 live (query, key) pairs."""
    pairs = S * (S + 1) / 2
    return 4.0 * H * D * pairs, BF16 * (2 * S * H * D + 2 * S * K * D)


def decode_attn(ctx: int, H: int, K: int, D: int) -> Tuple[float, float]:
    """One decode step of one row: write the new k/v at position ``ctx - 1``
    and attend over ``ctx`` positions. Reads the ``ctx - 1`` cached k/v
    rows, q and the new k/v; writes o and the new k/v rows."""
    flops = 4.0 * H * D * ctx
    nbytes = BF16 * (2 * (ctx - 1) * K * D       # cached k/v read
                     + 2 * H * D                 # q in, o out
                     + 2 * 2 * K * D)            # new k/v in, written
    return flops, nbytes


def int8_gemm(M: int, Kd: int, N: int) -> Tuple[float, float]:
    """x (M, Kd) in bf16 times an int8 (Kd, N) weight with f32 scales (N,)
    into an f32 (M, N): the weight and scales read once."""
    return 2.0 * M * Kd * N, BF16 * M * Kd + Kd * N + F32 * N + F32 * M * N


def projections(cfg: dict):
    """(Kd, N) of each projection GEMM of one layer, in call order."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    K, D = cfg["num_key_value_heads"], cfg["head_dim"]
    H = cfg["num_attention_heads"]
    return [(d, H * D), (d, K * D), (d, K * D), (H * D, d),
            (d, f), (d, f), (f, d)]


def layer_matmul_params(cfg: dict) -> int:
    return sum(kd * n for kd, n in projections(cfg))


def prefill_flops(cfg: dict, S: int) -> float:
    """A whole prefill of one S-token prompt: every layer's projections
    and causal attention, and the head at the last position."""
    L, H = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    att, _ = flash(S, H, cfg["num_key_value_heads"], cfg["head_dim"])
    head = 2.0 * cfg["vocab_size"] * cfg["hidden_size"]
    return L * (2.0 * layer_matmul_params(cfg) * S + att) + head


def decode_flops(cfg: dict, ctx: int) -> float:
    """One decode step of one row at context ``ctx`` (positions attended),
    every layer and the head."""
    L, H = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    att, _ = decode_attn(ctx, H, cfg["num_key_value_heads"], cfg["head_dim"])
    head = 2.0 * cfg["vocab_size"] * cfg["hidden_size"]
    return L * (2.0 * layer_matmul_params(cfg) + att) + head


def int8_step(cfg: dict, rows: int) -> Tuple[float, float]:
    """Every int8 projection of a dispatch over ``rows`` live rows (one
    decode step's rows, or a prefill's valid tokens): each weight read
    once, x and y at the live rows."""
    flops = nbytes = 0.0
    for kd, n in projections(cfg):
        f, b = int8_gemm(rows, kd, n)
        flops += f
        nbytes += b
    L = cfg["num_hidden_layers"]
    return L * flops, L * nbytes
