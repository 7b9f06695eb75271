"""The benchmark's cost functions, hand-checked on small shapes, and one
case each against ``chip_smoke.py``'s bound arithmetic."""
import importlib.util

import bench_tiny
import pytest
import torch

from bench import costs

torch.set_num_threads(1)


def test_flash_hand_worked():
    # S 4 causal: 10 live pairs; H 2, K 1, D 8
    flops, nbytes = costs.flash(4, 2, 1, 8)
    assert flops == 4 * 2 * 8 * 10
    assert nbytes == 2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8)


def test_decode_attn_hand_worked():
    # context 5: 4 cached rows read, one written; H 2, K 1, D 8
    flops, nbytes = costs.decode_attn(5, 2, 1, 8)
    assert flops == 4 * 2 * 8 * 5
    assert nbytes == 2 * (2 * 4 * 8 + 2 * 2 * 8 + 2 * 2 * 8)


def test_int8_gemm_hand_worked():
    flops, nbytes = costs.int8_gemm(3, 4, 5)
    assert flops == 2 * 3 * 4 * 5
    assert nbytes == 2 * 3 * 4 + 4 * 5 + 4 * 5 + 4 * 3 * 5


def test_whole_step_hand_worked():
    cfg = dict(bench_tiny.TINY)
    # one layer's projections: q 64x64, k and v 64x32, o 64x64, gate and
    # up 64x128, down 128x64
    per_layer = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128
    assert costs.layer_matmul_params(cfg) == per_layer
    att, _ = costs.flash(10, 4, 2, 16)
    assert costs.prefill_flops(cfg, 10) == pytest.approx(
        2 * (2 * per_layer * 10 + att) + 2 * 256 * 64)
    att, _ = costs.decode_attn(11, 4, 2, 16)
    assert costs.decode_flops(cfg, 11) == pytest.approx(
        2 * (2 * per_layer + att) + 2 * 256 * 64)
    f0, b0 = costs.int8_step(cfg, 0)
    f3, b3 = costs.int8_step(cfg, 3)
    assert f0 == 0 and f3 == pytest.approx(2 * 3 * 2 * per_layer)
    assert b0 == pytest.approx(2 * (per_layer + 4 * (64 + 32 + 32 + 64 + 128
                                                     + 128 + 64)))


def test_roofline_takes_the_larger_bound():
    assert costs.roofline_s(989e12, 0.0) == (1.0, "operations")
    assert costs.roofline_s(0.0, 3.35e12) == (1.0, "bytes")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_costs", bench_tiny.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flash_and_int8_agree_with_chip_smoke_bound():
    cs = _chip_smoke()
    # phi3-mini's flash shape of chip_smoke's phase 2, one sequence:
    # S = T = 256, K 32, G 1, D 96, causal
    S, K, G, D = 256, 32, 1, 96
    flops, nbytes = costs.flash(S, K * G, K, D)
    pairs = S * (S + 1) // 2
    n_bytes = 2 * (2 * S * K * G * D + 2 * S * K * D)
    assert (flops, nbytes) == (4 * K * G * D * pairs, n_bytes)
    want_ms, want_by = cs.bound(n_bytes, 4 * K * G * D * pairs,
                                cs.BF16_FLOPS)
    t, by = costs.roofline_s(flops, nbytes)
    assert (t * 1e3, by) == (pytest.approx(want_ms, rel=1e-12), want_by)
    # int8 at M 2048 over phi3-mini's 3072 x 8192 projection
    M, Kd, N = 2048, 3072, 8192
    flops, nbytes = costs.int8_gemm(M, Kd, N)
    want_ms, want_by = cs.bound(2 * M * Kd + Kd * N + 4 * N + 4 * M * N,
                                2 * M * N * Kd, cs.BF16_FLOPS)
    t, by = costs.roofline_s(flops, nbytes)
    assert (t * 1e3, by) == (pytest.approx(want_ms, rel=1e-12), want_by)
