#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:

1. **Build** every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together) and print each kernel's ``-Xptxas -v``
   registers, shared memory and spills.
2. **Per-kernel**: each kernel against its plain PyTorch version on the
   card, in bf16, at the main path's full-width shapes plus edge cases
   (ragged S, valid_len < T, q_offset > 0; an all-sentinel slot, pos on a
   page boundary, pos = 0; M in {1, 8, 8 x bucket} and N not a multiple of
   the tile). Each attention kernel is held twice: to the plain version on
   the bf16 inputs, and, tightly, to the plain version on the same inputs
   widened to f32 (probabilities in f32, as the kernels and the Pallas
   bodies keep them): within one bf16 ulp of each element plus 1e-5. The
   fused decode kernel's written rows must be bit-equal to
   the new rows and every other page row, trash page aside, bitwise
   untouched. Each kernel is timed with CUDA events after warmup beside its
   bound, its plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``; the port never calls it).
3. **Main path**: full-width llama3.2-1b (16 layers, d_model 2048, 32/8
   heads, vocab 128256, random weights from a seed) serves a seeded
   16-request stream through ``ServingEngine.serve`` as the bf16 variant
   and then as the int8 variant, with every kernel launch counted. Each
   variant serves the stream ``SERVE_REPEATS`` times on one warm engine;
   tokens/s is the median, with its quartiles as the spread.
4. **Teacher-forced check**: the same model in f32, one seeded token stream
   forced through prefill and decode with the kernel impls and with the
   plain impls; the logits must agree at every prefill and decode position.

The last lines are the card's ``name, power.limit``, one JSON line with
every kernel's numbers, and the result line
``{"ok": true, "device": {...}}``. TF32 is off for every f32 product.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet, dense), at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

SEED = 0
# Timed serves of the stream per variant. The serve is host-bound and the
# host's cores are shared, so one serve's tok/s varies by tens of percent
# while its device time does not; the median of many serves is reported.
SERVE_REPEATS = 15


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_f32_ulps(torch, got, want32, what: str) -> float:
    """Hold a bf16 kernel result to the plain version run in f32 on the same
    (widened) inputs: every element within one bf16 ulp of the reference
    (rounding the f32 result to bf16 costs at most half of one) plus 1e-5
    for f32 sums taken in another order. Returns the worst ratio of error
    to that limit."""
    ref = want32.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -60)))
                     - 7)
    ratio = ((got.float() - ref).abs() / (ulp + 1e-5)).max().item()
    print(f"  {what} vs f32 plain: worst error / (1 bf16 ulp + 1e-5) "
          f"{ratio:.3f} (limit 1)")
    check(ratio <= 1.0, f"{what}: {ratio} of the f32 limit")
    return ratio


def bound(n_bytes: float, n_flops: float, peak_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: per-kernel comparisons and timings


def phase_flash(torch, dev, gen, K=8, G=4, D=64):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    tol = 3e-2   # bf16: the plain version rounds probabilities to bf16
    cases = [  # (label, B, S, T, q_offset, valid_len)
        ("B=8 bucket 256", 8, 256, 256, 0, None),
        ("B=1 bucket 512", 1, 512, 512, 0, None),
        ("ragged S=300", 1, 300, 300, 0, None),
        ("valid_len 100 < T 128", 2, 128, 128, 0, 100),
        ("q_offset 448 > 0", 1, 64, 512, 448, None),
    ]
    worst = 0.0
    for label, B, S, T, q_off, vlen in cases:
        q = torch.randn((B, S, K, G, D), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
        got = flash_attention(q, k, v, causal=True, q_offset=q_off,
                              valid_len=vlen)
        want = flash_attention_plain(q, k, v, causal=True, q_offset=q_off,
                                     valid_len=vlen)
        want32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                       causal=True, q_offset=q_off,
                                       valid_len=vlen)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"  flash_attention [{label}]: max_abs_err {err:.3e} "
              f"(tol {tol})")
        check(err <= tol, f"flash_attention {label}: err {err}")
        check_f32_ulps(torch, got, want32, f"flash_attention [{label}]")
        worst = max(worst, err)
    # time at the main path's grouped-prefill shape
    B, S = 8, 256
    H = K * G
    q = torch.randn((B, S, K, G, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, K, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, K, D), generator=gen, device=dev).bfloat16()
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True))
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, H, S, D).contiguous()
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                  enable_gqa=True))
    pairs = S * (S + 1) // 2                    # live (query, key) pairs
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    n_flops = 4 * B * H * D * pairs
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)
    print(f"  flash_attention B={B} S=T={S} H={H} K={K} D={D} bf16: "
          f"{ms:.4f} ms (plain {plain_ms:.4f}, SDPA {lib_ms:.4f}, bound "
          f"{b_ms:.4f} by {b_by})")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:106",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def phase_fused_decode(torch, dev, gen, B=8, K=8, G=4, D=64, ps=16, P=32):
    from repro_torch.kernels.decode_attention import \
        fused_paged_decode_attention
    from repro_torch.kernels.ref import fused_paged_decode_attention_ref
    tol = 3e-2   # bf16: the plain version rounds probabilities to bf16
    n_pages = B * P
    n_phys = n_pages + 1                        # trash page == sentinel
    sent = n_pages
    perm = torch.randperm(n_pages, generator=gen, device=dev).reshape(B, P)
    # slot 0 at pos 0, slot 1 on a page boundary (first row of a new
    # page), slot 2 on a page's last row, slot 4 at max_len - 1, slot 7
    # inactive with an all-sentinel row
    pos = torch.tensor([0, 16, 15, 300, 511, 47, 203, 100],
                       dtype=torch.int32, device=dev)
    n_alloc = pos.long() // ps + 1
    bt = torch.where(torch.arange(P, device=dev)[None, :] < n_alloc[:, None],
                     perm, torch.full_like(perm, sent)).to(torch.int32)
    bt[B - 1] = sent
    live = B - 1
    kp = torch.randn((n_phys, ps, K, D), generator=gen, device=dev).bfloat16()
    vp = torch.randn((n_phys, ps, K, D), generator=gen, device=dev).bfloat16()
    q = torch.randn((B, K, G, D), generator=gen, device=dev).bfloat16()
    kn = torch.randn((B, K, D), generator=gen, device=dev).bfloat16()
    vn = torch.randn((B, K, D), generator=gen, device=dev).bfloat16()
    k0, v0 = kp.clone(), vp.clone()
    out, kp2, vp2 = fused_paged_decode_attention(q, kn, vn, kp, vp, bt, pos)
    o_ref, _, _ = fused_paged_decode_attention_ref(q, kn, vn, k0.clone(),
                                                   v0.clone(), bt, pos)
    o_32, _, _ = fused_paged_decode_attention_ref(
        q.float(), kn.float(), vn.float(), k0.float(), v0.float(), bt, pos)
    torch.cuda.synchronize()
    err = (out[:live].float() - o_ref[:live].float()).abs().max().item()
    print(f"  fused_paged_decode_attention [pos 0, page boundary, last row, "
          f"max_len-1, all-sentinel slot]: max_abs_err {err:.3e} "
          f"(tol {tol})")
    check(err <= tol, f"fused decode output err {err}")
    check_f32_ulps(torch, out[:live], o_32[:live],
                   "fused_paged_decode_attention")
    wpage = bt[torch.arange(B, device=dev), pos.long() // ps].long()
    woff = pos.long() % ps
    check(torch.equal(kp2[wpage[:live], woff[:live]], kn[:live])
          and torch.equal(vp2[wpage[:live], woff[:live]], vn[:live]),
          "fused decode: written rows are not bit-equal to the new rows")
    untouched = torch.ones((n_phys, ps), dtype=torch.bool, device=dev)
    untouched[wpage[:live], woff[:live]] = False
    untouched[sent] = False
    check(torch.equal(kp2[untouched], k0[untouched])
          and torch.equal(vp2[untouched], v0[untouched]),
          "fused decode: a page row other than the write rows changed")
    print("  fused_paged_decode_attention: written rows bit-equal, every "
          "other page row (trash aside) bitwise untouched")
    ms = cuda_ms(lambda: fused_paged_decode_attention(q, kn, vn, kp, vp, bt,
                                                      pos))
    plain_ms = cuda_ms(lambda: fused_paged_decode_attention_ref(
        q, kn, vn, kp, vp, bt, pos))
    vlen = (pos.long() + 1).cpu()
    live_rows = int(((vlen + ps - 1) // ps * ps).sum())
    n_bytes = 2 * (2 * live_rows * K * D            # live k/v page rows
                   + 2 * q.numel() + 2 * kn.numel()  # q, out, k/v rows in
                   + 2 * B * K * D) + 4 * (bt.numel() + B)  # rows out, idx
    n_flops = 4 * K * G * D * int(vlen.sum())
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)
    print(f"  fused_paged_decode_attention B={B} K={K} G={G} D={D} ps={ps} "
          f"P={P} bf16: {ms:.4f} ms (plain {plain_ms:.4f}, bound "
          f"{b_ms:.5f} by {b_by})")
    return dict(name="fused_paged_decode_attention", route="cuda",
                source="src/repro_torch/csrc/fused_paged_decode.cu",
                replaces="src/repro/kernels/decode_attention.py:328",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_int8(torch, dev, gen):
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.ref import int8_matmul_ref, quantize_int8
    # f32 accumulation in another order than the plain f32 product
    rtol = atol = 2e-3
    shapes = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
    cases = [(m, kd, n) for kd, n in shapes for m in (1, 8, 8 * 256)]
    cases += [(5, 2048, 1000), (77, 300, 130)]    # N not a tile multiple
    worst = 0.0
    timed = {}
    for M, Kd, N in cases:
        x = torch.randn((M, Kd), generator=gen, device=dev).bfloat16()
        w = torch.randn((Kd, N), generator=gen, device=dev) / Kd ** 0.5
        w_q, s = quantize_int8(w)
        got = int8_matmul(x, w_q, s)
        want = int8_matmul_ref(x.float(), w_q, s)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        lim = atol + rtol * want.abs().max().item()
        check(got.dtype == torch.float32, "int8_matmul output dtype")
        check(err <= lim, f"int8_matmul M={M} K={Kd} N={N}: err {err}")
        worst = max(worst, err)
        if (Kd, N) in shapes and M in (8, 8 * 256):
            w_deq = (w_q.float() * s).bfloat16()
            ms = cuda_ms(lambda: int8_matmul(x, w_q, s))
            plain_ms = cuda_ms(lambda: int8_matmul_ref(x.float(), w_q, s))
            lib_ms = cuda_ms(lambda: torch.mm(x, w_deq))
            n_bytes = 2 * M * Kd + Kd * N + 4 * N + 4 * M * N
            b_ms, b_by = bound(n_bytes, 2 * M * N * Kd, BF16_FLOPS)
            timed[(M, Kd, N)] = (ms, plain_ms, lib_ms, b_ms, b_by)
            print(f"  int8_matmul M={M} K={Kd} N={N}: {ms:.4f} ms (plain "
                  f"{plain_ms:.4f}, torch.mm bf16 {lib_ms:.4f}, bound "
                  f"{b_ms:.5f} by {b_by}), max_abs_err {err:.2e}")
    print(f"  int8_matmul: {len(cases)} shapes within atol {atol} + rtol "
          f"{rtol} x max|ref|, worst max_abs_err {worst:.3e}")
    ms, plain_ms, lib_ms, b_ms, b_by = timed[(8, 2048, 8192)]
    return dict(name="int8_matmul", route="cuda",
                source="src/repro_torch/csrc/int8_matmul.cu",
                replaces="src/repro/kernels/int8_matmul.py:64",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


# ---------------------------------------------------------------------------
# phase 3: the main path


def make_stream(vocab: int, n: int = 16, seed: int = 1):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(16, 301))
                          ).astype(np.int32), int(rng.integers(16, 65)))
            for _ in range(n)]


def serve_variant(torch, dev, model, params, stream, label):
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(model, params, max_batch=8, max_len=512,
                        decode_block=16, page_size=16)
    eng.warmup(prompt_lens=[len(p) for p, _ in stream])
    torch.cuda.reset_peak_memory_stats(dev)
    vocab = model.cfg.vocab
    rates, first = [], None
    build.reset_launch_counts()
    for rep in range(SERVE_REPEATS):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(stream)]
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        for r, (_p, m) in zip(reqs, stream):
            check(r.tokens is not None and len(r.tokens) == m,
                  f"{label}: request {r.rid} returned {r.tokens}")
            check(bool(((r.tokens >= 0) & (r.tokens < vocab)).all()),
                  f"{label}: request {r.rid} token out of vocab")
        toks = sum(len(r.tokens) for r in reqs)
        rates.append(toks / wall)
        if first is None:
            first = (dict(eng.stats), dict(eng.timing))
    launches = dict(build.launch_counts)
    s, timing = first
    segs = s["decode_dispatches"]
    seg_ms = timing["decode_s"] / segs * 1e3 if segs else 0.0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    q1, med, q3 = statistics.quantiles(rates, n=4)
    spread = (q3 - q1) / med
    print(f"  {label}: {len(stream)} reqs / {toks} tokens per serve, "
          f"{SERVE_REPEATS} serves: median {med:.1f} tok/s (quartiles "
          f"{q1:.1f}-{q3:.1f}, spread (q3 - q1) / median {spread:.3f}; min "
          f"{min(rates):.1f}, max {max(rates):.1f}; each "
          f"{', '.join(f'{x:.1f}' for x in rates)})")
    print(f"  {label}, first serve: {s['prefill_dispatches']} prefill + "
          f"{segs} decode dispatches, {s['decode_steps']} decode steps, "
          f"mean decode segment {seg_ms:.2f} ms, prefill "
          f"{timing['prefill_s']:.3f} s; peak memory {peak_gb:.2f} GB; "
          f"launches over all serves {launches}")
    return dict(tok_s=med, tok_s_all=rates, spread=spread, tokens=toks,
                launches=launches, stats=s, seg_ms=seg_ms, peak_gb=peak_gb)


def profile_variant(torch, dev, model, params, stream, label):
    """Where the time goes: ``torch.profiler`` over a short serve of the
    stream's first 8 requests. Prints the device's busy share (summed
    device kernel time over host wall time, profiler on) and the kernels
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(model, params, max_batch=8, max_len=512,
                        decode_block=16, page_size=16)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(stream[:8])]
    eng.warmup(prompt_lens=[len(r.prompt) for r in reqs])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + us, n + 1)
    busy_us = sum(t for t, _ in by_name.values())
    print(f"  {label} profile (8 reqs, {eng.stats['decode_steps']} decode "
          f"steps): wall {wall_us / 1e3:.1f} ms, device kernel time "
          f"{busy_us / 1e3:.1f} ms, device busy share "
          f"{busy_us / wall_us:.3f}, idle share {1 - busy_us / wall_us:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, n) in top:
        print(f"    {us / 1e3:9.2f} ms {n:6d} calls  {name[:90]}")


def phase_main_path(torch, dev):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models.quantize import quantize_params_dense
    base = ARCHS["llama3.2-1b"]
    cfg = base.for_device(dev)
    check(cfg.attention_impl == "cuda", "config did not select the kernels")
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize(dev)
    print(f"  llama3.2-1b full width: {base.param_count() / 1e9:.3f} B "
          f"params, bf16, init {time.perf_counter() - t0:.1f} s")
    stream = make_stream(cfg.vocab)
    bf16 = serve_variant(torch, dev, model, params, stream, "bf16 variant")
    profile_variant(torch, dev, model, params, stream, "bf16 variant")
    qcfg = dataclasses.replace(base, quantize="int8").for_device(dev)
    check(qcfg.quantize == "int8_cuda", "config did not select the int8 GEMM")
    qparams = quantize_params_dense(params)
    del params
    torch.cuda.empty_cache()
    qmodel = build_model(qcfg, dev)
    int8 = serve_variant(torch, dev, qmodel, qparams, stream, "int8 variant")
    profile_variant(torch, dev, qmodel, qparams, stream, "int8 variant")
    del qparams
    torch.cuda.empty_cache()
    for name in ("flash_attention", "fused_paged_decode_attention"):
        check(bf16["launches"][name] > 0 and int8["launches"][name] > 0,
              f"{name} was not launched on the main path")
    check(int8["launches"]["int8_matmul"] > 0,
          "int8_matmul was not launched on the int8 variant")
    return bf16, int8


# ---------------------------------------------------------------------------
# phase 4: teacher-forced logits, kernel impls vs plain impls, f32


def teacher_forced(torch, dev, model, params, prompts, lengths, forced,
                   ps=16, max_len=512):
    """Logits at each request's last prompt position and at every forced
    decode position, through ``model.prefill`` and ``model.decode``."""
    cfg = model.cfg
    B, S = prompts.shape
    P = max_len // ps
    n_pages = B * P
    shape = (cfg.n_layers, n_pages + 1, ps, cfg.n_kv_heads, cfg.head_dim)
    pools = {n: torch.zeros(shape, dtype=torch.float32, device=dev)
             for n in ("k", "v")}
    bt = torch.arange(n_pages, dtype=torch.int32, device=dev).reshape(B, P)
    out = []
    with torch.no_grad():
        logits, pc = model.prefill(params, {"tokens": prompts,
                                            "length": lengths})
        out.append(logits[:, -1])
        rows = -(-S // ps)
        for n in ("k", "v"):
            new = torch.nn.functional.pad(pc[n], (0, 0, 0, 0, 0, rows * ps - S))
            new = new.reshape((cfg.n_layers, B * rows, ps)
                              + tuple(new.shape[3:]))
            pools[n][:, bt[:, :rows].reshape(-1).long()] = new
        cache = dict(pools, bt=bt)
        for i in range(forced.shape[1]):
            logits, cache = model.decode(params, cache, forced[:, i:i + 1],
                                         lengths + i)
            out.append(logits[:, -1])
    return torch.stack(out)                      # (1 + n_dec, B, V)


def phase_teacher_forced(torch, dev):
    import numpy as np
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models.quantize import quantize_params_dense
    # f32 everywhere, TF32 off: kernel and plain differ only in the order
    # of f32 sums, compounded over 16 layers
    tol = 5e-3
    base = dataclasses.replace(ARCHS["llama3.2-1b"], dtype="float32",
                               param_dtype="float32")
    rng = np.random.default_rng(2)
    lens = np.array([17, 64, 100, 250], np.int32)
    S = 256
    prompts = np.zeros((len(lens), S), np.int32)
    for b, n in enumerate(lens):
        prompts[b, :n] = rng.integers(0, base.vocab, size=n)
    forced = rng.integers(0, base.vocab, size=(len(lens), 16)).astype(np.int32)
    to = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    params = build_model(base, dev).init(SEED)
    diffs = {}
    for variant in ("fp32", "int8"):
        quant = "int8" if variant == "int8" else "none"
        p = quantize_params_dense(params) if variant == "int8" else params
        plain_cfg = dataclasses.replace(base, quantize=quant)
        runs = []
        for cfg in (plain_cfg, plain_cfg.for_device(dev)):
            runs.append(teacher_forced(torch, dev, build_model(cfg, dev), p,
                                       to(prompts), to(lens), to(forced)))
        plain, kern = runs
        check(bool(torch.isfinite(kern).all()), f"{variant}: non-finite logits")
        d = (kern - plain).abs().amax(dim=(1, 2))
        diffs[variant] = d.max().item()
        print(f"  teacher-forced {variant}: {kern.shape[0]} positions x "
              f"{kern.shape[1]} requests x {kern.shape[2]} logits; max "
              f"|kernel - plain| {diffs[variant]:.3e} (prefill "
              f"{d[0].item():.3e}, decode max {d[1:].max().item():.3e}; "
              f"max |logit| {plain.abs().max().item():.3f}; tol {tol})")
        check(diffs[variant] <= tol, f"teacher-forced {variant}: "
              f"{diffs[variant]} > {tol}")
        del p, runs, plain, kern
        torch.cuda.empty_cache()
    return diffs


# ---------------------------------------------------------------------------


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"error: {SRC / 'repro_torch'} not found; run chip_smoke.py "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    from repro_torch.kernels import build
    print("phase 1: build")
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"  built {len(reports)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill")):
                print(f"  [{name}] {line.strip()}")

    print("phase 2: per-kernel comparisons (bf16, full-width shapes)")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = [phase_flash(torch, dev, gen),
               phase_fused_decode(torch, dev, gen),
               phase_int8(torch, dev, gen)]
    print("phase 3: main path (ServingEngine.serve, full width)")
    bf16, int8 = phase_main_path(torch, dev)
    for k in kernels:
        k["launches"] = bf16["launches"][k["name"]] + \
            int8["launches"][k["name"]]
    print(f"  main path: bf16 {bf16['tok_s']:.1f} tok/s (quartile spread "
          f"{bf16['spread']:.3f}), int8 {int8['tok_s']:.1f} tok/s (spread "
          f"{int8['spread']:.3f}), medians of {SERVE_REPEATS} serves on "
          f"{card}")
    print("phase 4: teacher-forced logits, kernels vs plain (f32)")
    phase_teacher_forced(torch, dev)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    for k in kernels:
        print(f"kernel {k['name']}: {k['launches']} main-path launches, "
              f"max_abs_err {k['max_abs_err']:.3e}, {k['ms']:.4f} ms (plain "
              f"{k['plain_ms']:.4f}, bound {k['bound_ms']:.5f} by "
              f"{k['bound_by']}) on {card}")
    print(f"{card}")
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
