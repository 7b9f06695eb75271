#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:

1. **Build** every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together) and print each kernel's ``-Xptxas -v``
   registers, shared memory and spills; for flash's tensor-core body also
   its dynamic shared memory and the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   load) instruction counts of its library's SASS, both of which must be
   above 0, and no spills; for the decode kernels' tensor-core body
   (contiguous, fused paged and attend-only paged, at D = 64 and 128) its
   registers, dynamic shared memory and spills (none allowed) and the
   ``HMMA`` count of the three libraries (each above 0).
2. **Per-kernel**: each of the five kernels against its plain PyTorch
   version on the card, in bf16, at the main paths' full-width shapes plus
   edge cases (flash: ragged S, valid_len < T, q_offset > 0, whisper's
   G = 1 self prefill at a ragged 300, and at the vision config's D = 128,
   G = 8 causal and non-causal over T = 1601, with a ragged S, valid_len <
   T and q_offset > 0;
   fused decode: an all-sentinel slot, pos on a page boundary, pos = 0, at
   D = 64 and at D = 128, G = 8, and at whisper-base's G = 1, D = 64 with
   slots of several spans, the write row in a later span and on a span's
   first and last row, and at llama's max_len 4096 (8 spans of 512 rows)
   with the write row on a span's first, last and middle row; two calls
   give the same bits on every slot;
   paged decode: valid_len 0, a length on a
   page boundary, sentinel and out-of-pool entries, stale rows past a
   length, two calls give the same bits, and whisper-base's published 1500
   encoder frames (96 pages: 8 spans of 192 rows) with slots at 1500, 1025
   and on a page boundary; contiguous decode: ragged T = 1601, valid_len
   < T and 0; the int8 GEMM at M in {1, 8, 8 x bucket} and N not a
   multiple of the tile).
   Each attention kernel is held twice: to the plain version on the bf16
   inputs, and, tightly, to the plain version on the same inputs widened
   to f32 (probabilities in f32, as the kernels and the Pallas bodies keep
   them): within one bf16 ulp of each element plus 1e-5. The fused decode
   kernel's written rows must be bit-equal to the new rows and every other
   page row, trash page aside, bitwise untouched; the paged decode
   kernel's output must not move when stale rows past a length change.
   Each kernel is timed with CUDA events after warmup beside its bound,
   its plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``; the port never calls it); the
   decode wrappers also by their host cost per call (``host_us``).
3. **Main paths**, each served through ``ServingEngine.serve`` with every
   kernel launch counted (counts set to 0 just before a path, read just
   after), random weights from a seed, the same seeded 16-request stream:
   llama3.2-1b at full width as the bf16 and the int8 variant;
   whisper-base at its published size; llama-3.2-vision-90b at full width
   with its depth cut from 100 to 20 layers (two groups of 9 self layers
   and 1 cross layer). The engine feeds the audio and vlm families
   all-zero stub encoder inputs, as the JAX engine does. Each path serves
   the stream several times on one warm engine; tokens/s is the median,
   with its quartiles as the spread. A profiled serve of each path fails
   unless flash prefill ran its tensor-core body, the int8 GEMM one kernel
   per launch, and bf16 decode the tensor-core decode body (fused, the
   contiguous one on the vision path and the attend-only paged one on the
   whisper path), never an old SIMT bf16 body or a second combine pass.
   Every decode segment is replays of the engine's one CUDA graph of its
   step, captured at warmup: each engine must report one captured graph
   and as many replays as decode steps. The launch counts of a profiled
   serve are set to 0 inside the profiled window, and every wrapper's
   launches (those of a captured step credited once per replay) must
   equal the kernel events the profile holds for it. On each path an
   uncaptured engine, whose segments loop the same step body, serves the
   stream once more: its tokens and every wrapper's launches must equal
   the first graphed serve's. llama3.2-1b bf16 also serves the stream
   with ``chunk_threshold`` 64: every prompt over 64 tokens must be a
   chunked admit, the rest prefilled. Each path prints the host time of a
   replay per step beside the step's device time (replays held back to
   back on idle slots) and the uncaptured serve's tok/s and segment time.
4. **Teacher-forced check**: llama3.2-1b, whisper-base and the vision
   model at 10 layers (one group) in f32, one seeded token stream (and,
   for whisper and vision, seeded non-zero frames / image embeddings)
   forced through prefill and paged decode with the kernel impls and with
   the plain impls; the logits must agree at every prefill and decode
   position.
5. **Control plane**: payload-carrying ``QuerySpec``s through
   ``INFaaS.submit`` -> ``Master`` selection -> ``Worker`` ->
   ``EngineExecutor`` -> ``ServingEngine`` on a one-accel-worker
   llama3.2-1b cluster at full width (``make_cluster(backend="real",
   device="cuda")``, phase 3's engine geometry and stream): the h100-1
   bf16 and int8 variants by name and a use-case query whose SLO rules out
   every cpu-host variant by the analytic profile. Every result must be
   ok, served on h100-1, with the tokens of a fresh engine on the served
   variant's own params; flash prefill, fused decode and (int8) the int8
   GEMM must have launched, and every executor engine must have served its
   decode steps as replays of its one captured graph. Synthetic queries at two batch sizes then
   re-fit both variants' t(b) = m*b + c, printed beside the analytic fit.
6. **Admission under pressure**, on phase 3's llama3.2-1b bf16 model,
   params and stream (8 slots, ``max_len`` 512, page 16): the staging
   ring and the completion log live in the captured step, so refills and
   preemptions must leave the graph the only decode path. An oracle serve
   (worst-case admission, no staging, the default 256 pages,
   ``chunk_threshold`` 0, so every prompt is fed through the graphed step)
   and the pressure serve (``stage_slots`` 4, ``admission="optimistic"``,
   ``preempt_policy="slack"``, 64 pages, ``chunk_threshold`` 0,
   ``stream=True``), served 3 times: its tokens must equal the oracle's
   bit for bit and each request's streamed chunks must concatenate to its
   tokens; its counts must show in-segment admissions and preemptions,
   each preemption re-admitted; one captured graph, a replay per decode
   step; every page free after each serve. An uncaptured engine with the
   pressure knobs must give the same tokens, counts and launches per
   wrapper. On the pressure engine a forced ``preempt`` and a ``cancel``
   mid-serve: the preempted request's tokens must equal the oracle's, the
   cancelled one's be a prefix of them. The prefill variant
   (``chunk_threshold`` None, the pressure knobs) is checked by its counts
   and invariants, and the share of its requests whose tokens equal a
   worst-case prefill serve's is printed, not gated: a replayed or staged
   prompt's KV comes from the fused decode kernel, a prefilled one's from
   flash prefill, which differ in bf16. Prints tok/s (median of 3 serves,
   quartiles), the segment time, the replay host time a step, peak memory
   and the counts beside the card.

The last lines are the card's ``name, power.limit``, one JSON line with
every kernel's numbers, and the result line
``{"ok": true, "device": {...}}``. TF32 is off for every f32 product.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet, dense), at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

SEED = 0
# Timed serves of the stream per path. The serve is host-bound and the
# host's cores are shared, so one serve's tok/s varies by tens of percent
# while its device time does not; the median of many serves is reported.
# The larger models serve fewer times to keep the run inside its limit.
SERVE_REPEATS = {"llama3.2-1b": 15, "whisper-base": 9,
                 "llama-3.2-vision-90b": 5}
CHUNK_THRESHOLD = 64        # the chunked llama serve's threshold
CHUNKED_REPEATS = 3
# phase 6: the pressure serve's pool (a quarter of the default 8 x 512 / 16
# = 256 pages), staging ring and number of timed serves
PRESSURE_PAGES = 64
PRESSURE_STAGE = 4
PRESSURE_REPEATS = 3
VISION_LAYERS = 20          # serve depth of llama-3.2-vision-90b (of 100)
VISION_TF_LAYERS = 10       # its f32 teacher-forced depth: one group
# (Kd, N) of llama3.2-1b's int8 projections: q and o, k and v, gate and up,
# down
INT8_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3, hold: bool = True
            ) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events).

    With ``hold`` (every kernel's ``ms``) the timed launches queue up
    behind a spin kernel that outlasts their host-side enqueue, so the
    device runs them back to back: the time is device time even where a
    call's host overhead exceeds its kernel's. Without it (the earlier
    timer, kept for comparison) each launch starts when the host has
    enqueued it, so a call whose enqueue outlasts its kernel reads as its
    enqueue time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup    # enqueue, at most
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        # four times the enqueue time and 1 ms more (a slow host call must
        # not let the queue run dry), at most 0.5 s, in cycles at 2e9 a
        # second (above the card's top clock, so it lasts at least that)
        torch.cuda._sleep(int(min(4 * iters * host_s + 1e-3, 0.5) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 50) -> float:
    """Host time of one ``fn()`` call in microseconds: its enqueue alone,
    as the calls go into a queue that a spin kernel holds, so that none
    waits for the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * 2e9))     # 50 ms or more, past 50 enqueues
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def check_f32_ulps(torch, got, want32, what: str) -> float:
    """Hold a bf16 kernel result to the plain version run in f32 on the same
    (widened) inputs: every element within one bf16 ulp of the reference
    (rounding the f32 result to bf16 costs at most half of one) plus 1e-5
    for f32 sums taken in another order (``ref.bf16_ulp_ratio``). Returns
    the worst ratio of error to that limit."""
    from repro_torch.kernels.ref import bf16_ulp_ratio
    ratio = bf16_ulp_ratio(got, want32)
    print(f"  {what} vs f32 plain: worst error / (1 bf16 ulp + 1e-5) "
          f"{ratio:.3f} (limit 1)")
    check(ratio <= 1.0, f"{what}: {ratio} of the f32 limit")
    return ratio


def bound(n_bytes: float, n_flops: float, peak_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_build_report(log: str) -> dict:
    """The flash library's tensor-core body: its ptxas registers and spills
    and its dynamic shared memory per head dim, and the count of ``HGMMA``
    (wgmma) and ``UTMALDG`` (TMA load) instructions in the library's SASS.
    Fails if the body spills or either count is 0."""
    from repro_torch.kernels import build
    lines = log.splitlines()
    bodies = {}
    for i, line in enumerate(lines):
        hit = re.search(r"flash_fwd_wgmmaILi(\d+)E", line)
        if "Compiling entry" not in line or hit is None:
            continue
        rest = lines[i + 1:i + 6]
        regs = next(int(m.group(1)) for m in (
            re.search(r"Used (\d+) registers", x) for x in rest) if m)
        spill = next(tuple(map(int, m.groups())) for m in (
            re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      x) for x in rest) if m)
        D = int(hit.group(1))
        smem = build.helper_fn("flash_attention_wgmma_smem_bytes")(D)
        print(f"  flash_attention wgmma body D={D}: {regs} registers, "
              f"{smem} bytes dynamic smem per block, spill stores/loads "
              f"{spill[0]}/{spill[1]} bytes")
        check(spill == (0, 0), f"flash wgmma body D={D} spills {spill}")
        bodies[D] = dict(registers=regs, smem_bytes=smem)
    check(sorted(bodies) == [64, 128],
          f"flash wgmma bodies built: {sorted(bodies)}")
    lib = build._lib_path(build.KERNELS["flash_attention"][0])
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("HGMMA", "UTMALDG")}
    print(f"  flash_attention SASS ({lib.name}): {counts['HGMMA']} HGMMA, "
          f"{counts['UTMALDG']} UTMALDG instructions")
    check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
          f"flash library lacks wgmma or TMA instructions: {counts}")
    return dict(wgmma_bodies=bodies, sass=counts)


DECODE_LIBS = ("decode_attention", "fused_paged_decode_attention",
               "paged_decode_attention")


def decode_build_report(reports: dict) -> dict:
    """The tensor-core body of the three decode kernels (contiguous, fused
    paged, attend-only paged): its ptxas registers and spills per kernel
    and head dim, its dynamic shared memory, and the count of ``HMMA``
    (mma.sync) instructions in each library's SASS. Fails if a body is
    missing or spills, or a count is 0."""
    from repro_torch.kernels import build
    bodies = {}
    for name in DECODE_LIBS:
        lines = reports[name].splitlines()
        for i, line in enumerate(lines):
            hit = re.search(r"((?:fused_|paged_)?decode_mma_kernel)"
                            r"ILi(\d+)E", line)
            if "Compiling entry" not in line or hit is None:
                continue
            rest = lines[i + 1:i + 6]
            regs = next(int(m.group(1)) for m in (
                re.search(r"Used (\d+) registers", x) for x in rest) if m)
            spill = next(tuple(map(int, m.groups())) for m in (
                re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", x) for x in rest) if m)
            D = int(hit.group(2))
            smem = build.helper_fn("decode_mma_smem_bytes")(D)
            key = f"{hit.group(1)} D={D}"
            print(f"  {key}: {regs} registers, {smem} bytes dynamic smem per "
                  f"block, spill stores/loads {spill[0]}/{spill[1]} bytes")
            check(spill == (0, 0), f"{key} spills {spill}")
            bodies[key] = dict(registers=regs, smem_bytes=smem)
    check(len(bodies) == 6,
          f"decode tensor-core bodies built: {sorted(bodies)}")
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    hmma = {}
    for name in DECODE_LIBS:
        lib = build._lib_path(build.KERNELS[name][0])
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        hmma[name] = len(re.findall(r"\bHMMA\b", sass))
        print(f"  {name} SASS ({lib.name}): {hmma[name]} HMMA instructions")
    check(all(n > 0 for n in hmma.values()),
          f"decode libraries lack mma.sync instructions: {hmma}")
    return dict(mma_bodies=bodies, sass_hmma=hmma)


def int8_build_report(log: str) -> dict:
    """The int8 library's two bodies: the ptxas registers and spills of
    every instantiation, and the launch (column tile, cluster, dynamic
    shared memory) at the main paths' shapes. Fails if a body is missing
    or an instantiation that those shapes run spills."""
    import torch
    from repro_torch.kernels.int8_matmul import int8_plan
    lines = log.splitlines()
    built = {}
    for i, line in enumerate(lines):
        hit = re.search(r"int8_(gemv|mma)_kernelI(f|13__nv_bfloat16)"
                        r"((?:Li\d+E)*)E", line)
        if "Compiling entry" not in line or hit is None:
            continue
        rest = lines[i + 1:i + 6]
        regs = next(int(m.group(1)) for m in (
            re.search(r"Used (\d+) registers", x) for x in rest) if m)
        spill = next(tuple(map(int, m.groups())) for m in (
            re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      x) for x in rest) if m)
        dt = "f32" if hit.group(2) == "f" else "bf16"
        ints = re.findall(r"Li(\d+)E", hit.group(3))
        key = (f"gemv {dt} MT={ints[0]} BN={ints[1]}"
               if hit.group(1) == "gemv" else f"mma {dt}")
        built[key] = dict(registers=regs, spill_bytes=spill)
    for key, v in sorted(built.items()):
        print(f"  int8_matmul {key}: {v['registers']} registers, spill "
              f"stores/loads {v['spill_bytes'][0]}/{v['spill_bytes'][1]} B")
    check(any(k.startswith("gemv") for k in built)
          and any(k.startswith("mma") for k in built),
          f"int8 bodies built: {sorted(built)}")
    main = {}
    for M in (8, 2048):
        for (Kd, N), dt in ((s, torch.bfloat16) for s in INT8_SHAPES):
            main[(M, Kd, N, dt)] = int8_plan(M, N, Kd, dt)
        main[(M, 8192, 2048, torch.float32)] = int8_plan(M, 2048, 8192,
                                                         torch.float32)
    runs = {}
    for (M, Kd, N, dt), plan in main.items():
        d = "f32" if dt == torch.float32 else "bf16"
        key = (f"gemv {d} MT={M} BN={plan['block_n']}"
               if plan["body"] == "gemv" else f"mma {d}")
        print(f"  int8_matmul M={M} K={Kd} N={N} {d} x: {plan['body']} "
              f"body, {plan['block_n']} columns per block, cluster "
              f"{plan['cluster']}, {plan['smem_bytes']} B dynamic smem "
              f"({key})")
        check(key in built and built[key]["spill_bytes"] == (0, 0),
              f"int8 body {key} missing or spills")
        runs[key] = dict(built[key], smem_bytes=plan["smem_bytes"],
                         cluster=plan["cluster"])
    return dict(bodies=runs)


# ---------------------------------------------------------------------------
# phase 2: per-kernel comparisons and timings


def time_flash(torch, gen, dev, B, S, T, K, G, D, causal):
    """Kernel, plain version and SDPA at one shape, beside the bound."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    H = K * G
    q = torch.randn((B, S, K, G, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal))
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, H, S, D).contiguous()
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=causal,
                                  enable_gqa=True))
    pairs = S * (S + 1) // 2 if causal else S * T  # live (query, key) pairs
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    n_flops = 4 * B * H * D * pairs
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)
    shape = (f"B={B} S={S} T={T} H={H} K={K} D={D} "
             f"{'causal' if causal else 'non-causal'}")
    print(f"  flash_attention {shape} bf16: {ms:.4f} ms (plain "
          f"{plain_ms:.4f}, SDPA {lib_ms:.4f}, bound {b_ms:.4f} by {b_by})")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def phase_flash(torch, dev, gen):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    tol = 3e-2   # bf16: the plain version rounds probabilities to bf16
    cases = [  # (label, B, S, T, K, G, D, causal, q_offset, valid_len)
        ("B=8 bucket 256", 8, 256, 256, 8, 4, 64, True, 0, None),
        ("B=1 bucket 512", 1, 512, 512, 8, 4, 64, True, 0, None),
        ("ragged S=300", 1, 300, 300, 8, 4, 64, True, 0, None),
        ("valid_len 100 < T 128", 2, 128, 128, 8, 4, 64, True, 0, 100),
        ("q_offset 448 > 0", 1, 64, 512, 8, 4, 64, True, 448, None),
        # the vision config: self prefill and cross prefill over the
        # ragged 1601 image tokens
        ("D=128 G=8 causal bucket 256", 2, 256, 256, 8, 8, 128, True, 0,
         None),
        ("D=128 G=8 non-causal T=1601", 2, 256, 1601, 8, 8, 128, False, 0,
         None),
        # whisper-base's decoder self prefill (G = 1), then the vision
        # widths with a ragged S, valid_len < T and q_offset > 0
        ("K=8 G=1 ragged S=T=300", 2, 300, 300, 8, 1, 64, True, 0, None),
        ("D=128 G=8 ragged S=300 valid_len 250 < T 320", 1, 300, 320, 8, 8,
         128, True, 0, 250),
        ("D=128 G=8 q_offset 448 > 0", 1, 64, 512, 8, 8, 128, True, 448,
         None),
    ]
    worst = 0.0
    for label, B, S, T, K, G, D, causal, q_off, vlen in cases:
        q = torch.randn((B, S, K, G, D), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
        kw = dict(causal=causal, q_offset=q_off, valid_len=vlen)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        want32 = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"  flash_attention [{label}]: max_abs_err {err:.3e} "
              f"(tol {tol})")
        check(err <= tol, f"flash_attention {label}: err {err}")
        check_f32_ulps(torch, got, want32, f"flash_attention [{label}]")
        worst = max(worst, err)
    # times at the main paths' grouped-prefill shapes: llama3.2-1b (the
    # reported one), then the vision self and cross prefill
    main = time_flash(torch, gen, dev, 8, 256, 256, 8, 4, 64, True)
    extra = [time_flash(torch, gen, dev, 8, 256, 256, 8, 8, 128, True),
             time_flash(torch, gen, dev, 8, 256, 1601, 8, 8, 128, False)]
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:106",
                max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shape=main["shape"],
                other_shapes=extra)


# slot 0 at pos 0, slot 1 on a page boundary (first row of a new page),
# slot 2 on a page's last row, slot 4 at max_len - 1, slot 7 inactive with
# an all-sentinel row
FUSED_POS = [0, 16, 15, 300, 511, 47, 203, 100]
# the write row on the last and first rows of the fused kernel's 128-row
# spans, inside them and in later spans, slots of up to 4 spans
FUSED_SPAN_POS = [64, 127, 128, 255, 256, 383, 1, 0]
# llama's max_len 4096 (256 pages of 16: 8 spans of 512 rows): the write
# row on a span's last and first row, in a span's middle, on the table's
# last row
FUSED_LONG_POS = [511, 512, 1280, 4095, 0, 2559, 3584, 100]


def phase_fused_decode(torch, dev, gen, B=8, K=8, G=4, D=64, ps=16, P=32,
                       pos_list=FUSED_POS):
    from repro_torch.kernels.decode_attention import (
        _split, decode_body, fused_paged_decode_attention)
    from repro_torch.kernels.ref import fused_paged_decode_attention_ref
    tol = 3e-2   # bf16: the plain version rounds probabilities to bf16
    n_pages = B * P
    n_phys = n_pages + 1                        # trash page == sentinel
    sent = n_pages
    perm = torch.randperm(n_pages, generator=gen, device=dev).reshape(B, P)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
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
    again, _, _ = fused_paged_decode_attention(q, kn, vn, k0.clone(),
                                               v0.clone(), bt, pos)
    out, kp2, vp2 = fused_paged_decode_attention(q, kn, vn, kp, vp, bt, pos)
    o_ref, _, _ = fused_paged_decode_attention_ref(q, kn, vn, k0.clone(),
                                                   v0.clone(), bt, pos)
    o_32, _, _ = fused_paged_decode_attention_ref(
        q.float(), kn.float(), vn.float(), k0.float(), v0.float(), bt, pos)
    torch.cuda.synchronize()
    body = decode_body(q.dtype, G, D)
    _n, split = _split("fused_paged_decode_attention", body, P * ps, q)
    spans = [p // split for p in pos_list[:live]]
    err = (out[:live].float() - o_ref[:live].float()).abs().max().item()
    print(f"  fused_paged_decode_attention [G={G} D={D}, {body} body; pos "
          f"{pos_list[:live]} (write row in span {spans} of {split} rows), "
          f"all-sentinel slot]: max_abs_err {err:.3e} (tol {tol})")
    # the all-sentinel slot reads trash-page rows, whose write the kernel
    # drops: its output, discarded by the pool contract, is finite and the
    # same on every call
    check(torch.equal(out, again), "fused decode: two calls differ")
    check(bool(out[live:].isfinite().all()),
          "fused decode: the all-sentinel slot's output is not finite")
    check(err <= tol, f"fused decode output err {err}")
    check_f32_ulps(torch, out[:live], o_32[:live],
                   f"fused_paged_decode_attention [G={G} D={D}]")
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
    def fn():
        return fused_paged_decode_attention(q, kn, vn, kp, vp, bt, pos)

    ms = cuda_ms(fn)
    h_us = host_us(fn)
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
          f"{b_ms:.5f} by {b_by}); host {h_us:.1f} us a call")
    return dict(name="fused_paged_decode_attention", route="cuda",
                source="src/repro_torch/csrc/fused_paged_decode.cu",
                replaces="src/repro/kernels/decode_attention.py:328",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, host_us=h_us,
                shape=f"B={B} K={K} G={G} D={D} ps={ps} P={P}")


# slot 0 has nothing to attend (valid_len 0), slot 1 ends on a page
# boundary, slot 4 spans all P pages, slot 7 gets an entry far outside the
# pool past its length
PAGED_LENS = [0, 32, 300, 1, 512, 47, 203, 100]
# whisper-base's published 1500 encoder frames in 96 pages of 16 (8 spans
# of 192 rows): slots at 1500 and 1025, on a page boundary (1248), on a
# span boundary (768), all 1536 rows, one row
PAGED_LONG_LENS = [1500, 1025, 1248, 768, 1536, 1, 1499, 192]


def paged_inputs(torch, dev, gen, lens, B=8, K=8, G=1, D=64, ps=16, P=32):
    """Pools of B * P pages and a trash page, q, and a block table of
    shuffled pages that holds the sentinel past each slot's pages."""
    n_pages = B * P
    n_phys = n_pages + 1                        # trash page == sentinel
    perm = torch.randperm(n_pages, generator=gen, device=dev).reshape(B, P)
    vlen = torch.tensor(lens, dtype=torch.int32, device=dev)
    n_alloc = (vlen.long() + ps - 1) // ps
    bt = torch.where(torch.arange(P, device=dev)[None, :] < n_alloc[:, None],
                     perm, torch.full_like(perm, n_pages)).to(torch.int32)
    kp = torch.randn((n_phys, ps, K, D), generator=gen, device=dev).bfloat16()
    vp = torch.randn((n_phys, ps, K, D), generator=gen, device=dev).bfloat16()
    q = torch.randn((B, K, G, D), generator=gen, device=dev).bfloat16()
    return q, kp, vp, bt, vlen, perm.to(torch.int32)


def time_paged(torch, q, kp, vp, bt, rows_per_slot):
    """The attend-only kernel and its plain version with every slot at
    ``rows_per_slot``, beside the bound, and the wrapper's host cost."""
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.ref import paged_decode_attention_ref
    B, K, G, D = q.shape
    ps, P = kp.shape[1], bt.shape[1]
    vt = torch.full((B,), rows_per_slot, dtype=torch.int32, device=q.device)

    def fn():
        return paged_decode_attention(q, kp, vp, bt, vt)

    ms = cuda_ms(fn)
    h_us = host_us(fn)
    plain_ms = cuda_ms(lambda: paged_decode_attention_ref(q, kp, vp, bt, vt))
    rows = rows_per_slot * B
    n_bytes = (2 * (2 * rows * K * D + 2 * q.numel())   # live k/v rows, q, out
               + 4 * (B * -(-rows_per_slot // ps) + B))  # live bt, vlen
    b_ms, b_by = bound(n_bytes, 4 * K * G * D * rows, BF16_FLOPS)
    shape = (f"B={B} K={K} G={G} D={D} ps={ps} P={P} valid_len "
             f"{rows_per_slot}")
    print(f"  paged_decode_attention {shape} bf16: {ms:.4f} ms (plain "
          f"{plain_ms:.4f}, bound {b_ms:.5f} by {b_by}); host {h_us:.1f} us "
          "a call")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, host_us=h_us)


def phase_paged_decode(torch, dev, gen, B=8, K=8, G=1, D=64, ps=16, P=32):
    """The attend-only paged decode kernel at whisper-base's cross-attention
    shape: 8 slots, 8 heads of 64, encoder pools of 16-row pages; then at
    its published 1500 encoder frames, past 1024 rows."""
    from repro_torch.kernels.decode_attention import (_split, decode_body,
                                                      paged_decode_attention)
    from repro_torch.kernels.ref import paged_decode_attention_ref
    tol = 3e-2   # bf16: the plain version rounds probabilities to bf16
    q, kp, vp, bt, vlen, perm = paged_inputs(torch, dev, gen, PAGED_LENS, B,
                                             K, G, D, ps, P)
    n_phys = kp.shape[0]
    sent = n_phys - 1
    bt[7, -1] = n_phys + 9
    body = decode_body(q.dtype, G, D)
    n_split, split = _split("paged_decode_attention", body, P * ps, q)
    out = paged_decode_attention(q, kp, vp, bt, vlen)
    again = paged_decode_attention(q, kp, vp, bt, vlen)
    want = paged_decode_attention_ref(q, kp, vp, bt, vlen)
    want32 = paged_decode_attention_ref(q.float(), kp.float(), vp.float(),
                                        bt, vlen)
    # stale rows: every row at or past a slot's length in its live pages,
    # and the trash page, rewritten; the output must not move by a bit
    kp2, vp2 = kp.clone(), vp.clone()
    for b in range(B):
        n = int(vlen[b])
        for t in range(n, -(-n // ps) * ps):
            page = int(bt[b, t // ps])
            kp2[page, t % ps] = 1e4
            vp2[page, t % ps] = -1e4
    kp2[sent], vp2[sent] = 1e4, -1e4
    out2 = paged_decode_attention(q, kp2, vp2, bt, vlen)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    print(f"  paged_decode_attention [{body} body, {n_split} spans of "
          f"{split} rows; valid_len 0, page boundary, full span, sentinel "
          f"and out-of-pool entries]: max_abs_err {err:.3e} (tol {tol})")
    check(err <= tol, f"paged decode err {err}")
    check(not out[0].any(), "paged decode: valid_len 0 did not give zeros")
    check(torch.equal(out, again), "paged decode: two calls differ")
    check_f32_ulps(torch, out, want32, "paged_decode_attention")
    check(torch.equal(out, out2), "paged decode: stale rows past a length "
          "or the trash page moved the output")
    print("  paged_decode_attention: two calls bit-equal; output bitwise "
          "unchanged with every stale row and the trash page rewritten")
    # past 1024 rows: whisper-base's published 1500 encoder frames
    Pl = 96
    ql, kpl, vpl, btl, vlenl, perml = paged_inputs(
        torch, dev, gen, PAGED_LONG_LENS, B, K, G, D, ps, Pl)
    nl, splitl = _split("paged_decode_attention", body, Pl * ps, ql)
    outl = paged_decode_attention(ql, kpl, vpl, btl, vlenl)
    againl = paged_decode_attention(ql, kpl, vpl, btl, vlenl)
    wantl = paged_decode_attention_ref(ql, kpl, vpl, btl, vlenl)
    want32l = paged_decode_attention_ref(ql.float(), kpl.float(),
                                         vpl.float(), btl, vlenl)
    torch.cuda.synchronize()
    errl = (outl.float() - wantl.float()).abs().max().item()
    print(f"  paged_decode_attention [{body} body, {Pl} pages of {ps}: "
          f"{nl} spans of {splitl} rows; valid_len {PAGED_LONG_LENS}]: "
          f"max_abs_err {errl:.3e} (tol {tol})")
    check((nl, splitl) == (8, 192), f"paged decode long plan {nl, splitl}")
    check(errl <= tol, f"paged decode long-span err {errl}")
    check(torch.equal(outl, againl), "paged decode long: two calls differ")
    check_f32_ulps(torch, outl, want32l, "paged_decode_attention [1536 rows]")
    # times at enc_len 300 in every slot (a 300-frame encoder output), the
    # reported one, and at the published 1500
    main = time_paged(torch, q, kp, vp, perm, 300)
    extra = [time_paged(torch, ql, kpl, vpl, perml, 1500)]
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/csrc/paged_decode.cu",
                replaces="src/repro/kernels/decode_attention.py:201",
                max_abs_err=max(err, errl), ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                host_us=main["host_us"], shape=main["shape"],
                other_shapes=extra)


def phase_decode(torch, dev, gen, B=8, K=8, G=8, D=128, T=1601):
    """The contiguous decode kernel at the vision config's cross-attention
    shape: 8 slots, 64 query heads over 8 KV heads of 128, 1601 image
    tokens in the model layout (B, T, K, D)."""
    from repro_torch.kernels.decode_attention import (_split,
                                                      decode_attention,
                                                      decode_attention_plain,
                                                      decode_body)
    tol = 3e-2   # bf16: the plain version rounds probabilities to bf16
    worst = 0.0
    cases = [("T=1601 ragged, valid_len T", B, G, T, None),
             ("valid_len 777 < T", 2, G, T, 777),
             ("valid_len 256, on a span boundary", 2, G, T, 256),
             ("G=1, valid_len 0", 2, 1, 37, 0)]
    for label, b, g, t, vlen in cases:
        q = torch.randn((b, K, g, D), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, t, K, D), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, t, K, D), generator=gen, device=dev).bfloat16()
        out = decode_attention(q, k, v, vlen)
        again = decode_attention(q, k, v, vlen)
        want = decode_attention_plain(q, k, v, vlen)
        want32 = decode_attention_plain(q.float(), k.float(), v.float(), vlen)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        n_split, split = _split("decode_attention", "mma",
                                t if vlen is None else vlen, q)
        print(f"  decode_attention [{label}, {decode_body(q.dtype, g, D)} "
              f"body, {n_split} spans of {split} rows]: max_abs_err "
              f"{err:.3e} (tol {tol})")
        check(err <= tol, f"decode_attention {label}: err {err}")
        check(torch.equal(out, again), f"decode_attention {label}: two calls "
              "differ")
        check_f32_ulps(torch, out, want32, f"decode_attention [{label}]")
        if vlen == 0:
            check(not out.any(), "decode_attention: valid_len 0 not zeros")
        worst = max(worst, err)
    q = torch.randn((B, K, G, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    ms = cuda_ms(lambda: decode_attention(q, k, v))
    h_us = host_us(lambda: decode_attention(q, k, v))
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, k, v))
    qh = q.reshape(B, K * G, 1, D)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(lambda: sdpa(qh, kh, vh, enable_gqa=True))
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    n_flops = 4 * B * K * G * D * T
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)
    shape = f"B={B} K={K} G={G} D={D} T={T}"
    print(f"  decode_attention {shape} bf16: {ms:.4f} ms (plain "
          f"{plain_ms:.4f}, SDPA {lib_ms:.4f}, bound {b_ms:.5f} by {b_by}); "
          f"host {h_us:.1f} us a call")
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:109",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, host_us=h_us, shape=shape)


def time_int8(torch, x, w_q, s):
    """Kernel, plain version and ``torch.mm`` on the dequantised weight in
    x's dtype (TF32 off for f32) at one shape, beside the bound, under two
    timers. ``ms``: launches held back to back (``cuda_ms``), each timed
    call taking the next of enough weight copies to pass 100 MB, twice the
    L2 cache, as a decode step streams its 994 MB of weights cold.
    ``ms_paced``: the earlier timer, launches paced by the host, one weight
    copy (warm in L2). ``host_us``: the host time of one call. f32 x costs the
    tensor-core body three bf16 passes (x split into hi, mid and lo), so its
    operations count three times."""
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.ref import int8_matmul_ref
    M, Kd = x.shape
    N = w_q.shape[1]
    n_copies = min(64, max(2, -(-100_000_000 // (Kd * N))))
    ws = [(w_q.clone(), s.clone()) for _ in range(n_copies)]
    w_deq = [((q.float() * sc).to(x.dtype),) for q, sc in ws]

    def cycle(fn, args):
        it = itertools.cycle(args)
        return lambda: fn(*next(it))

    def kernel(q, sc):
        return int8_matmul(x, q, sc)

    def library(wd):
        return torch.mm(x, wd)

    ms = cuda_ms(cycle(kernel, ws))
    plain_ms = cuda_ms(cycle(lambda q, sc: int8_matmul_ref(x.float(), q, sc),
                             ws))
    lib_ms = cuda_ms(cycle(library, w_deq))
    ms_paced = cuda_ms(lambda: kernel(*ws[0]), hold=False)
    lib_paced = cuda_ms(lambda: library(*w_deq[0]), hold=False)
    h_us = host_us(cycle(kernel, ws))
    lib_h_us = host_us(cycle(library, w_deq))
    del ws, w_deq
    f32 = x.dtype == torch.float32
    n_bytes = x.element_size() * M * Kd + Kd * N + 4 * N + 4 * M * N
    b_ms, b_by = bound(n_bytes, (3 if f32 else 1) * 2 * M * N * Kd,
                       BF16_FLOPS)
    dt = "f32" if f32 else "bf16"
    shape = f"M={M} K={Kd} N={N} {dt} x"
    print(f"  int8_matmul {shape}: {ms:.4f} ms held, cold (plain "
          f"{plain_ms:.4f}, torch.mm {dt} {lib_ms:.4f}, bound {b_ms:.5f} "
          f"by {b_by}; {n_copies} weight copies); paced, warm {ms_paced:.4f}"
          f" (torch.mm {lib_paced:.4f}); host {h_us:.1f} us a call "
          f"(torch.mm {lib_h_us:.1f})")
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, ms_paced=ms_paced,
                library_ms_paced=lib_paced, host_us=h_us,
                library_host_us=lib_h_us)


# f32 x's second limit, as a share of max|ref|. The first (2e-3) passes
# x rounded to bf16 once, the shortcut that the three-term split avoids.
# Set from readings (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W): the
# split body's worst error 2.6e-6 / 2.4e-5 at M = 8 / 2048 (max|ref| about
# 4-5); the one-pass control's, 1e-3 to 4e-3.
F32_X_RTOL = 2e-5


def check_f32_x(torch, x, w_q, s, got, want) -> None:
    """Hold the kernel on f32 x within ``F32_X_RTOL`` of max|ref|, and show
    that the limit catches the kernel run on x rounded to bf16 once."""
    from repro_torch.kernels.int8_matmul import int8_matmul
    lim = F32_X_RTOL * want.abs().max().item()
    err = (got - want).abs().max().item()
    err1 = (int8_matmul(x.bfloat16(), w_q, s) - want).abs().max().item()
    print(f"    f32 x M={x.shape[0]}: max_abs_err {err:.3e}, one bf16 pass "
          f"{err1:.3e}, limit {lim:.3e} ({F32_X_RTOL} x max|ref|)")
    check(err <= lim, f"int8_matmul f32 x M={x.shape[0]}: err {err} > {lim}")
    check(err1 > lim, f"int8_matmul f32 x M={x.shape[0]}: one bf16 pass "
          f"within the limit ({err1} <= {lim})")


def phase_int8(torch, dev, gen):
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.ref import int8_matmul_ref, quantize_int8
    # f32 accumulation in another order than the plain f32 product
    rtol = atol = 2e-3
    shapes = INT8_SHAPES
    cases = [(m, kd, n, torch.bfloat16) for kd, n in shapes
             for m in (1, 8, 8 * 256)]
    cases += [(5, 2048, 1000, torch.bfloat16),     # N not a tile multiple
              (77, 300, 130, torch.bfloat16)]
    # the down projection's x is f32 (silu(g) * u of two f32 products)
    cases += [(m, 8192, 2048, torch.float32) for m in (8, 8 * 256)]
    worst = 0.0
    timed = {}
    for M, Kd, N, dt in cases:
        x = torch.randn((M, Kd), generator=gen, device=dev).to(dt)
        w = torch.randn((Kd, N), generator=gen, device=dev) / Kd ** 0.5
        w_q, s = quantize_int8(w)
        got = int8_matmul(x, w_q, s)
        want = int8_matmul_ref(x.float(), w_q, s)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        lim = atol + rtol * want.abs().max().item()
        check(got.dtype == torch.float32, "int8_matmul output dtype")
        check(err <= lim, f"int8_matmul M={M} K={Kd} N={N} {dt}: err {err}")
        worst = max(worst, err)
        if dt == torch.float32:
            check_f32_x(torch, x, w_q, s, got, want)
        if (Kd, N) in shapes and M in (8, 8 * 256):
            timed[(M, Kd, N, dt)] = time_int8(torch, x, w_q, s)
            print(f"    max_abs_err {err:.2e}")
    print(f"  int8_matmul: {len(cases)} shapes within atol {atol} + rtol "
          f"{rtol} x max|ref|, worst max_abs_err {worst:.3e}")
    main = timed.pop((8, 2048, 8192, torch.bfloat16))
    return dict(name="int8_matmul", route="cuda",
                source="src/repro_torch/csrc/int8_matmul.cu",
                replaces="src/repro/kernels/int8_matmul.py:64",
                max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shape=main["shape"],
                ms_paced=main["ms_paced"],
                library_ms_paced=main["library_ms_paced"],
                host_us=main["host_us"], other_shapes=list(timed.values()))


# ---------------------------------------------------------------------------
# phase 3: the main path


def make_stream(vocab: int, n: int = 16, seed: int = 1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(16, 301))
                          ).astype(np.int32), int(rng.integers(16, 65)))
            for _ in range(n)]


def uncaptured_engine():
    """The engine class whose segments run the plain loop of its step body
    on the card, captured nowhere: the oracle of the graph replays (not a
    knob of the engine; only this comparison runs the body uncaptured)."""
    import torch
    from repro_torch.serving.engine import ServingEngine

    class Uncaptured(ServingEngine):
        def _capture(self):
            pass

        def _run_steps(self, n_steps):
            with torch.no_grad():
                for _ in range(n_steps):
                    self._step_body()

    return Uncaptured


def graph_step_ms(eng) -> float:
    """Device time of one replay of the engine's step graph: blocks of
    ``decode_block`` replays held back to back (``cuda_ms``) on the
    quiesced engine (every slot idle, its writes dropped, the loop state
    restored after)."""
    n = eng.decode_block

    def block():
        eng._step_i.zero_()
        for _ in range(n):
            eng._graph.replay()

    with eng._quiesced():
        return cuda_ms(block, iters=5, warmup=1) / n


def serve_variant(torch, dev, model, params, stream, label, repeats,
                  chunk_threshold=None):
    """Serve the stream ``repeats`` times on one warm engine, whose decode
    segments are replays of its one captured step graph, then once on an
    uncaptured engine that loops the same step body: the tokens and every
    wrapper's launches of that serve must equal the first graphed
    serve's."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Request, ServingEngine
    geometry = dict(max_batch=8, max_len=512, decode_block=16, page_size=16,
                    chunk_threshold=chunk_threshold)
    eng = ServingEngine(model, params, **geometry)
    eng.warmup(prompt_lens=[len(p) for p, _ in stream])
    check(eng.stats["decode_traces"] == 1,
          f"{label}: warmup captured {eng.stats['decode_traces']} graphs")
    torch.cuda.reset_peak_memory_stats(dev)
    vocab = model.cfg.vocab
    rates, first = [], None
    build.reset_launch_counts()
    for rep in range(repeats):
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
            first = (dict(eng.stats), dict(eng.timing),
                     [r.tokens for r in reqs], dict(build.launch_counts))
    launches = dict(build.launch_counts)
    s, timing, first_tokens, first_launches = first
    st = eng.stats
    check(st["decode_traces"] == 1
          and st["graph_replays"] == st["decode_steps"] > 0,
          f"{label}: {st['decode_traces']} captured graphs, "
          f"{st['graph_replays']} replays for {st['decode_steps']} steps")
    replay_us = eng.timing["replay_s"] / st["graph_replays"] * 1e6
    step_ms = graph_step_ms(eng)
    segs = s["decode_dispatches"]
    seg_ms = timing["decode_s"] / segs * 1e3 if segs else 0.0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del eng
    q1, med, q3 = statistics.quantiles(rates, n=4)
    spread = (q3 - q1) / med
    print(f"  {label}: {len(stream)} reqs / {toks} tokens per serve, "
          f"{repeats} serves: median {med:.1f} tok/s (quartiles "
          f"{q1:.1f}-{q3:.1f}, spread (q3 - q1) / median {spread:.3f}; min "
          f"{min(rates):.1f}, max {max(rates):.1f}; each "
          f"{', '.join(f'{x:.1f}' for x in rates)})")
    print(f"  {label}, first serve: {s['prefill_dispatches']} prefill + "
          f"{segs} decode dispatches, {s['decode_steps']} decode steps, "
          f"{s['chunk_admits']} chunked admits, mean decode segment "
          f"{seg_ms:.2f} ms, prefill {timing['prefill_s']:.3f} s; peak "
          f"memory {peak_gb:.2f} GB; launches over all serves {launches}")
    print(f"  {label}: 1 captured step graph, {st['graph_replays']} replays "
          f"over all serves; replay host time {replay_us:.1f} us a step "
          f"against {step_ms:.4f} ms of device time a step (idle slots)")
    # the oracle: the same body, uncaptured, on the same card
    oracle = uncaptured_engine()(model, params, **geometry)
    oracle.warmup(prompt_lens=[len(p) for p, _ in stream])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(stream)]
    build.reset_launch_counts()
    t0 = time.perf_counter()
    oracle.serve(reqs)
    torch.cuda.synchronize(dev)
    eager_wall = time.perf_counter() - t0
    eager_launches = dict(build.launch_counts)
    eager_seg_ms = (oracle.timing["decode_s"]
                    / oracle.stats["decode_dispatches"] * 1e3)
    check(oracle.stats["decode_traces"] == 0
          and oracle.stats["graph_replays"] == 0,
          f"{label}: the uncaptured engine captured or replayed")
    check(all(np.array_equal(a, r.tokens)
              for a, r in zip(first_tokens, reqs)),
          f"{label}: graphed tokens differ from the uncaptured body's")
    check(eager_launches == first_launches,
          f"{label}: credited launches {first_launches} against the "
          f"uncaptured body's {eager_launches}")
    del oracle
    torch.cuda.empty_cache()
    print(f"  {label}: tokens of the first serve equal the uncaptured step "
          f"body's, bit for bit, and every wrapper's credited launches its "
          f"launches; that serve took {eager_wall * 1e3:.1f} ms "
          f"({toks / eager_wall:.1f} tok/s), mean decode segment "
          f"{eager_seg_ms:.2f} ms")
    return dict(tok_s=med, tok_s_all=rates, spread=spread, tokens=toks,
                launches=launches, stats=s, seg_ms=seg_ms,
                prefill_s=timing["prefill_s"], peak_gb=peak_gb,
                replay_us=replay_us, step_ms=step_ms,
                eager_tok_s=toks / eager_wall, eager_seg_ms=eager_seg_ms)


# bf16 decode kernels that must not run on a served path any more: the
# fused kernel's one-block-per-(slot, head) body, the SIMT split body of
# the contiguous and attend-only paged kernels in bf16, and the attend-only
# kernel's second pass (the combine of repro::decode_split)
OLD_DECODE = re.compile(r"fused_paged_decode_kernel|fused_decode_simt_kernel"
                        r"|(?<![A-Za-z_])decode_kernel<__nv_bfloat16"
                        r"|paged_decode_kernel<__nv_bfloat16"
                        r"|decode_split::combine")
# the contiguous kernel's tensor-core body (not the fused one's)
DECODE_MMA = re.compile(r"(?<![A-Za-z_])decode_mma_kernel<")


# which wrapper launched a profiled kernel, from the kernel's name
WRAPPER_OF = (("flash_attention", re.compile(r"flash_fwd_")),
              ("fused_paged_decode_attention", re.compile(r"fused_decode_")),
              ("paged_decode_attention", re.compile(r"paged_decode_")),
              ("decode_attention",
               re.compile(r"(?<![A-Za-z_])decode_(mma_)?kernel<")),
              ("int8_matmul", re.compile(r"int8_gemv|int8_mma")))


def wrapper_of(kernel_name: str):
    for wrapper, pattern in WRAPPER_OF:
        if pattern.search(kernel_name):
            return wrapper
    return None


def profile_variant(torch, dev, model, params, stream, label,
                    contiguous_decode=False, paged_decode=False):
    """Where the time goes: ``torch.profiler`` over a short serve of the
    stream's first 8 requests. Prints the device's busy share (summed
    device kernel time over host wall time, profiler on) and the kernels
    with the most device time. Checks which bodies the kernels ran: the
    decode lines must show the fused kernel's tensor-core body (and, with
    ``contiguous_decode``, the contiguous kernel's; with ``paged_decode``,
    the attend-only paged kernel's) and no old bf16 decode body."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(model, params, max_batch=8, max_len=512,
                        decode_block=16, page_size=16)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(stream[:8])]
    eng.warmup(prompt_lens=[len(r.prompt) for r in reqs])
    check(eng.stats["decode_traces"] == 1,
          f"{label}: warmup captured {eng.stats['decode_traces']} graphs")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # one kernel and a sync before the timed serve: a profiled serve
        # (NVIDIA H100 80GB HBM3, 700 W) once missed two layers' kernels of
        # a prefill dispatch, all launched early in the serve, and failed
        # the int8 launch-count check below. The counts are set to 0 here,
        # inside the profiled window, so that they and the profile cover
        # the same launches.
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    st = eng.stats
    check(st["decode_traces"] == 1
          and st["graph_replays"] == st["decode_steps"] > 0,
          f"{label}: profiled serve with {st['decode_traces']} captured "
          f"graphs, {st['graph_replays']} replays for {st['decode_steps']} "
          "steps")
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + us, n + 1)
    busy_us = sum(t for t, _ in by_name.values())
    # every wrapper's launches, credited once per replay of the step graph,
    # against the kernel events the profile holds for it
    events = dict.fromkeys(build.launch_counts, 0)
    for name, (_us, n) in by_name.items():
        wrapper = wrapper_of(name)
        if wrapper is not None:
            events[wrapper] += n
    launched = sum(build.launch_counts.values())
    print(f"  {label} profile coverage: {launched} wrapper launches, "
          f"{sum(events.values())} profiled kernel events; per wrapper "
          + ", ".join(f"{w} {build.launch_counts[w]}/{events[w]}"
                      for w in sorted(events)))
    check(events == build.launch_counts,
          f"{label}: wrapper launches {dict(build.launch_counts)} against "
          f"profiled kernel events {events}")
    print(f"  {label} profile (8 reqs, {st['decode_steps']} decode "
          f"steps, all graph replays): wall {wall_us / 1e3:.1f} ms, device "
          f"kernel time "
          f"{busy_us / 1e3:.1f} ms, device busy share "
          f"{busy_us / wall_us:.3f}, idle share {1 - busy_us / wall_us:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, n) in top:
        print(f"    {us / 1e3:9.2f} ms {n:6d} calls  {name[:90]}")
    # the served paths send bf16 to flash prefill: its tensor-core body
    # must run, and never the f32 SIMT body
    flash = {name: v for name, v in by_name.items() if "flash_fwd" in name}
    for name, (us, n) in sorted(flash.items()):
        print(f"    flash prefill: {us / 1e3:9.2f} ms {n:6d} calls  "
              f"{name[:90]}")
    check(any("flash_fwd_wgmma" in name for name in flash)
          and not any("flash_fwd_simt" in name for name in flash),
          f"{label}: flash prefill bodies in the profile: {sorted(flash)}")
    # the int8 GEMM: one kernel per wrapper call (the first version added a
    # split-K reduce kernel at decode)
    int8 = {name: v for name, v in by_name.items()
            if "int8_gemv" in name or "int8_mma" in name}
    for name, (us, n) in sorted(int8.items()):
        print(f"    int8 GEMM: {us / 1e3:9.2f} ms {n:6d} calls  {name[:90]}")
    calls = sum(n for _, n in int8.values())
    check(calls == build.launch_counts["int8_matmul"]
          and not any("splitk_reduce" in name for name in by_name),
          f"{label}: {calls} int8 kernels in the profile for "
          f"{build.launch_counts['int8_matmul']} wrapper launches")
    # the decode kernels: the tensor-core bodies, one launch a call
    dec = {name: v for name, v in by_name.items() if "decode" in name}
    for name, (us, n) in sorted(dec.items()):
        print(f"    decode: {us / 1e3:9.2f} ms {n:6d} calls  {name[:90]}")
    check(any("fused_decode_mma_kernel" in name for name in dec)
          and not any(OLD_DECODE.search(name) for name in by_name)
          and (not contiguous_decode
               or any(DECODE_MMA.search(name) for name in dec))
          and (not paged_decode
               or any("paged_decode_mma_kernel" in name for name in dec)),
          f"{label}: decode bodies in the profile: {sorted(dec)}")
    return dict(device_ms=busy_us / 1e3, wall_ms=wall_us / 1e3,
                busy_share=busy_us / wall_us,
                int8_ms=sum(us for us, _ in int8.values()) / 1e3,
                decode_ms=sum(us for us, _ in dec.values()) / 1e3)


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
    reps = SERVE_REPEATS["llama3.2-1b"]
    bf16 = serve_variant(torch, dev, model, params, stream, "bf16 variant",
                         reps)
    bf16["profile"] = profile_variant(torch, dev, model, params, stream,
                                      "bf16 variant")
    # chunked prefill: prompts past the threshold are fed through the
    # graphed segments with no prefill dispatch
    n_over = sum(len(p) > CHUNK_THRESHOLD for p, _ in stream)
    chunked = serve_variant(torch, dev, model, params, stream,
                            f"bf16 variant, chunk_threshold "
                            f"{CHUNK_THRESHOLD}", CHUNKED_REPEATS,
                            chunk_threshold=CHUNK_THRESHOLD)
    s = chunked["stats"]
    check(s["chunk_admits"] == n_over > 0
          and s["admitted"] - s["chunk_admits"] == len(stream) - n_over
          and 0 < s["prefill_dispatches"] <= len(stream) - n_over,
          f"chunked serve: {s['chunk_admits']} chunked admits and "
          f"{s['prefill_dispatches']} prefill dispatches for {n_over} "
          f"prompts over {CHUNK_THRESHOLD} of {len(stream)}")
    bf16["chunked"] = chunked
    qcfg = dataclasses.replace(base, quantize="int8").for_device(dev)
    check(qcfg.quantize == "int8_cuda", "config did not select the int8 GEMM")
    qparams = quantize_params_dense(params)
    # phase 6 serves the bf16 model again; it frees the params after
    bf16["llama"] = (model, params, stream)
    qmodel = build_model(qcfg, dev)
    int8 = serve_variant(torch, dev, qmodel, qparams, stream, "int8 variant",
                         reps)
    int8["profile"] = profile_variant(torch, dev, qmodel, qparams, stream,
                                      "int8 variant")
    del qparams
    torch.cuda.empty_cache()
    for name in ("flash_attention", "fused_paged_decode_attention"):
        check(bf16["launches"][name] > 0 and int8["launches"][name] > 0
              and chunked["launches"][name] > 0,
              f"{name} was not launched on the main path")
    check(int8["launches"]["int8_matmul"] > 0,
          "int8_matmul was not launched on the int8 variant")
    return bf16, int8


def phase_family(torch, dev, arch, n_layers=None):
    """Serve the stream through one audio or vlm path at full width (depth
    cut to ``n_layers`` when given) and check that its kernels ran: flash
    prefill and fused decode everywhere, and the cross-attention decode
    kernel of the family."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model
    base = ARCHS[arch]
    if n_layers is not None:
        base = dataclasses.replace(base, n_layers=n_layers)
    cfg = base.for_device(dev)
    check(cfg.attention_impl == "cuda", "config did not select the kernels")
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize(dev)
    print(f"  {arch}: {cfg.n_layers} layers, {base.param_count() / 1e9:.3f} "
          f"B params, bf16, init {time.perf_counter() - t0:.1f} s")
    stream = make_stream(cfg.vocab)
    res = serve_variant(torch, dev, model, params, stream, arch,
                        SERVE_REPEATS[arch])
    res["profile"] = profile_variant(
        torch, dev, model, params, stream, arch,
        contiguous_decode=cfg.family == "vlm",
        paged_decode=cfg.family == "audio")
    del params
    torch.cuda.empty_cache()
    cross = {"audio": "paged_decode_attention",
             "vlm": "decode_attention"}[cfg.family]
    for name in ("flash_attention", "fused_paged_decode_attention", cross):
        check(res["launches"][name] > 0,
              f"{name} was not launched on the {arch} path")
    return res


# ---------------------------------------------------------------------------
# phase 4: teacher-forced logits, kernel impls vs plain impls, f32


def teacher_forced(torch, dev, model, params, prompts, lengths, forced,
                   stub, ps=16, max_len=512):
    """Logits at each request's last prompt position and at every forced
    decode position, through ``model.prefill`` and ``model.decode``.

    Every cache leaf with a sequence axis becomes a page pool (with the
    kernel layout's trash page) filled through an identity block table;
    per-slot leaves pass as they are. ``stub`` holds the family's encoder
    input, if any."""
    from repro_torch.models import kvcache as KV
    B, S = prompts.shape
    P = max_len // ps
    bt = np.arange(B * P, dtype=np.int32).reshape(B, P)
    rows = -(-S // ps)
    shapes = model.cache_shapes(B, max_len, enc_len=max_len)
    axes = KV.leaf_axes(model.cache_shapes, max_len)
    out = []
    with torch.no_grad():
        logits, pc = model.prefill(params, dict(stub, tokens=prompts,
                                                length=lengths))
        out.append(logits[:, -1])
        cache = {"bt": torch.from_numpy(bt).to(dev)}
        for name, (dims, dtype) in shapes.items():
            bax, sax = axes[name]
            if sax == -1:
                cache[name] = pc[name]
                continue
            pool = torch.zeros(KV.pool_shape(dims, bax, sax, B * P + 1, ps),
                               dtype=dtype, device=dev)
            KV.scatter_pages(pool, pc[name], bt[:, :rows], bax, sax)
            cache[name] = pool
        del pc
        for i in range(forced.shape[1]):
            logits, cache = model.decode(params, cache, forced[:, i:i + 1],
                                         lengths + i)
            out.append(logits[:, -1])
    return torch.stack(out)                      # (1 + n_dec, B, V)


def compare_forced(torch, dev, label, cfg, params, inputs, tol):
    """Teacher-forced logits of ``cfg`` with the plain impls and with the
    kernel impls on the same params and inputs; returns the worst gap."""
    from repro_torch.models import build_model
    runs = [teacher_forced(torch, dev, build_model(c, dev), params, *inputs)
            for c in (cfg, cfg.for_device(dev))]
    plain, kern = runs
    check(bool(torch.isfinite(kern).all()), f"{label}: non-finite logits")
    d = (kern - plain).abs().amax(dim=(1, 2))
    worst = d.max().item()
    print(f"  teacher-forced {label}: {kern.shape[0]} positions x "
          f"{kern.shape[1]} requests x {kern.shape[2]} logits; max "
          f"|kernel - plain| {worst:.3e} (prefill {d[0].item():.3e}, decode "
          f"max {d[1:].max().item():.3e}; max |logit| "
          f"{plain.abs().max().item():.3f}; tol {tol})")
    check(worst <= tol, f"teacher-forced {label}: {worst} > {tol}")
    return worst


def forced_inputs(torch, dev, cfg, rng):
    """Seeded prompts of 17, 64, 100 and 250 tokens right-padded to 256,
    16 forced tokens each, and the family's encoder input: non-zero frames
    or image embeddings, so that the cross-attention computes something
    (the engine's all-zero stub inputs make it exactly zero)."""
    lens = np.array([17, 64, 100, 250], np.int32)
    B, S = len(lens), 256
    prompts = np.zeros((B, S), np.int32)
    for b, n in enumerate(lens):
        prompts[b, :n] = rng.integers(0, cfg.vocab, size=n)
    forced = rng.integers(0, cfg.vocab, size=(B, 16)).astype(np.int32)
    stub = {}
    if cfg.family == "audio":
        stub["frames"] = rng.standard_normal((B, S, cfg.d_model))
    if cfg.family == "vlm":
        stub["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model))
    to = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    return (to(prompts), to(lens), to(forced),
            {k: to(v.astype(np.float32)) for k, v in stub.items()})


def phase_teacher_forced(torch, dev):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models.quantize import quantize_params_dense
    # f32 everywhere, TF32 off: kernel and plain differ only in the order
    # of f32 sums (and, in the split decode kernels, of the span combine),
    # compounded over the layers; logits are of order 1-10
    tol = 5e-3
    f32 = dict(dtype="float32", param_dtype="float32")
    rng = np.random.default_rng(2)
    diffs = {}
    base = dataclasses.replace(ARCHS["llama3.2-1b"], **f32)
    inputs = forced_inputs(torch, dev, base, rng)
    params = build_model(base, dev).init(SEED)
    diffs["llama3.2-1b fp32"] = compare_forced(
        torch, dev, "llama3.2-1b fp32", base, params, inputs, tol)
    qcfg = dataclasses.replace(base, quantize="int8")
    diffs["llama3.2-1b int8"] = compare_forced(
        torch, dev, "llama3.2-1b int8", qcfg, quantize_params_dense(params),
        inputs, tol)
    del params
    torch.cuda.empty_cache()
    for arch, n_layers in (("whisper-base", None),
                           ("llama-3.2-vision-90b", VISION_TF_LAYERS)):
        cfg = dataclasses.replace(ARCHS[arch], **f32)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        label = f"{arch} ({cfg.n_layers} layers) fp32"
        params = build_model(cfg, dev).init(SEED)
        diffs[label] = compare_forced(torch, dev, label, cfg, params,
                                      forced_inputs(torch, dev, cfg, rng),
                                      tol)
        del params
        torch.cuda.empty_cache()
    return diffs


# ---------------------------------------------------------------------------
# phase 5: the control plane (INFaaS.submit -> Master -> Worker ->
# EngineExecutor -> ServingEngine)

CP_ARCH = "llama3.2-1b"
CP_MAX_NEW = 32            # one budget per payload query
CP_CALIBRATION = (1, 8, 1, 8)   # synthetic query sizes, per variant


def served_tokens(torch, ex, variant, prompts, max_new):
    """Tokens of a fresh engine on the served variant's own params, with
    the executor engine's geometry: the oracle of a payload query."""
    from repro_torch.serving.engine import Request, ServingEngine
    exec_eng = ex.engines[variant.name]
    model, params = ex.served_model(variant)
    eng = ServingEngine(model, params, max_batch=exec_eng.max_batch,
                        max_len=exec_eng.max_len,
                        decode_block=exec_eng.decode_block,
                        min_bucket=exec_eng.min_bucket,
                        page_size=exec_eng.page_size,
                        n_pages=exec_eng.n_pages)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                    max_new_tokens=max_new) for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [r.tokens for r in reqs]


def phase_control_plane(torch, dev, card):
    """Payload-carrying queries through the model-less API on a one-worker
    H100 cluster at full width: the h100-1 bf16 and int8 variants by name,
    and a use-case query whose SLO rules out every cpu-host variant by
    the analytic profile. Each result must be ok, served on h100-1, with
    the tokens of a fresh engine on the served variant's params; then
    synthetic queries at two batch sizes re-fit both variants' t(b)."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.api import QueryPayload, QuerySpec
    from repro_torch.core.master import MasterConfig
    from repro_torch.kernels import build
    from repro_torch.serving.executor import EngineExecutorConfig
    from repro_torch.sim.cluster import make_cluster
    cfg = ARCHS[CP_ARCH]
    ecfg = EngineExecutorConfig(max_batch=8, max_len=512, decode_block=16,
                                min_bucket=8, page_size=16)
    t0 = time.perf_counter()
    c = make_cluster(n_accel=1, archs=[cfg], autoscale=False,
                     cfg=MasterConfig(worker_autoscale=False),
                     backend="real", device=dev, engine_cfg=ecfg)
    (ex,) = c.executors
    variants = c.store.registry.variants
    names = {d: f"{CP_ARCH}/h100-1/{d}-b8" for d in ("bf16", "int8")}
    analytic = {n: (variants[n].profile.m, variants[n].profile.c)
                for n in names.values()}
    prompts = [p.tolist() for p, _ in make_stream(cfg.vocab)[:8]]
    n = len(prompts)
    payload = QueryPayload.of(prompts, max_new_tokens=CP_MAX_NEW)
    cpu_best = min(v.profile.latency(n) for v in variants.values()
                   if v.arch == CP_ARCH and v.hardware == "cpu-host")
    h100_best = min(v.profile.latency(n) for v in variants.values()
                    if v.arch == CP_ARCH and v.hardware == "h100-1"
                    and v.profile.max_batch >= n)
    slo = 10 * h100_best
    check(slo < cpu_best, f"use-case SLO {slo} s does not rule out the "
          f"cpu-host variants (best {cpu_best} s)")
    specs = [("variant bf16", QuerySpec.variant(
                  names["bf16"], latency_ms=600_000, payload=payload)),
             ("variant int8", QuerySpec.variant(
                  names["int8"], latency_ms=600_000, payload=payload)),
             ("use case", QuerySpec.usecase(
                  "text-generation", "openwebtext", min_accuracy=0.5,
                  slo=slo, payload=payload))]
    print(f"  cluster: 1 accel worker, {len(variants)} {CP_ARCH} variants; "
          f"use-case SLO {slo * 1e3:.3f} ms (10x the best h100-1 analytic "
          f"t({n}); best cpu-host {cpu_best * 1e3:.1f} ms)")
    build.reset_launch_counts()
    results = []
    for label, spec in specs:
        before = dict(build.launch_counts)
        res = c.api.submit(spec).result(timeout=3600.0)
        check(res.ok, f"control plane {label}: failed={res.failed} "
              f"variant={res.variant!r}")
        got = {k: build.launch_counts[k] - before[k] for k in before}
        results.append((label, res, got))
    for n_inputs in CP_CALIBRATION:
        for name in names.values():
            res = c.api.submit(QuerySpec.variant(
                name, latency_ms=600_000, n_inputs=n_inputs)).result(
                    timeout=3600.0)
            check(res.ok and res.outputs is None,
                  f"calibration query on {name} failed")
    launches = dict(build.launch_counts)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    for vname, eng in ex.engines.items():
        st = eng.stats
        check(st["decode_traces"] == 1
              and st["graph_replays"] == st["decode_steps"] > 0,
              f"{vname}: {st['decode_traces']} captured graphs, "
              f"{st['graph_replays']} replays for {st['decode_steps']} "
              "steps")
    for label, res, got in results:
        v = variants[res.variant]
        check(v.hardware == "h100-1" and res.worker == "worker-accel-0",
              f"{label}: served on {v.hardware} by {res.worker}")
        want = served_tokens(torch, ex, v, prompts, CP_MAX_NEW)
        check(len(res.outputs) == n and all(
            np.array_equal(a, b) for a, b in zip(want, res.outputs)),
            f"{label}: tokens differ from a direct engine on the served "
            f"variant's params")
        for k in ("flash_attention", "fused_paged_decode_attention"):
            check(got[k] > 0, f"{label}: {k} was not launched")
        if v.framework == "torch-int8":
            check(got["int8_matmul"] > 0, f"{label}: int8_matmul was not "
                  "launched on an int8 variant")
        toks = sum(len(o) for o in res.outputs)
        print(f"  {label}: {res.variant} on {res.worker}; latency "
              f"{res.latency:.4f} s = queue {res.queue:.4f} + load "
              f"{res.load:.4f} + compute {res.compute:.4f} s (virtual clock; "
              f"compute measured); {toks} tokens, {toks / res.compute:.1f} "
              f"tok/s; SLO met {res.slo_met}; launches {got}; tokens equal "
              f"to a direct engine on the served params")
    check(any(variants[r.variant].framework == "torch-int8"
              for _, r, _ in results[2:]),
          "use-case selection did not pick an int8 variant")
    for name in names.values():
        p = variants[name].profile
        check(p.source == "measured", f"{name}: profile not re-fit "
              f"({p.source})")
        m0, c0 = analytic[name]
        obs = ", ".join(
            f"b={b}: {' '.join(f'{t * 1e3:.2f}' for t in ts)}"
            for b, ts in sorted(ex.observations[name].items()))
        print(f"  t(b) of {name}: analytic m {m0 * 1e3:.5f} ms, c "
              f"{c0 * 1e3:.4f} ms; measured m {p.m * 1e3:.5f} ms, c "
              f"{p.c * 1e3:.4f} ms (refits {ex.refits.get(name, 0)}; "
              f"service ms by batch size {obs}) on {card}")
    print(f"  phase launches {launches}")
    return dict(launches=launches, wall_s=wall)


# ---------------------------------------------------------------------------
# phase 6: admission under pressure (the staging ring and preemption inside
# the captured step)


def stream_serve(eng, stream, hook=None):
    """Serve the stream on a warm engine open loop, ``hook(eng)`` after
    every step; returns the requests and each one's streamed tokens."""
    from repro_torch.serving.engine import Request
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(stream)]
    for r in reqs:
        eng.submit(r)
    chunks = {r.rid: [] for r in reqs}
    while eng.busy:
        eng.step()
        if hook is not None:
            hook(eng)
        for r, toks, _t in eng.drain_partial_outputs():
            chunks[r.rid].extend(toks)
    eng.drain_completions()
    return reqs, chunks


PRESSURE_COUNTS = ("staged", "inseg_admissions", "preemptions",
                   "preempt_readmits", "pressure_stalls",
                   "prefill_dispatches", "chunk_admits",
                   "decode_dispatches", "decode_steps", "busy_slot_steps",
                   "peak_concurrency")


def check_pressure_serve(eng, label, reqs, chunks, delta, want=None):
    """A pressure serve's invariants: tokens of the right length in the
    vocabulary (and equal to ``want`` where given), streamed chunks that
    concatenate to the tokens, every staged and parked request seated,
    every page free, and a replay of the one graph per decode step."""
    vocab = eng.model.cfg.vocab
    for r in reqs:
        check(r.tokens is not None and len(r.tokens) == r.max_new_tokens
              and bool(((r.tokens >= 0) & (r.tokens < vocab)).all()),
              f"{label}: request {r.rid} returned {r.tokens}")
        check(chunks[r.rid] == [int(x) for x in r.tokens],
              f"{label}: request {r.rid}'s streamed chunks do not "
              f"concatenate to its tokens")
        if want is not None:
            check(np.array_equal(r.tokens, want[r.rid]),
                  f"{label}: request {r.rid}'s tokens differ from the "
                  f"worst-case serve's")
    check(delta["preempt_readmits"] == delta["preemptions"],
          f"{label}: {delta['preemptions']} preemptions, "
          f"{delta['preempt_readmits']} re-admitted")
    check(eng._alloc.n_free == eng.n_pages and eng._alloc.committed == 0
          and not eng._staged and not eng._preempted,
          f"{label}: {eng._alloc.n_free} of {eng.n_pages} pages free after "
          f"the serve")
    st = eng.stats
    check(st["decode_traces"] == 1
          and st["graph_replays"] == st["decode_steps"] > 0,
          f"{label}: {st['decode_traces']} captured graphs, "
          f"{st['graph_replays']} replays for {st['decode_steps']} steps")


def phase_pressure(torch, dev, model, params, stream, card):
    """Phase 6 on phase 3's llama3.2-1b bf16 model, params and stream: a
    worst-case serve with every prompt teacher-forced (the oracle), the
    pressure serve (staging ring, optimistic admission, slack victims,
    streaming, a quarter of the default pool) against it bit for bit and
    against an uncaptured engine with its knobs, a forced preempt and a
    cancel mid-serve, and the prefill variant of the pressure serve,
    whose share of tokens equal to a worst-case prefill serve's is
    printed. Returns the phase's launches."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    geometry = dict(max_batch=8, max_len=512, decode_block=16, page_size=16)
    knobs = dict(stage_slots=PRESSURE_STAGE, admission="optimistic",
                 preempt_policy="slack", n_pages=PRESSURE_PAGES,
                 stream=True)
    lens = [len(p) for p, _ in stream]
    need = max(-(-(len(t) + m - 1) // 16) for t, m in stream)
    launches: dict = {}

    def engine(cls=ServingEngine, **kw):
        eng = cls(model, params, **dict(geometry, **kw))
        eng.warmup(prompt_lens=lens)
        return eng

    def serve(eng, hook=None):
        before = dict(eng.stats)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        reqs, chunks = stream_serve(eng, stream, hook)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        got = dict(build.launch_counts)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        delta = {k: v - before[k] for k, v in eng.stats.items()}
        return reqs, chunks, delta, got, wall

    oracle = engine(chunk_threshold=0)
    want_reqs, _, sa, _, _ = serve(oracle)
    want = [r.tokens for r in want_reqs]
    check(sa["chunk_admits"] == len(stream) and sa["preemptions"] == 0,
          f"oracle serve: {sa}")
    del oracle
    print(f"  oracle: worst-case admission, chunk_threshold 0 (every prompt "
          f"fed through the graphed step), {geometry['max_len'] // 16 * 8} "
          f"pages: {sa['decode_steps']} decode steps in "
          f"{sa['decode_dispatches']} segments")
    eng = engine(chunk_threshold=0, **knobs)
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    rates, first = [], None
    for _ in range(PRESSURE_REPEATS):
        reqs, chunks, d, got, wall = serve(eng)
        check_pressure_serve(eng, "pressure serve", reqs, chunks, d, want)
        check(d["inseg_admissions"] > 0 and d["preemptions"] > 0,
              f"pressure serve: no pressure ran ({d})")
        rates.append(sum(len(r.tokens) for r in reqs) / wall)
        if first is None:
            first = (d, got)
    d, first_launches = first
    st, timing = eng.stats, eng.timing
    seg_ms = timing["decode_s"] / st["decode_dispatches"] * 1e3
    replay_us = timing["replay_s"] / st["graph_replays"] * 1e6
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    q1, med, q3 = statistics.quantiles(rates, n=4)
    counts = {k: d[k] for k in PRESSURE_COUNTS}
    print(f"  pressure serve: {PRESSURE_STAGE} staging slots, optimistic "
          f"admission, slack victims, streaming, {PRESSURE_PAGES} pages "
          f"(the largest request needs {need}), chunk_threshold 0; tokens "
          f"equal the oracle's bit for bit and the streamed chunks "
          f"concatenate to them in each of {PRESSURE_REPEATS} serves")
    print(f"  pressure serve counts (each serve): {counts}")
    print(f"  pressure serve: median {med:.1f} tok/s (quartiles "
          f"{q1:.1f}-{q3:.1f}; each {', '.join(f'{x:.1f}' for x in rates)}),"
          f" mean decode segment {seg_ms:.2f} ms, replay host time "
          f"{replay_us:.1f} us a step, peak memory {peak_gb:.2f} GB "
          f"({resident_gb:.2f} GB allocated as the serves began: the "
          f"weights, the pools and what earlier phases still hold), 1 "
          f"captured step graph, {st['graph_replays']} replays for "
          f"{st['decode_steps']} steps, on {card}")
    uncaptured = engine(uncaptured_engine(), chunk_threshold=0, **knobs)
    reqs, chunks, du, got, wall_u = serve(uncaptured)
    check(all(np.array_equal(r.tokens, w) for r, w in zip(reqs, want)),
          "uncaptured pressure serve: tokens differ from the oracle's")
    check(got == first_launches,
          f"pressure serve: credited launches {first_launches} against the "
          f"uncaptured body's {got}")
    check(all(du[k] == d[k] for k in PRESSURE_COUNTS),
          f"uncaptured pressure serve counts {du} against {d}")
    del uncaptured
    print(f"  uncaptured engine, same knobs: the same tokens, counts and "
          f"launches per wrapper; {sum(len(w) for w in want) / wall_u:.1f} "
          f"tok/s")
    forced = {}

    def hook(e):
        live = [s for s, r in enumerate(e._slot_req) if r is not None
                and 0 < len(e._gen[s]) < r.max_new_tokens]
        if "preempt" not in forced and live:
            forced["preempt"] = e._slot_req[live[0]]
            e.preempt(live[0])
        elif "preempt" in forced and "cancel" not in forced:
            live = [s for s in live if e._slot_req[s] is not forced["preempt"]]
            if live:
                forced["cancel"] = e._slot_req[live[0]]
                e.cancel(live[0])

    reqs, chunks, df, _, _ = serve(eng, hook)
    p, c = forced.get("preempt"), forced.get("cancel")
    check(p is not None and c is not None, f"forced actions ran: {forced}")
    check(np.array_equal(p.tokens, want[p.rid]) and p.preemptions >= 1,
          f"force-preempted request {p.rid}: tokens differ from the oracle's")
    check(c.cancelled and 0 < len(c.tokens) < c.max_new_tokens
          and np.array_equal(c.tokens, want[c.rid][:len(c.tokens)]),
          f"cancelled request {c.rid}: {len(c.tokens)} tokens, not a prefix "
          f"of the oracle's")
    for r in reqs:
        check(chunks[r.rid] == [int(x) for x in r.tokens],
              f"forced serve: request {r.rid}'s chunks")
        if r is not c:
            check(np.array_equal(r.tokens, want[r.rid]),
                  f"forced serve: request {r.rid}'s tokens differ")
    check(eng._alloc.n_free == eng.n_pages and not eng.busy,
          "forced serve: pages left held")
    print(f"  forced preempt of request {p.rid} (its tokens equal the "
          f"oracle's) and cancel of request {c.rid} (its {len(c.tokens)} "
          f"tokens a prefix of the oracle's {len(want[c.rid])}); "
          f"{df['preemptions']} preemptions in that serve")
    del eng
    prefill_eng = engine(**knobs)
    reqs_c, chunks_c, dc, _, _ = serve(prefill_eng)
    check_pressure_serve(prefill_eng, "prefill pressure serve", reqs_c,
                         chunks_c, dc)
    check(dc["prefill_dispatches"] > 0 and dc["preemptions"] > 0,
          f"prefill pressure serve: {dc}")
    del prefill_eng
    ref = engine()
    reqs_d, _, _, _, _ = serve(ref)
    del ref
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(reqs_c, reqs_d))
    print(f"  prefill variant (chunk_threshold None, the pressure knobs): "
          f"counts {{{', '.join(f'{k}: {dc[k]}' for k in PRESSURE_COUNTS)}}}"
          f"; {same} of {len(stream)} requests' tokens equal a worst-case "
          f"prefill serve's (not a gate: a replayed or staged prompt's KV "
          f"comes from the fused decode kernel, a prefilled one's from "
          f"flash prefill, and in bf16 the two differ in their last bits)")
    torch.cuda.empty_cache()
    print(f"  phase launches {launches}")
    return dict(launches=launches, tok_s=med, tok_s_all=rates, seg_ms=seg_ms,
                replay_us=replay_us, peak_gb=peak_gb,
                resident_gb=resident_gb, counts=counts,
                prefill_counts={k: dc[k] for k in PRESSURE_COUNTS},
                prefill_same=same, oracle_steps=sa["decode_steps"])


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
    flash_build = flash_build_report(reports["flash_attention"])
    int8_build = int8_build_report(reports["int8_matmul"])
    decode_build = decode_build_report(reports)

    print(f"  phase 1 took {time.perf_counter() - t_start:.1f} s")

    t0 = time.perf_counter()
    print("phase 2: per-kernel comparisons (bf16, full-width shapes)")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fused = phase_fused_decode(torch, dev, gen)
    # the vision model's self-attention, whisper-base's with slots of
    # several spans, and llama's at max_len 4096
    others = [phase_fused_decode(torch, dev, gen, G=8, D=128),
              phase_fused_decode(torch, dev, gen, G=1, D=64,
                                 pos_list=FUSED_SPAN_POS),
              phase_fused_decode(torch, dev, gen, P=256,
                                 pos_list=FUSED_LONG_POS)]
    fused["other_shapes"] = [{k: o[k] for k in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "host_us")} for o in others]
    fused["max_abs_err"] = max(o["max_abs_err"] for o in [fused, *others])
    kernels = [dict(phase_flash(torch, dev, gen), **flash_build),
               dict(fused, **decode_build),
               dict(phase_int8(torch, dev, gen), **int8_build),
               dict(phase_paged_decode(torch, dev, gen), **decode_build),
               dict(phase_decode(torch, dev, gen), **decode_build)]
    print(f"  phase 2 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("phase 3: main paths (ServingEngine.serve, full width)")
    bf16, int8 = phase_main_path(torch, dev)
    whisper = phase_family(torch, dev, "whisper-base")
    vision = phase_family(torch, dev, "llama-3.2-vision-90b", VISION_LAYERS)
    paths = [bf16, bf16["chunked"], int8, whisper, vision]
    for k in kernels:
        k["launches"] = sum(r["launches"][k["name"]] for r in paths)
    for label, r in (("llama3.2-1b bf16", bf16),
                     (f"llama3.2-1b bf16 chunked ({CHUNK_THRESHOLD})",
                      bf16["chunked"]),
                     ("llama3.2-1b int8", int8), ("whisper-base", whisper),
                     (f"llama-3.2-vision-90b ({VISION_LAYERS} layers)",
                      vision)):
        p = r.get("profile")
        busy = (f"device {p['device_ms']:.1f} / wall {p['wall_ms']:.1f} ms, "
                f"busy share {p['busy_share']:.3f}" if p else "not profiled")
        print(f"  {label}: {r['tok_s']:.1f} tok/s (quartile spread "
              f"{r['spread']:.3f}), decode segment {r['seg_ms']:.2f} ms, "
              f"first-serve prefill {r['prefill_s']:.3f} s, replay "
              f"{r['replay_us']:.1f} us a step (host) against "
              f"{r['step_ms']:.4f} ms a step (device); profiled serve "
              f"{busy}; uncaptured body {r['eager_tok_s']:.1f} tok/s, "
              f"segment {r['eager_seg_ms']:.2f} ms; peak memory "
              f"{r['peak_gb']:.2f} GB on {card}")
    print(f"  phase 3 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("phase 4: teacher-forced logits, kernels vs plain (f32)")
    phase_teacher_forced(torch, dev)
    print(f"  phase 4 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("phase 5: control plane (INFaaS.submit -> Master -> Worker -> "
          "EngineExecutor, full width)")
    cp = phase_control_plane(torch, dev, card)
    for k in kernels:
        k["launches"] += cp["launches"][k["name"]]
    print(f"  phase 5 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("phase 6: admission under pressure (llama3.2-1b bf16, full width: "
          "staging ring, optimistic admission, preemption, streaming)")
    pressure = phase_pressure(torch, dev, *bf16.pop("llama"), card)
    for k in kernels:
        k["launches"] += pressure["launches"][k["name"]]
    print(f"  phase 6 took {time.perf_counter() - t0:.1f} s")
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
