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
   < T and 0, and per-slot device lengths over T = 512 at G = 4 and at
   whisper-base's G = 1 (0, 1, a 64-row tile edge, T, mixed, and
   whisper's prompt-bucket encoder lengths), which must also give the
   fused paged kernel's bits on the same rows; the int8 GEMM at M in {1,
   8, 8 x bucket} and N not a multiple of the tile). zamba2-1.2b's shared
   block adds K = 32 KV heads at G = 1, D = 64 to flash (a grouped and a
   ragged causal prefill, timed), the fused paged decode and the
   contiguous kernel's per-slot form, with the same checks and timings;
   moonshot-v1-16b-a3b adds K = 16, G = 1, D = 128 to the same three (a
   grouped and a ragged causal flash prefill, flash timed at its one
   prompt a dispatch of bucket 512; the fused decode with the write row
   on span edges; the per-slot form, which must give B1's bits).
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
   with its depth cut from 100 to 10 layers (one group of 9 self layers
   and 1 cross layer); zamba2-1.2b at its published size (38 Mamba2
   layers and the shared block after every 6, nothing cut), whose
   contiguous serve must give its paged tokens bit for bit. The engine
   feeds the audio and vlm families all-zero stub encoder inputs, as the
   JAX engine does; xlstm-1.3b at its published size (48 layers: 36
   mLSTM and 12 sLSTM, nothing cut; no attention, so no kernel runs, its
   page size must be inert and its profile shows no wrapper launch); and,
   first, with nothing else on the card, moonshot-v1-16b-a3b at its
   published size (``phase_moe``: 48 layers, 64 routed experts top-6 and
   2 shared, 57.8 GB of bf16 weights) with 4 slots (``MOE_GEOMETRY``: at
   4 rows no decode token is dropped, so idle rows cannot change live
   ones), one prefill dispatch of ``nbatch`` 1 a request, the shares of
   attention, GEMM and routing kernels in its profile, its contiguous
   serve equal to its paged one bit for bit, its peak memory, and, not
   gated, the two layouts at 8 slots. Each
   path serves the stream several times on one
   warm engine; tokens/s is the median,
   with its quartiles as the spread. A profiled serve of each path fails
   unless flash prefill ran its tensor-core body, the int8 GEMM one kernel
   per launch, and bf16 decode the tensor-core decode body (fused, the
   contiguous one on the vision path and the attend-only paged one on the
   whisper path), never an old SIMT bf16 body or a second combine pass.
   Every decode segment is replays of the engine's one CUDA graph of its
   step, and every prefill dispatch a replay of the graph of its
   ``(nbatch, bucket)`` key, all captured at warmup: each engine must
   report one captured step graph and as many replays as decode steps. The launch counts of a profiled
   serve are set to 0 inside the profiled window, and every wrapper's
   launches (those of a captured graph credited once per replay) must
   equal the kernel events the profile holds for it, in one of at most
   five profiles of the serve (the profiler drops a run of kernel
   records now and then at this event rate; each profile's coverage is
   printed). On each path an
   uncaptured engine, whose segments loop the same step body, serves the
   stream once more: its tokens and every wrapper's launches must equal
   the first graphed serve's. On each path a graphed engine and one
   whose prefill runs its body op by op admit the stream in the same
   rounds: after each round every leaf (trash page included) and the
   slot state must be equal bit for bit, over every key the stream uses;
   the prefill ms a dispatch of both, the number of prefill graphs and
   what their captures added to device memory are printed.
   llama3.2-1b bf16 also serves the stream
   with ``chunk_threshold`` 64: every prompt over 64 tokens must be a
   chunked admit, the rest prefilled. Each path prints the host time of a
   replay per step beside the step's device time (replays held back to
   back on idle slots) and the uncaptured serve's tok/s and segment time.
4. **Teacher-forced check**: llama3.2-1b, whisper-base, the vision
   model at 10 layers (one group), zamba2-1.2b at full size and
   moonshot-v1-16b-a3b at full width cut to 4 of 48 layers (its 48 layers
   take 115 GB in f32) in f32, one seeded token stream (and,
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
   re-fit both variants' t(b) = m*b + c, printed beside the analytic fit,
   and the measured c of both variants is printed on its own line.
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

7. **Prefix cache, host swap, contiguous layout**, on phase 3's
   llama3.2-1b bf16 model and params, each on the captured step. The
   shared-prefix serve: 32 requests on 4 seeded templates of 256 tokens
   (suffixes 8-40, 16-64 new tokens, one prompt exactly its template), 8
   slots, ``max_len`` 512, 256 pages, ``chunk_threshold`` 0, served 3
   times with ``prefix_cache`` off and 3 times on, each on a fresh engine
   (an empty cache): the tokens must be equal bit for bit, each prefix-on
   serve must show the same hits, skipped positions and a copy on write,
   and every page must be free or cached after a serve; a fourth serve on
   the last prefix-on engine, over the pages it cached, is printed on its
   own line as the warm repeat; the prefill variant's share of equal
   tokens is printed, not gated. The
   swap serve: phase 6's pressure configuration with ``swap="host"``, 3
   serves, each forcing a preempt of a slot past its prompt feed, which
   must swap out and back in, with phase 6's oracle tokens and as many
   swaps in as out; then the same serve with a budget below one page,
   which must fall back to recompute, with the oracle's tokens. The
   contiguous serve (``page_size=None``) on phase 3's stream,
   5 serves with phase 3's paged tokens bit for bit, and a profiled serve
   whose decode is the contiguous kernel's tensor-core body once a layer a
   step, never the fused paged kernel; whisper-base contiguous against its
   paged serve. Phase 4 adds the contiguous cache's f32 teacher-forced
   logits (llama3.2-1b, whisper-base) against the paged run's.
8. **The wall clock**: a full-width llama3.2-1b
   ``make_cluster(backend="real", clock="wall")`` with two workers, so
   two stepper threads share the card, each holding both variants'
   engines warmed for the stream's buckets, the bf16 variant loaded on
   one worker and the int8 one on the other, the monitor's tick longer
   than the serve (so no instance turns overloaded mid-serve and sends a
   query to a model load); a client thread submits 16 streamed payload queries
   (one prompt of 16-300 tokens, 32 new tokens, alternating variants) as
   seeded Poisson arrivals through ``ServingRuntime``. Every result must
   be ok with no wait on a model load, its streamed concat equal to its
   outputs and its tokens to a
   direct engine's on the served variant's params (prefilled at the
   batch size the served dispatch had); both steppers must have served;
   no graph may be captured during the serve; ``shutdown(drain=True)``
   must return True with every stepper joined. Prints TTFT and
   completion p50/p99 and q/s. Then a one-worker cluster with the
   ``stepper`` fault site scheduled mid-decode: the query is retried to
   a direct engine's tokens, one restart, the rebuilt engine captures
   anew and the dropped engine's device memory is released; and a 1 ms
   SLO under ``deadline_enforce`` comes back ``timed_out``.
9. **Speculative decoding**, llama3.2-1b at full width on phase 3's
   params and stream (``phase_spec``): five serves, each against a plain
   graphed serve of the same target config, whose attention is plain
   PyTorch (``for_device(dev, speculate=True)``; the draft runs every
   kernel): (a) an int8 draft, k = 4, paged; (b) the same contiguous; (c)
   an int8 target with its own int8 draft, k = 3; (d) an independent
   draft (seed 99), k = 4: rollback every round; (e) (a) in f32. Checks:
   the propose, verify and resync graphs equal their bodies bit for bit
   on the same inputs; (a) equals an uncaptured engine's tokens, counts
   and launches; every request emits its budget; paged serves drain the
   pool; the draft's flash, contiguous decode and int8 launches ran.
   Tokens: a request equals the plain serve's, or its first difference is
   a near tie of the plain target (its margin there, teacher-forced at
   the plain serve's prefill batch, at most twice the measured window and
   prefill-shape gaps). Prints the equal counts, tok/s against the plain
   serve and phase 3's kernel path, acceptance, rounds, resyncs and ms a
   round.
10. **The hybrid engine under pressure, and hybrid speculation**:
   zamba2-1.2b at full width in phase 6's pressure configuration, its
   tokens equal to a worst-case serve's bit for bit (the in-graph state
   reset of ring refills and the reset of recovery seats) and its counts
   the CPU rehearsal's; then a reduced zamba2 target (f32) with a reduced
   dense draft, paged and contiguous, equal to the plain serve's tokens
   (no dense config shares zamba2-1.2b's vocabulary at full width).
11. **The ssm engine's state rows** (``phase_ssm_rows``): xlstm-1.3b at
   full width on a 12-request stream (``rows_stream``: prompts of 16-160
   tokens straddling a threshold of 64), 4 staging slots: the graphed serve equal to the uncaptured body's bit
   for bit; with every prompt fed (``chunk_threshold=0``), a forced
   ``preempt()`` recovering to the uninterrupted serve's tokens; every
   serve's counts the CPU rehearsal's (``SSM_ROWS_PREDICTED``); the
   engine's reset rows equal to the cells' zero-token states (-1e30
   stabilizers, the 1e-6 normalizer) exactly; a request the graph
   refilled into a used slot, and the preempted one, equal to each served
   alone from a fresh empty state bit for bit; and in f32 at 4 layers,
   the prompt fed from the empty state against the recurrent prefill,
   logits and every state leaf within 1e-3 of the leaf's scale.

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
# phase 3's engine geometry
GEOMETRY = dict(max_batch=8, max_len=512, decode_block=16, page_size=16)
# Timed serves of the stream per path. The serve is host-bound and the
# host's cores are shared, so one serve's tok/s varies by tens of percent
# while its device time does not; the median of many serves is reported.
# The larger models serve fewer times to keep the run inside its limit;
# with phases 9 and 10 added, every count below was cut (llama 15 -> 5,
# whisper 9 -> 3, vision 5 -> 3, chunked 3 -> 2, phase 6 3 -> 2, phase
# 7's prefix 3 -> 2, swap 3 -> 2, contiguous 5 -> 2), and the vision
# path's depth 20 -> 10 layers; with phase 11 and the moe and ssm paths
# added, llama 5 -> 3, whisper 3 -> 2 and vision 3 -> 2.
SERVE_REPEATS = {"llama3.2-1b": 3, "whisper-base": 2,
                 "llama-3.2-vision-90b": 2, "zamba2-1.2b": 2,
                 "xlstm-1.3b": 2, "moonshot-v1-16b-a3b": 2}
CHUNK_THRESHOLD = 64        # the chunked llama serve's threshold
CHUNKED_REPEATS = 2
# phase 6: the pressure serve's pool (a quarter of the default 8 x 512 / 16
# = 256 pages), staging ring and number of timed serves
PRESSURE_PAGES = 64
PRESSURE_STAGE = 4
PRESSURE_REPEATS = 2
VISION_LAYERS = 10          # serve depth of llama-3.2-vision-90b (of 100)
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
        # zamba2-1.2b's shared block: K = 32 KV heads, G = 1, D = 64,
        # causal, at a grouped bucket and a ragged one
        ("zamba2 K=32 G=1 bucket 256", 8, 256, 256, 32, 1, 64, True, 0,
         None),
        ("zamba2 K=32 G=1 ragged S=T=300", 1, 300, 300, 32, 1, 64, True, 0,
         None),
        # moonshot-v1-16b-a3b: K = 16 KV heads, G = 1, D = 128, causal
        ("moonshot K=16 G=1 D=128 bucket 256", 2, 256, 256, 16, 1, 128,
         True, 0, None),
        ("moonshot K=16 G=1 D=128 ragged S=T=300", 1, 300, 300, 16, 1, 128,
         True, 0, None),
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
             time_flash(torch, gen, dev, 8, 256, 1601, 8, 8, 128, False),
             time_flash(torch, gen, dev, 8, 256, 256, 32, 1, 64, True),
             # moonshot's prefill: one prompt a dispatch, bucket 512
             time_flash(torch, gen, dev, 1, 512, 512, 16, 1, 128, True)]
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
    # per-slot lengths: llama3.2-1b's contiguous self-attention (G = 4),
    # whisper-base's contiguous self- and cross-attention (G = 1)
    per_slot = [phase_decode_per_slot(torch, dev, gen),
                phase_decode_per_slot(torch, dev, gen, G=1,
                                      lens_lists=PER_SLOT_LENS + [ENC_LENS]),
                # zamba2-1.2b's contiguous shared block: K = 32, G = 1
                phase_decode_per_slot(torch, dev, gen, K=32, G=1),
                # moonshot-v1-16b-a3b's contiguous layout: K = 16, G = 1,
                # D = 128
                phase_decode_per_slot(torch, dev, gen, K=16, G=1, D=128)]
    worst = max([worst] + [p.pop("max_abs_err") for p in per_slot])
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:109",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, host_us=h_us, shape=shape,
                other_shapes=per_slot)


# per-slot lengths of the contiguous kernel: nothing to attend, one row, a
# 64-row tile edge, all T = 512 rows, and mixed; then phase 2's fused
# decode positions (+ 1), to hold the kernel to the fused paged kernel's
# bits on the same rows and time the two side by side
PER_SLOT_LENS = [[0, 1, 64, 512, 65, 128, 300, 511],
                 [512] * 8, [1] * 8, [p + 1 for p in FUSED_POS]]
# whisper-base's contiguous cross-attention lengths: each slot's enc_len is
# its admission's prompt bucket (16 to 512 rows of T = max_len = 512), 0 in
# a slot never admitted
ENC_LENS = [16, 32, 64, 128, 256, 512, 0, 256]


def phase_decode_per_slot(torch, dev, gen, B=8, K=8, G=4, D=64, ps=16,
                          P=32, lens_lists=PER_SLOT_LENS):
    """The contiguous kernel's per-slot form ((B,) device lengths, the
    fused kernel's span plan) over T = max_len = 512 rows, at llama3.2-1b's
    G = 4 (the contiguous layout's self-attention) or whisper-base's G = 1
    (its contiguous self- and cross-attention): against its plain version
    (bf16 tolerance and the f32 ulp rule), two calls the same bits, zeros
    at length 0, and the fused paged kernel's output bits on the same rows
    behind an identity block table; timed beside the fused kernel on those
    rows."""
    from repro_torch.kernels.decode_attention import (
        contiguous_plan, decode_attention, decode_attention_plain,
        fused_paged_decode_attention)
    tol = 3e-2
    T = P * ps
    q = torch.randn((B, K, G, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    kp = torch.zeros((B * P + 1, ps, K, D), dtype=k.dtype, device=dev)
    vp = torch.zeros_like(kp)
    kp[:B * P] = k.reshape(B * P, ps, K, D)
    vp[:B * P] = v.reshape(B * P, ps, K, D)
    bt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    rows = torch.arange(B, device=dev)
    worst = 0.0
    for lens_list in lens_lists:
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        out = decode_attention(q, k, v, lens)
        again = decode_attention(q, k, v, lens)
        want = decode_attention_plain(q, k, v, lens)
        want32 = decode_attention_plain(q.float(), k.float(), v.float(),
                                        lens)
        pos = (lens - 1).clamp(min=0)
        kn = k[rows, pos.long()].contiguous()
        vn = v[rows, pos.long()].contiguous()
        paged, _, _ = fused_paged_decode_attention(q, kn, vn, kp, vp, bt,
                                                   pos)
        torch.cuda.synchronize()
        live = lens > 0
        err = (out[live].float() - want[live].float()).abs().max().item()
        what = f"decode_attention per slot G={G} {lens_list}"
        check(err <= tol, f"{what}: {err}")
        check(torch.equal(out, again), f"{what}: two calls differ")
        check(not out[~live].any(), f"{what}: length 0 not zeros")
        check_f32_ulps(torch, out[live], want32[live], what)
        check(torch.equal(out[live], paged[live]),
              f"{what}: bits differ from the fused paged kernel's on the "
              f"same rows")
        worst = max(worst, err)
    _, _, n_split, split = contiguous_plan(q, T, lens, "mma")
    print(f"  decode_attention per slot, B={B} K={K} G={G} D={D} T={T}: "
          f"{n_split} spans of {split} rows (the fused kernel's plan); "
          f"{len(lens_lists)} length lists; max_abs_err {worst:.3e} (tol "
          f"{tol}); the same bits as the fused paged kernel on the same "
          f"rows at every length")
    lens = torch.tensor(PER_SLOT_LENS[-1], dtype=torch.int32, device=dev)
    pos = lens - 1
    kn, vn = k[rows, pos.long()].contiguous(), v[rows, pos.long()].contiguous()
    ms = cuda_ms(lambda: decode_attention(q, k, v, lens))
    h_us = host_us(lambda: decode_attention(q, k, v, lens))
    fused_ms = cuda_ms(lambda: fused_paged_decode_attention(
        q, kn, vn, kp, vp, bt, pos))
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, k, v, lens))
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None].long())
    qh = q.reshape(B, K * G, 1, D)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask[:, None, None],
                                  enable_gqa=True))
    n_rows = int(lens.sum())
    n_bytes = 2 * (2 * n_rows * K * D + 2 * q.numel()) + 4 * B
    n_flops = 4 * K * G * D * n_rows
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)
    shape = f"B={B} K={K} G={G} D={D} T={T}, per-slot lengths {lens.tolist()}"
    print(f"  decode_attention per slot {shape} bf16: {ms:.4f} ms (fused "
          f"paged on the same rows {fused_ms:.4f}, plain {plain_ms:.4f}, "
          f"SDPA with a mask {lib_ms:.4f}, bound {b_ms:.5f} by {b_by}); "
          f"host {h_us:.1f} us a call")
    return dict(shape=shape, ms=ms, fused_ms=fused_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                host_us=h_us, max_abs_err=worst)


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
    """The engine class whose decode segments run the plain loop of its
    step body, whose prefill dispatches run their body op by op and whose
    speculative programs (propose, verify, resync) run their bodies, on the
    card, captured nowhere: the oracle of the graph replays (not a knob of
    the engine; only these comparisons run the bodies uncaptured)."""
    import torch

    class Uncaptured(eager_prefill_engine()):
        def _capture(self):
            pass

        def _run_steps(self, n_steps):
            with torch.no_grad():
                for _ in range(n_steps):
                    self._step_body()

        def _capture_spec(self, prog):
            pass

        def _run_spec(self, prog):
            with torch.no_grad():
                prog.body()

    return Uncaptured


def eager_prefill_engine():
    """The engine class whose prefill dispatches run their body op by op
    (the decode step stays captured): the oracle of the prefill graphs."""
    import torch
    from repro_torch.serving.engine import ServingEngine

    class EagerPrefill(ServingEngine):
        def _capture_prefill(self, prog):
            pass

        def _run_prefill(self, prog):
            with torch.no_grad():
                self._prefill_body(prog)

    return EagerPrefill


def check_prefill_graphs(torch, dev, model, params, stream, label, card,
                         geometry=None):
    """Graphed prefill against its eager body on the card: a graphed engine
    and an eager-prefill one (phase 3's geometry) admit the stream in the
    same rounds; after each round every leaf (trash page included),
    ``tok``, ``pos``, ``rem`` and ``plen`` must be equal bit for bit, and
    so must the first tokens. Every key the stream's dispatches use is
    checked this way. Prints the prefill ms a dispatch, eager against
    graphed, the number of prefill graphs and what their capture added to
    device memory. ``geometry`` overrides phase 3's engine geometry.
    The graphed engine comes back under ``"engine"``, warm, for the path's
    timed and profiled serves (one capture of each program a path)."""
    from repro_torch.serving.engine import Request, ServingEngine
    geometry = dict(GEOMETRY, **(geometry or {}))
    lens = [len(p) for p, _ in stream]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    alloc0 = torch.cuda.memory_allocated(dev)
    res0 = torch.cuda.memory_reserved(dev)
    graphed = ServingEngine(model, params, **geometry)
    pools = torch.cuda.memory_allocated(dev) - alloc0
    t0 = time.perf_counter()
    graphed.warmup(prompt_lens=lens)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - alloc0 - pools
    reserved = torch.cuda.memory_reserved(dev) - res0 - pools
    n_graphs = len(graphed._prefill_fns)
    check(n_graphs == graphed.stats["prefill_traces"] and all(
        p.graph is not None for p in graphed._prefill_fns.values()),
        f"{label}: {n_graphs} prefill programs, "
        f"{graphed.stats['prefill_traces']} traces, not all captured")
    eager = eager_prefill_engine()(model, params, **geometry)
    eager.warmup(prompt_lens=lens)
    engs = (graphed, eager)
    used = set()
    run = graphed._run_prefill

    def counted(prog):
        used.add((prog.nb, prog.bucket))
        run(prog)

    graphed._run_prefill = counted
    reqs = [[Request(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(stream)] for _ in engs]
    for eng, rs in zip(engs, reqs):
        for r in rs:
            eng.submit(r)
    rounds = 0
    while any(e.busy for e in engs):
        n0 = graphed.stats["prefill_dispatches"]
        for eng in engs:
            eng._admit_pending()
        torch.cuda.synchronize(dev)
        if graphed.stats["prefill_dispatches"] > n0:
            rounds += 1
            for name in graphed._cache:
                check(torch.equal(graphed._cache[name], eager._cache[name]),
                      f"{label}: prefill graphs wrote leaf {name} unlike "
                      f"the eager body")
            for t in ("_tok", "_pos", "_rem_dev", "_plen_dev"):
                check(torch.equal(getattr(graphed, t), getattr(eager, t)),
                      f"{label}: prefill graphs wrote {t} unlike the eager "
                      f"body")
            check(graphed._gen == eager._gen, f"{label}: prefill graphs' "
                  f"first tokens differ from the eager body's")
        for eng in engs:
            eng.step()
    check(all(np.array_equal(a.tokens, b.tokens) for a, b in zip(*reqs)),
          f"{label}: tokens after graphed prefill differ from the eager "
          f"body's")
    sg, se = graphed.stats, eager.stats
    check(sg["prefill_replays"] == sg["prefill_dispatches"]
          == se["prefill_dispatches"] > 0 and se["prefill_replays"] == 0,
          f"{label}: {sg['prefill_replays']} prefill replays for "
          f"{sg['prefill_dispatches']} dispatches")
    ms_g = graphed.timing["prefill_s"] / sg["prefill_dispatches"] * 1e3
    ms_e = eager.timing["prefill_s"] / se["prefill_dispatches"] * 1e3
    print(f"  {label} prefill graphs: {n_graphs} graphs (keys "
          f"{sorted(graphed._prefill_fns)}), captured in {warm_s:.2f} s "
          f"with the decode graph; the captures' peak {peak / 1e9:.3f} GB "
          f"allocated, {reserved / 1e9:.3f} GB reserved beyond the "
          f"pools ({pools / 1e9:.3f} GB); {sg['prefill_dispatches']} "
          f"dispatches in {rounds} rounds over keys {sorted(used)}, every "
          f"leaf and the slot state equal to the eager body's bit for bit "
          f"after each round; prefill {ms_g:.3f} ms a dispatch graphed "
          f"against {ms_e:.3f} eager (host time, ending in the firsts' "
          f"read) on {card}")
    graphed._run_prefill = run
    del eager
    torch.cuda.empty_cache()
    return dict(engine=graphed, graphs=n_graphs, keys=sorted(used), ms=ms_g,
                eager_ms=ms_e,
                peak_gb=peak / 1e9, reserved_gb=reserved / 1e9)


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
                  chunk_threshold=None, geometry=None, eng=None):
    """Serve the stream ``repeats`` times on one warm engine, whose decode
    segments are replays of its one captured step graph, then once on an
    uncaptured engine that loops the same step body: the tokens and every
    wrapper's launches of that serve must equal the first graphed
    serve's. ``geometry`` overrides phase 3's engine geometry; ``eng`` is
    a warm graphed engine of that geometry to serve on (``check_prefill_
    graphs``'), else one is built."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Request, ServingEngine
    geometry = dict(GEOMETRY, chunk_threshold=chunk_threshold,
                    **(geometry or {}))
    if eng is None:
        eng = ServingEngine(model, params, **geometry)
    eng.warmup(prompt_lens=[len(p) for p, _ in stream])
    check(eng.stats["decode_traces"] == 1,
          f"{label}: warmup captured {eng.stats['decode_traces']} graphs")
    stats0, timing0 = dict(eng.stats), dict(eng.timing)
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
            first = ({k: v - stats0[k] for k, v in eng.stats.items()},
                     {k: v - timing0[k] for k, v in eng.timing.items()},
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
          and oracle.stats["graph_replays"] == 0
          and oracle.stats["prefill_replays"] == 0,
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
                served=first_tokens,
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


# profiles of one serve, at most, of which one must hold every wrapper
# launch: the profiler drops a run of kernel records now and then at
# these event rates (a run of 1 to hundreds of records, other kernels'
# too, with the same launches; NVIDIA H100 80GB HBM3, 700 W), in 5 of
# 27 profiles before this bound was raised from 3
PROFILE_ATTEMPTS = 5


def profile_serve(torch, dev, eng, stream, label):
    """Serve ``stream`` on the warm engine ``eng`` under ``torch.profiler``
    until one profile holds, for every wrapper, as many kernel events as
    the wrapper's launches in that serve (those of a captured graph
    credited once per replay), at most ``PROFILE_ATTEMPTS`` times. Every
    serve must be replays of the engine's one step graph. Returns that
    profile's device time (us) and count by kernel name, the serve's
    launches, decode steps and host wall time (us), and the launches of
    every attempt summed."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Request, capture_graph
    total = {}
    # a one-kernel graph, replayed inside each profiled window before the
    # serve (see below)
    warm = torch.ones(1, device=dev)
    warm.add_(1)
    warm_graph, _ = capture_graph(dev, lambda: warm.add_(1))
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        steps0 = eng.stats["decode_steps"]
        reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(stream)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # one kernel and a sync before the timed serve: a profiled
            # serve (NVIDIA H100 80GB HBM3, 700 W) once missed two layers'
            # kernels of a prefill dispatch, all launched early in the
            # serve, and failed the int8 launch-count check. The counts
            # are set to 0 here, inside the profiled window, so that they
            # and the profile cover the same launches. Graph replays come
            # first too: moonshot's profiled serve (its prefill and decode
            # all graph replays) missed one flash record of 384 in each of
            # five profiles after one kernel alone (NVIDIA H100 80GB HBM3,
            # 700 W), early in the serve as far as can be seen.
            for _ in range(4):
                warm_graph.replay()
                warm.add_(1)
            torch.cuda.synchronize(dev)
            time.sleep(0.05)
            build.reset_launch_counts()
            t0 = time.perf_counter()
            eng.serve(reqs)
            torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        launched = dict(build.launch_counts)
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n
        st = eng.stats
        steps = st["decode_steps"] - steps0
        check(st["decode_traces"] == 1
              and st["graph_replays"] == st["decode_steps"] > 0,
              f"{label}: profiled serve with {st['decode_traces']} captured "
              f"graphs, {st['graph_replays']} replays for "
              f"{st['decode_steps']} steps")
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = e.time_range.end - e.time_range.start
                tot, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (tot + us, n + 1)
        # every wrapper's launches against the kernel events the profile
        # holds for it
        events = dict.fromkeys(launched, 0)
        for name, (_us, n) in by_name.items():
            wrapper = wrapper_of(name)
            if wrapper is not None:
                events[wrapper] += n
        n_events = sum(n for _, n in by_name.values())
        print(f"  {label} profile coverage (attempt {attempt}): "
              f"{sum(launched.values())} wrapper launches, "
              f"{sum(events.values())} profiled kernel events of theirs, "
              f"{n_events} device events in all; per wrapper "
              + ", ".join(f"{w} {launched[w]}/{events[w]}"
                          for w in sorted(events)))
        if events == launched:
            return dict(by_name=by_name, launches=launched, steps=steps,
                        wall_us=wall_us, total=total)
    raise RuntimeError(
        f"check failed: {label}: wrapper launches {launched} against "
        f"profiled kernel events {events} in {PROFILE_ATTEMPTS} profiles")


def profile_variant(torch, dev, model, params, stream, label,
                    contiguous_decode=False, paged_decode=False,
                    kernels=True, geometry=None, eng=None, n_reqs=8):
    """Where the time goes: ``torch.profiler`` over a short serve of the
    stream's first 8 requests (``profile_serve``). Prints the device's
    busy share (summed device kernel time over host wall time, profiler
    on) and the kernels with the most device time. Checks which bodies
    the kernels ran: the decode lines must show the fused kernel's
    tensor-core body (and, with ``contiguous_decode``, the contiguous
    kernel's; with ``paged_decode``, the attend-only paged kernel's) and
    no old bf16 decode body. With ``kernels`` false (a path that runs no
    kernel: xlstm) only the busy share and the top kernels are printed.
    Returns the device and wall times and the profile's device time by
    kernel name. ``eng`` is a warm graphed engine to profile on, else one
    is built; the serve is of the stream's first ``n_reqs`` requests."""
    from repro_torch.serving.engine import ServingEngine
    if eng is None:
        eng = ServingEngine(model, params,
                            **dict(GEOMETRY, **(geometry or {})))
    eng.warmup(prompt_lens=[len(p) for p, _ in stream[:n_reqs]])
    check(eng.stats["decode_traces"] == 1,
          f"{label}: warmup captured {eng.stats['decode_traces']} graphs")
    prof = profile_serve(torch, dev, eng, stream[:n_reqs], label)
    by_name, launched = prof["by_name"], prof["launches"]
    steps, wall_us = prof["steps"], prof["wall_us"]
    busy_us = sum(t for t, _ in by_name.values())
    print(f"  {label} profile ({n_reqs} reqs, {steps} decode "
          f"steps, all graph replays): wall {wall_us / 1e3:.1f} ms, device "
          f"kernel time "
          f"{busy_us / 1e3:.1f} ms, device busy share "
          f"{busy_us / wall_us:.3f}, idle share {1 - busy_us / wall_us:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, n) in top:
        print(f"    {us / 1e3:9.2f} ms {n:6d} calls  {name[:90]}")
    out = dict(device_ms=busy_us / 1e3, wall_ms=wall_us / 1e3,
               busy_share=busy_us / wall_us, by_name=by_name, steps=steps,
               launches=launched)
    if not kernels:
        check(not any(n for n in launched.values()),
              f"{label}: kernel launches {launched} on a path with none")
        return out
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
    check(calls == launched["int8_matmul"]
          and not any("splitk_reduce" in name for name in by_name),
          f"{label}: {calls} int8 kernels in the profile for "
          f"{launched['int8_matmul']} wrapper launches")
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
    return dict(out, int8_ms=sum(us for us, _ in int8.values()) / 1e3,
                decode_ms=sum(us for us, _ in dec.values()) / 1e3)


def phase_main_path(torch, dev, card):
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
    pf = check_prefill_graphs(torch, dev, model, params, stream,
                              "bf16 variant", card)
    eng = pf.pop("engine")
    bf16 = serve_variant(torch, dev, model, params, stream, "bf16 variant",
                         reps, eng=eng)
    bf16["prefill"] = pf
    bf16["profile"] = profile_variant(torch, dev, model, params, stream,
                                      "bf16 variant", eng=eng)
    del eng
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
    # phases 6 and 7 serve the bf16 model again; main frees the params
    # after them
    bf16["llama"] = (model, params, stream)
    qmodel = build_model(qcfg, dev)
    pf = check_prefill_graphs(torch, dev, qmodel, qparams, stream,
                              "int8 variant", card)
    eng = pf.pop("engine")
    int8 = serve_variant(torch, dev, qmodel, qparams, stream, "int8 variant",
                         reps, eng=eng)
    int8["prefill"] = pf
    int8["profile"] = profile_variant(torch, dev, qmodel, qparams, stream,
                                      "int8 variant", eng=eng)
    del eng
    del qparams
    torch.cuda.empty_cache()
    for name in ("flash_attention", "fused_paged_decode_attention"):
        check(bf16["launches"][name] > 0 and int8["launches"][name] > 0
              and chunked["launches"][name] > 0,
              f"{name} was not launched on the main path")
    check(int8["launches"]["int8_matmul"] > 0,
          "int8_matmul was not launched on the int8 variant")
    return bf16, int8


def phase_family(torch, dev, arch, card, n_layers=None):
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
    pf = check_prefill_graphs(torch, dev, model, params, stream, arch, card)
    eng = pf.pop("engine")
    res = serve_variant(torch, dev, model, params, stream, arch,
                        SERVE_REPEATS[arch], eng=eng)
    res["prefill"] = pf
    res["profile"] = profile_variant(
        torch, dev, model, params, stream, arch,
        contiguous_decode=cfg.family == "vlm",
        paged_decode=cfg.family == "audio", eng=eng)
    del params, eng
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
                   stub, ps=16, max_len=512, contiguous=False):
    """Logits at each request's last prompt position and at every forced
    decode position, through ``model.prefill`` and ``model.decode``.

    Every cache leaf with a sequence axis becomes a page pool (with the
    kernel layout's trash page) filled through an identity block table,
    or, with ``contiguous``, a (.., B, max_len, ..) leaf of the contiguous
    layout (no block table) holding the prompt's rows; per-slot leaves
    pass as they are. ``stub`` holds the family's encoder input, if any."""
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
        cache = {} if contiguous else {"bt": torch.from_numpy(bt).to(dev)}
        for name, (dims, dtype) in shapes.items():
            bax, sax = axes[name]
            if sax == -1:
                cache[name] = pc[name]
                continue
            if contiguous:
                leaf = torch.zeros(dims, dtype=dtype, device=dev)
                leaf.narrow(sax, 0, pc[name].shape[sax]).copy_(pc[name])
                cache[name] = leaf
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


def compare_forced(torch, dev, label, cfg, params, inputs, tol,
                   contiguous=False):
    """Teacher-forced logits of ``cfg`` with the plain impls and with the
    kernel impls on the same params and inputs; returns the worst gap.
    With ``contiguous``, the kernel impls also decode over the contiguous
    layout's cache (the contiguous kernel's per-slot form), which must
    match the paged kernel run within ``tol`` too."""
    from repro_torch.models import build_model
    runs = [teacher_forced(torch, dev, build_model(c, dev), params, *inputs)
            for c in (cfg, cfg.for_device(dev))]
    plain, kern = runs
    if contiguous:
        kcfg = cfg.for_device(dev)
        cont = teacher_forced(torch, dev, build_model(kcfg, dev), params,
                              *inputs, contiguous=True)
        check(bool(torch.isfinite(cont).all()),
              f"{label} contiguous: non-finite logits")
        dc = (cont - kern).abs().max().item()
        print(f"  teacher-forced {label}, contiguous cache (kernel impls) "
              f"against the paged kernel run: max |diff| {dc:.3e} (tol "
              f"{tol})")
        check(dc <= tol, f"teacher-forced {label} contiguous: {dc} > {tol}")
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
        torch, dev, "llama3.2-1b fp32", base, params, inputs, tol,
        contiguous=True)
    qcfg = dataclasses.replace(base, quantize="int8")
    diffs["llama3.2-1b int8"] = compare_forced(
        torch, dev, "llama3.2-1b int8", qcfg, quantize_params_dense(params),
        inputs, tol)
    del params
    torch.cuda.empty_cache()
    for arch, n_layers in (("whisper-base", None),
                           ("llama-3.2-vision-90b", VISION_TF_LAYERS),
                           (HYBRID_ARCH, None),
                           (MOE_ARCH, MOE_TF_LAYERS)):
        cfg = dataclasses.replace(ARCHS[arch], **f32)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        label = f"{arch} ({cfg.n_layers} layers) fp32"
        params = build_model(cfg, dev).init(SEED)
        diffs[label] = compare_forced(torch, dev, label, cfg, params,
                                      forced_inputs(torch, dev, cfg, rng),
                                      tol, contiguous=arch in (
                                          "whisper-base", HYBRID_ARCH,
                                          MOE_ARCH))
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
    print("  measured c (the t(b) intercept, prefill graphed): "
          + ", ".join(f"{name} {variants[name].profile.c * 1e3:.3f} ms"
                      for name in names.values()) + f" on {card}")
    print(f"  phase launches {launches}")
    return dict(launches=launches, wall_s=wall,
                c_ms={d: variants[n].profile.c * 1e3
                      for d, n in names.items()})


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
                replay_us=replay_us, peak_gb=peak_gb, oracle=want,
                pressure_steps=d["decode_steps"],
                resident_gb=resident_gb, counts=counts,
                prefill_counts={k: dc[k] for k in PRESSURE_COUNTS},
                prefill_same=same, oracle_steps=sa["decode_steps"])


# ---------------------------------------------------------------------------
# phase 7: the prefix cache, host swap and the contiguous layout, each on
# the captured decode step

PREFIX_TEMPLATES = 4        # seeded templates (system prompts' stand-ins)
PREFIX_TEMPLATE_LEN = 256   # 16 pages of 16
PREFIX_REQS = 32
PREFIX_FULL_HIT = 12        # the request whose prompt is its template alone
PREFIX_REPEATS = 2
SWAP_REPEATS = 2
CONTIGUOUS_REPEATS = 2


def make_prefix_stream(vocab: int, seed: int = 7):
    """32 requests on 4 seeded templates of 256 tokens (request i opens
    with template i % 4), suffixes of 8-40 tokens, 16-64 new tokens;
    request ``PREFIX_FULL_HIT``'s prompt is its template alone, a hit on
    every page that must copy the last one on write. Lengths come from a
    generator of their own, so that a reduced vocabulary (a CPU run at
    reduced width) gives the same lengths."""
    lens = np.random.default_rng(seed)
    toks = np.random.default_rng(seed + 1)
    tpls = [toks.integers(0, vocab, size=PREFIX_TEMPLATE_LEN)
            for _ in range(PREFIX_TEMPLATES)]
    out = []
    for i in range(PREFIX_REQS):
        n_sfx, new = int(lens.integers(8, 41)), int(lens.integers(16, 65))
        sfx = toks.integers(0, vocab, size=n_sfx)
        tpl = tpls[i % PREFIX_TEMPLATES]
        prompt = tpl if i == PREFIX_FULL_HIT else np.concatenate([tpl, sfx])
        out.append((prompt.astype(np.int32), new))
    return out


def repeat_serves(torch, dev, eng, stream, repeats, label, hook=None,
                  launches=None):
    """``repeats`` serves of the stream on one warm engine (``stream_serve``
    with ``hook``); each one's tokens, stats and timing deltas, tok/s and
    launches (added into ``launches``). Checks every serve's tokens for
    length and vocabulary, one captured graph and a replay a decode step,
    and the pool drained (free or cached)."""
    from repro_torch.kernels import build
    vocab = eng.model.cfg.vocab
    out = []
    for _ in range(repeats):
        before, before_t = dict(eng.stats), dict(eng.timing)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        reqs, _ = stream_serve(eng, stream, hook)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        got = dict(build.launch_counts)
        if launches is not None:
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
        for r in reqs:
            check(r.tokens is not None and len(r.tokens) == r.max_new_tokens
                  and bool(((r.tokens >= 0) & (r.tokens < vocab)).all()),
                  f"{label}: request {r.rid} returned {r.tokens}")
        st = eng.stats
        check(st["decode_traces"] == 1
              and st["graph_replays"] == st["decode_steps"] > 0,
              f"{label}: {st['decode_traces']} captured graphs, "
              f"{st['graph_replays']} replays for {st['decode_steps']} steps")
        if eng._alloc is not None:
            check(eng._alloc.n_free + eng._alloc.n_cached == eng.n_pages
                  and eng._alloc.committed == 0 and not eng.busy,
                  f"{label}: {eng._alloc.n_free} free + "
                  f"{eng._alloc.n_cached} cached of {eng.n_pages} pages "
                  f"after a serve")
        delta = {k: v - before[k] for k, v in st.items()}
        timing = {k: v - before_t[k] for k, v in eng.timing.items()}
        toks = sum(len(r.tokens) for r in reqs)
        out.append(dict(tokens=[r.tokens for r in reqs], delta=delta,
                        timing=timing, tok_s=toks / wall, launches=got))
    return out


def summary(runs):
    """(text, median tok/s, mean segment ms) of serves of one workload."""
    rates = [r["tok_s"] for r in runs]
    q1, med, q3 = statistics.quantiles(rates, n=4) if len(rates) > 1 \
        else (rates[0],) * 3
    segs = sum(r["delta"]["decode_dispatches"] for r in runs)
    decode_s = sum(r["timing"]["decode_s"] for r in runs)
    seg_ms = decode_s / segs * 1e3 if segs else 0.0
    d = runs[0]["delta"]
    prefill_s = sum(r["timing"]["prefill_s"] for r in runs) / len(runs)
    return (f"median {med:.1f} tok/s (quartiles {q1:.1f}-{q3:.1f}; each "
            f"{', '.join(f'{x:.1f}' for x in rates)}), mean decode segment "
            f"{seg_ms:.2f} ms, {d['decode_steps']} decode steps in "
            f"{d['decode_dispatches']} segments and {prefill_s:.3f} s of "
            f"prefill a serve"), med, seg_ms


def phase_prefix(torch, dev, model, params, card, launches):
    """The shared-prefix serve: 32 templated requests, 8 slots, 256 pages
    of 16, every prompt teacher-forced (``chunk_threshold`` 0), served 3
    times with the prefix cache off on one engine and 3 times on, each on
    a fresh engine (an empty cache, so the three serve one workload): the
    same tokens bit for bit, hits, skipped positions and at least one copy
    on write. The last prefix-on engine then serves the stream once more
    over the pages it cached, printed on its own line as the warm repeat.
    Then the prefill variant (``chunk_threshold`` None) once each way,
    whose share of equal tokens is printed, not gated (ROADMAP Queue
    C)."""
    from repro_torch.serving.engine import ServingEngine
    stream = make_prefix_stream(model.cfg.vocab)
    geometry = dict(max_batch=8, max_len=512, decode_block=16, page_size=16)
    lens = [len(p) for p, _ in stream]

    def engine(**kw):
        eng = ServingEngine(model, params, **dict(geometry, **kw))
        eng.warmup(prompt_lens=lens)
        return eng

    res = {}
    eng = engine(chunk_threshold=0)
    off = repeat_serves(torch, dev, eng, stream, PREFIX_REPEATS,
                        "prefix off", launches=launches)
    del eng
    on = []
    for _ in range(PREFIX_REPEATS):
        eng = engine(chunk_threshold=0, prefix_cache=True)
        on += repeat_serves(torch, dev, eng, stream, 1, "prefix on, cold",
                            launches=launches)
    (warm,) = repeat_serves(torch, dev, eng, stream, 1, "prefix on, warm",
                            launches=launches)
    del eng
    for label, runs in (("prefix off", off), ("prefix on", on)):
        text, med, seg_ms = summary(runs)
        res[label] = dict(runs=runs, tok_s=med, seg_ms=seg_ms,
                          steps=runs[0]["delta"]["decode_steps"])
        print(f"  {label}: {text}")
    want = off[0]["tokens"]
    for i, run in enumerate(off + on + [warm]):
        check(all(np.array_equal(a, b) for a, b in zip(run["tokens"], want)),
              f"prefix serve {i}: tokens differ from the first prefix-off "
              "serve's")
    counts = []
    for run in on:
        d = run["delta"]
        check(d["prefix_hits"] > 0 and d["prefix_tokens_skipped"] > 0
              and d["cow_copies"] >= 1,
              f"prefix on: {d['prefix_hits']} hits, "
              f"{d['prefix_tokens_skipped']} positions skipped, "
              f"{d['cow_copies']} copies on write")
        counts.append({k: d[k] for k in (
            "prefix_hits", "prefix_pages_reused", "prefix_tokens_skipped",
            "cow_copies", "evictions", "decode_steps")})
    check(all(c == counts[0] for c in counts),
          f"prefix on: the cold serves' counts differ: {counts}")
    fed = sum(lens)
    print(f"  prefix on: tokens equal the prefix-off serves' bit for bit in "
          f"each of {PREFIX_REPEATS} serves, each on a fresh engine; counts "
          f"a serve {counts[0]} ({fed} prompt positions in the stream); on "
          f"{card}")
    wd = warm["delta"]
    print(f"  prefix on, warm repeat (the last engine again, its cache "
          f"holding the first serve's pages; another workload, not in the "
          f"median): {warm['tok_s']:.1f} tok/s, {wd['decode_steps']} decode "
          f"steps, {wd['prefix_hits']} hits, {wd['prefix_tokens_skipped']} "
          f"positions skipped; tokens equal the prefix-off serves'")
    shares = {}
    for label, kw in (("off", {}), ("on", dict(prefix_cache=True))):
        eng = engine(**kw)
        shares[label] = repeat_serves(torch, dev, eng, stream, 1,
                                      f"prefill variant, prefix {label}",
                                      launches=launches)[0]
        del eng
    same = sum(np.array_equal(a, b) for a, b in zip(
        shares["on"]["tokens"], shares["off"]["tokens"]))
    d = shares["on"]["delta"]
    print(f"  prefill variant (chunk_threshold None): {same} of "
          f"{len(stream)} requests' tokens equal between prefix on and off "
          f"(not a gate: a hit feeds its uncached tail through the fused "
          f"decode kernel where the off serve prefills it); on: "
          f"{d['prefix_hits']} hits, {d['prefix_tokens_skipped']} positions "
          f"skipped, {d['decode_steps']} steps, "
          f"{d['prefill_dispatches']} prefill dispatches")
    return dict(off=res["prefix off"], on=res["prefix on"], counts=counts[0],
                warm_tok_s=warm["tok_s"], prefill_same=same)


def phase_swap(torch, dev, model, params, stream, oracle, card, launches,
               pressure_steps):
    """The swap serve: phase 6's pressure configuration with
    ``swap="host"``, 3 serves, each with one forced preempt of a slot past
    its prompt feed (its pages must go to the host and come back), against
    phase 6's oracle bit for bit; then the same serve with a budget below
    one page's bytes, where every victim, the forced one included,
    recomputes."""
    from repro_torch.serving.engine import ServingEngine
    knobs = dict(max_batch=8, max_len=512, decode_block=16, page_size=16,
                 stage_slots=PRESSURE_STAGE, admission="optimistic",
                 preempt_policy="slack", n_pages=PRESSURE_PAGES, stream=True,
                 chunk_threshold=0, swap="host")
    lens = [len(p) for p, _ in stream]

    def engine(**kw):
        eng = ServingEngine(model, params, **dict(knobs, **kw))
        eng.warmup(prompt_lens=lens)
        return eng

    def forced_serve(eng, label):
        """One serve that preempts, once, the first slot past its prompt
        feed that still owes tokens; returns the run and that preempt's
        swap count."""
        forced = {}

        def hook(e):
            live = [s for s in range(e.max_batch) if e._swap_ok(s)]
            if "rid" not in forced and live:
                n0 = e.stats["swap_out"]
                forced["rid"] = e._slot_req[live[0]].rid
                e.preempt(live[0])
                forced["swapped"] = e.stats["swap_out"] - n0

        (run,) = repeat_serves(torch, dev, eng, stream, 1, label, hook=hook,
                               launches=launches)
        check("rid" in forced, f"{label}: no slot to force out")
        check(all(np.array_equal(a, b) for a, b in zip(run["tokens"],
                                                         oracle)),
              f"{label}: tokens differ from phase 6's oracle")
        check(eng._swap_live_bytes == 0, f"{label}: budget not back to 0")
        d = run["delta"]
        check(d["preempt_readmits"] == d["preemptions"],
              f"{label}: {d['preemptions']} preemptions, "
              f"{d['preempt_readmits']} re-admitted")
        return run, forced

    eng = engine()
    runs = []
    for _ in range(SWAP_REPEATS):
        run, forced = forced_serve(eng, "swap serve")
        d = run["delta"]
        check(forced["swapped"] == 1 and d["swap_out"] == d["swap_in"] >= 1,
              f"swap serve: forced preempt of request {forced['rid']} "
              f"swapped {forced['swapped']}; {d['swap_out']} out, "
              f"{d['swap_in']} in")
        runs.append(run)
    text, med, seg_ms = summary(runs)
    d = runs[0]["delta"]
    per_page = sum(leaf.numel() // leaf.shape[eng._axes[n][1] - 1]
                   * leaf.element_size() for n, leaf in eng._cache.items())
    counts = {k: d[k] for k in ("preemptions", "swap_out", "swap_in",
                                "swap_fallbacks", "swap_bytes",
                                "pressure_stalls", "decode_steps")}
    print(f"  swap serve (a forced preempt of request {forced['rid']} past "
          f"its prompt feed in each): {text}; against phase 6's recompute "
          f"serve's {pressure_steps} steps; counts a serve {counts}; tokens "
          f"equal phase 6's oracle bit for bit in each of {SWAP_REPEATS} "
          f"serves; {per_page} bytes a page; on {card}")
    del eng
    tight = engine(swap_budget_bytes=per_page - 1)
    brun, _ = forced_serve(tight, "swap serve, budget below a page")
    bd = brun["delta"]
    check(bd["swap_fallbacks"] > 0 and bd["swap_out"] == 0,
          f"budget serve: {bd['swap_fallbacks']} fallbacks, "
          f"{bd['swap_out']} swaps")
    print(f"  the same serve with a budget of {per_page - 1} bytes (below one "
          f"page): {bd['swap_fallbacks']} fallbacks to recompute, no swap, "
          f"{bd['decode_steps']} decode steps against the swap serve's "
          f"{d['decode_steps']}; tokens equal the oracle's")
    del tight
    torch.cuda.empty_cache()
    return dict(tok_s=med, seg_ms=seg_ms, counts=counts,
                budget_steps=bd["decode_steps"],
                budget_fallbacks=bd["swap_fallbacks"])


def phase_contiguous(torch, dev, model, params, stream, paged_tokens, card,
                     launches, whisper_tokens):
    """The contiguous layout (``page_size=None``) on phase 3's stream and
    geometry: 5 serves whose tokens equal phase 3's paged bf16 serve's bit
    for bit, a profiled serve whose decode runs the contiguous kernel's
    tensor-core body once a layer a step and never the fused paged one,
    in one captured graph; then whisper-base, contiguous, against its
    paged serve of phase 3."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine
    geometry = dict(max_batch=8, max_len=512, decode_block=16,
                    page_size=None)
    lens = [len(p) for p, _ in stream]
    eng = ServingEngine(model, params, **geometry)
    eng.warmup(prompt_lens=lens)
    runs = repeat_serves(torch, dev, eng, stream, CONTIGUOUS_REPEATS,
                         "contiguous serve", launches=launches)
    for run in runs:
        check(all(np.array_equal(a, b) for a, b in zip(run["tokens"],
                                                         paged_tokens)),
              "contiguous serve: tokens differ from the paged serve's")
    text, med, seg_ms = summary(runs)
    print(f"  contiguous llama3.2-1b bf16: {text}; tokens equal phase 3's "
          f"paged serve bit for bit in each of {CONTIGUOUS_REPEATS} serves; "
          f"on {card}")
    prof = profile_serve(torch, dev, eng, stream, "contiguous")
    got, steps = prof["launches"], prof["steps"]
    for k, n in prof["total"].items():
        launches[k] = launches.get(k, 0) + n
    n_layers = model.cfg.n_layers
    events = {name: n for name, (_us, n) in prof["by_name"].items()}
    mma = sum(n for name, n in events.items() if DECODE_MMA.search(name))
    fused = sum(n for name, n in events.items() if "fused_decode" in name)
    check(got["decode_attention"] == steps * n_layers == mma
          and fused == 0 and got["fused_paged_decode_attention"] == 0,
          f"contiguous profiled serve: {got['decode_attention']} "
          f"decode_attention launches, {mma} tensor-core body events, "
          f"{fused} fused decode events for {steps} steps x {n_layers} "
          f"layers")
    print(f"  contiguous profiled serve: {steps} decode steps x {n_layers} "
          f"layers = {mma} launches of the contiguous kernel's tensor-core "
          f"body (decode_mma_kernel), 0 of the fused paged kernel, 1 "
          f"captured graph")
    del eng
    torch.cuda.empty_cache()
    wcfg = ARCHS["whisper-base"].for_device(dev)
    wmodel = build_model(wcfg, dev)
    wparams = wmodel.init(SEED)
    wstream = make_stream(wcfg.vocab)
    weng = ServingEngine(wmodel, wparams, **geometry)
    weng.warmup(prompt_lens=[len(p) for p, _ in wstream])
    (wrun,) = repeat_serves(torch, dev, weng, wstream, 1,
                            "whisper-base contiguous", launches=launches)
    check(all(np.array_equal(a, b) for a, b in zip(wrun["tokens"],
                                                     whisper_tokens)),
          "whisper-base contiguous: tokens differ from its paged serve's")
    check(wrun["launches"]["decode_attention"] > 0
          and wrun["launches"]["fused_paged_decode_attention"] == 0
          and wrun["launches"]["paged_decode_attention"] == 0,
          f"whisper-base contiguous launches {wrun['launches']}")
    print(f"  whisper-base contiguous: tokens equal its paged serve's bit "
          f"for bit; {wrun['tok_s']:.1f} tok/s, "
          f"{wrun['delta']['decode_steps']} decode steps")
    del weng, wparams
    torch.cuda.empty_cache()
    return dict(tok_s=med, seg_ms=seg_ms, steps=steps,
                whisper_tok_s=wrun["tok_s"])


def phase_prefix_swap_layout(torch, dev, model, params, stream, card,
                             paged_tokens, pressure, whisper_tokens):
    """Phase 7 on phase 3's llama3.2-1b bf16 model and params. Returns the
    phase's launches and numbers."""
    launches: dict = {}
    t0 = time.perf_counter()
    prefix = phase_prefix(torch, dev, model, params, card, launches)
    t1 = time.perf_counter()
    swap = phase_swap(torch, dev, model, params, stream, pressure["oracle"],
                      card, launches, pressure["pressure_steps"])
    t2 = time.perf_counter()
    contiguous = phase_contiguous(torch, dev, model, params, stream,
                                  paged_tokens, card, launches,
                                  whisper_tokens)
    print(f"  phase 7 parts: prefix {t1 - t0:.1f} s, swap {t2 - t1:.1f} s, "
          f"contiguous {time.perf_counter() - t2:.1f} s")
    print(f"  phase launches {launches}")
    return dict(launches=launches, prefix=prefix, swap=swap,
                contiguous=contiguous)


# ---------------------------------------------------------------------------
# phase 8: the wall clock (threaded steppers, ServingRuntime, fault sites,
# deadline enforcement)

WALL_QUERIES = 16          # streamed payload queries of the wall serve
WALL_RATE = 8.0            # their seeded Poisson arrival rate, queries/s
WALL_MAX_NEW = 32
WALL_FAULT_AT = 2          # the stepper consult that dies in the fault serve
WALL_TIMEOUT = 300.0       # bound of every wait on a result


def wall_cluster(dev, n_accel, monitor_period=None, **knobs):
    """A full-width llama3.2-1b cluster on the wall clock (phase 5's engine
    geometry), one threaded executor a worker; ``monitor_period`` sets the
    workers' monitor tick (its default otherwise)."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.master import MasterConfig
    from repro_torch.core.worker import WorkerConfig
    from repro_torch.serving.executor import EngineExecutorConfig
    from repro_torch.sim.cluster import make_cluster
    worker = (WorkerConfig() if monitor_period is None
              else WorkerConfig(monitor_period=monitor_period))
    return make_cluster(n_accel=n_accel, archs=[ARCHS[CP_ARCH]],
                        autoscale=False,
                        cfg=MasterConfig(worker_autoscale=False,
                                         worker=worker),
                        backend="real", clock="wall", device=dev,
                        engine_cfg=EngineExecutorConfig(
                            max_batch=8, max_len=512, decode_block=16,
                            min_bucket=8, page_size=16, **knobs))


def record_prefill_batches(eng, batch_of):
    """Record, by prompt, the batch size (1 or ``max_batch``) of the
    prefill dispatch that admitted it: a request's tokens depend on its
    prompt and on that shape alone (every decode step has the same shape,
    and each row of a product is computed alone), so the oracle replays
    that shape."""
    admit = eng._admit_group

    def recorded(bucket, rs, slots):
        for r in rs:
            batch_of[tuple(int(t) for t in r.prompt)] = \
                1 if len(rs) == 1 else eng.max_batch
        return admit(bucket, rs, slots)

    eng._admit_group = recorded


def oracle_tokens(torch, engines, variant, prompt, batch, max_new):
    """A direct engine's tokens for one prompt on the variant's params, its
    prefill dispatched at the served batch size (with a second copy of the
    prompt as the other row when that is ``max_batch``)."""
    from repro_torch.serving.engine import Request
    eng = engines[variant]
    reqs = [Request(rid=i, prompt=np.asarray(prompt, np.int32),
                    max_new_tokens=max_new)
            for i in range(1 if batch == 1 else 2)]
    eng.serve(reqs)
    return reqs[0].tokens


def phase_wall(torch, dev, card):
    """Phase 8: a wall-clock llama3.2-1b cluster at full width with two
    workers, so two stepper threads share the card, each holding both
    variants' engines, warmed for the stream's buckets, the bf16 variant
    loaded on one worker and the int8 one on the other before the serve
    (no monitor tick inside the serve, so no instance turns overloaded). A client thread
    submits streamed payload queries of both variants as seeded Poisson
    arrivals through ``ServingRuntime``: each result must be ok, its
    streamed concat its outputs, its tokens a direct engine's on the
    served variant's params, both steppers must have served, no graph may
    be captured during the serve, and ``shutdown(drain=True)`` must return
    True with every stepper joined. Then, on a one-worker cluster, a
    stepper death mid-decode (the injected ``stepper`` fault) must be
    retried to a direct engine's tokens with one restart, the dropped
    engine's device memory released, and a 1 ms SLO under
    ``deadline_enforce`` must come back ``timed_out``."""
    import gc
    import threading
    from repro_torch.core.api import QueryPayload, QuerySpec
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.serving.runtime import ServingRuntime
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS[CP_ARCH]
    names = [f"{CP_ARCH}/h100-1/{d}-b8" for d in ("bf16", "int8")]
    stream = make_stream(cfg.vocab, n=WALL_QUERIES, seed=8)
    prompts = [p for p, _ in stream]
    t0 = time.perf_counter()
    # the bf16 variant runs on one worker and the int8 one on the other, so
    # both steppers serve. Selection takes the least loaded running
    # instance and counts one as overloaded once a monitor tick has seen
    # its served latency above 1.5x the analytic t(b_opt), which every
    # payload query is (32 tokens against the profile's few); which
    # worker a query lands on then hung on where the 2 s ticks fell in a
    # 2 s serve (PR 21's runs split the steps 310/62; later runs, whose
    # earlier phases took other times, 372/0). With no tick inside the
    # serve no instance turns overloaded, so no query waits on a load.
    c = wall_cluster(dev, 2, monitor_period=WALL_TIMEOUT)
    variants = c.store.registry.variants
    batch_of: dict = {}
    for ex in c.executors:
        with ex._lock:
            for name in names:
                eng = ex._engine(variants[name])
                eng.warmup(prompt_lens=[len(p) for p in prompts])
                record_prefill_batches(eng, batch_of)
    # each variant's instance running on its own worker before the first
    # query, so no query waits on a model load (the serve times serving
    # alone) and both steppers serve
    loads = list(zip(sorted(c.master.workers), names))
    for w, name in loads:
        c.loop.schedule(0.0, (lambda w=w, name=name:
                              c.master.workers[w].load_variant(
                                  variants[name])))
    deadline = time.monotonic() + 60.0
    while not all(c.store.instance(n, w) is not None
                  and c.store.instance(n, w).running for w, n in loads):
        check(time.monotonic() < deadline, "variants never loaded")
        time.sleep(0.05)
    traces = {(i, n): (e.stats["prefill_traces"], e.stats["decode_traces"])
              for i, ex in enumerate(c.executors)
              for n, e in ex.engines.items()}
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    rt = ServingRuntime(c)
    handles: list = []
    rng = np.random.default_rng(SEED + 8)
    gaps = rng.exponential(1.0 / WALL_RATE, size=WALL_QUERIES)

    def client():
        for i, gap in enumerate(gaps):
            time.sleep(float(gap))
            h = rt.submit(QuerySpec.variant(
                names[i % 2], latency_ms=600_000,
                payload=QueryPayload.of([prompts[i]],
                                        max_new_tokens=WALL_MAX_NEW)))
            handles.append((i, h))

    build.reset_launch_counts()
    t1 = time.perf_counter()
    sender = threading.Thread(target=client, name="wall-client")
    sender.start()
    sender.join(WALL_TIMEOUT)
    check(not sender.is_alive() and len(handles) == WALL_QUERIES,
          f"the client submitted {len(handles)} of {WALL_QUERIES} queries")
    results = [(i, h, h.result(timeout=WALL_TIMEOUT)) for i, h in handles]
    serve_s = time.perf_counter() - t1
    drained = rt.shutdown(drain=True, timeout=WALL_TIMEOUT)
    launches = dict(build.launch_counts)
    check(drained, "shutdown(drain=True) returned False")
    threads = [None if ex._thread is None else ex._thread.is_alive()
               for ex in c.executors]
    served = [sum(e.stats["decode_steps"] for e in ex.engines.values())
              for ex in c.executors]
    check(all(t is False for t in threads),
          f"stepper threads after shutdown (None: never started, True: "
          f"still alive): {threads}; decode steps by stepper {served}")
    now = {(i, n): (e.stats["prefill_traces"], e.stats["decode_traces"])
           for i, ex in enumerate(c.executors)
           for n, e in ex.engines.items()}
    check(now == traces, f"graphs captured during the serve: {traces} "
          f"before, {now} after")
    steps = [sum(e.stats["decode_steps"] for e in ex.engines.values())
             for ex in c.executors]
    check(all(n > 0 for n in steps),
          f"decode steps by stepper {steps}: not both served")
    oracles = {n: ServingEngine(*c.executors[0].served_model(variants[n]),
                                max_batch=8, max_len=512, decode_block=16,
                                min_bucket=8, page_size=16)
               for n in names}
    for eng in oracles.values():
        eng.warmup(prompt_lens=[len(p) for p in prompts])
    for i, h, res in results:
        check(res.ok and res.load == 0.0, f"wall query {i}: failed="
              f"{res.failed} variant={res.variant!r} load {res.load} s")
        (out,) = res.outputs
        cat = [t for ch in h.chunks for t in ch.tokens]
        check(cat == [int(x) for x in out],
              f"wall query {i}: streamed concat differs from its outputs")
        want = oracle_tokens(torch, oracles, res.variant, prompts[i],
                             batch_of[tuple(int(t) for t in prompts[i])],
                             WALL_MAX_NEW)
        check(np.array_equal(want, out), f"wall query {i} ({res.variant}): "
              "tokens differ from a direct engine on the served params")
    ttft = [h.ttft for _, h, _ in results]
    lat = [res.latency for _, _, res in results]
    q = statistics.quantiles
    print(f"  wall serve: {WALL_QUERIES} streamed queries (1 prompt of "
          f"16-300 tokens, {WALL_MAX_NEW} new tokens each, both variants) "
          f"at {WALL_RATE:.0f} q/s Poisson from a client thread, 2 "
          f"workers' steppers on one card (decode steps {steps}); "
          f"{WALL_QUERIES / serve_s:.2f} q/s over {serve_s:.2f} s; TTFT "
          f"p50 {statistics.median(ttft) * 1e3:.1f} ms p99 "
          f"{q(ttft, n=100)[98] * 1e3:.1f} ms; completion p50 "
          f"{statistics.median(lat) * 1e3:.1f} ms p99 "
          f"{q(lat, n=100)[98] * 1e3:.1f} ms; prefill batches "
          f"{sorted(batch_of.values())}; every result ok, streamed concat "
          f"= outputs = a direct engine's tokens; no capture during the "
          f"serve; drained clean (warm-up {warm_s:.1f} s) on {card}")
    print(f"  wall serve launches {launches}")
    for name in ("flash_attention", "fused_paged_decode_attention",
                 "int8_matmul"):
        check(launches[name] > 0, f"{name} was not launched in the wall "
              "serve")
    del rt, c, oracles, results, handles
    gc.collect()
    torch.cuda.empty_cache()

    # a stepper death, then a deadline, on one worker
    faults = FaultInjector(schedule={"stepper": [WALL_FAULT_AT]})
    c = wall_cluster(dev, 1, faults=faults, deadline_enforce=True)
    (ex,) = c.executors
    variant = c.store.registry.variants[names[0]]
    fault_prompts = prompts[:8]
    with ex._lock:
        ex._engine(variant).warmup(prompt_lens=[len(p)
                                                for p in fault_prompts])
    torch.cuda.synchronize(dev)
    engine_gb = sum(t.numel() * t.element_size() for t in
                    ex.engines[variant.name]._cache.values()) / 1e9
    alloc0 = torch.cuda.memory_allocated(dev) / 1e9
    res0 = torch.cuda.memory_reserved(dev) / 1e9
    rt = ServingRuntime(c)
    try:
        res = rt.submit(QuerySpec.variant(
            variant.name, latency_ms=600_000,
            payload=QueryPayload.of(fault_prompts,
                                    max_new_tokens=WALL_MAX_NEW))).result(
                timeout=WALL_TIMEOUT)
        check(res.ok and res.attempts > 1,
              f"stepper fault: ok={res.ok} after {res.attempts} attempts")
        check(faults.fired.get("stepper") == 1 and ex.stepper_restarts == 1,
              f"stepper fault fired {faults.fired.get('stepper')}, "
              f"{ex.stepper_restarts} restarts")
        gc.collect()
        torch.cuda.synchronize(dev)
        alloc1 = torch.cuda.memory_allocated(dev) / 1e9
        res1 = torch.cuda.memory_reserved(dev) / 1e9
        eng = ex.engines[variant.name]
        check(eng.stats["decode_traces"] == 1,
              "the rebuilt engine did not capture its step")
        want = served_tokens(torch, ex, variant, fault_prompts,
                             WALL_MAX_NEW)
        check(all(np.array_equal(a, b) for a, b in zip(want, res.outputs)),
              "stepper fault: the retried query's tokens differ from a "
              "direct engine's")
        check(alloc1 - alloc0 < engine_gb / 2,
              f"device memory {alloc0:.3f} GB before the fault, {alloc1:.3f}"
              f" GB after the retry: the dropped engine ({engine_gb:.3f} GB "
              "of pools) was not released")
        print(f"  stepper fault at consult {WALL_FAULT_AT}: the query "
              f"failed mid-decode, was retried ({res.attempts} attempts) "
              f"to a direct engine's tokens; 1 restart; the rebuilt engine "
              f"captured anew; device memory allocated {alloc0:.3f} -> "
              f"{alloc1:.3f} GB, reserved {res0:.3f} -> {res1:.3f} GB "
              f"(one engine's pools {engine_gb:.3f} GB) on {card}")
        late = rt.submit(QuerySpec.variant(
            variant.name, latency_ms=1,
            payload=QueryPayload.of(prompts[8:9],
                                    max_new_tokens=WALL_MAX_NEW))).result(
                timeout=WALL_TIMEOUT)
        check(late.timed_out is True and not late.failed,
              f"deadline: timed_out={late.timed_out} failed={late.failed}")
        got = len(late.outputs[0]) if late.outputs else 0
        print(f"  deadline_enforce, 1 ms SLO: timed out after "
              f"{got} of {WALL_MAX_NEW} tokens, latency "
              f"{late.latency * 1e3:.1f} ms, not failed")
    finally:
        drained = rt.shutdown(drain=True, timeout=WALL_TIMEOUT)
    check(drained and not ex._thread.is_alive(),
          "the fault cluster did not drain clean")
    del rt, c, ex
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, q_s=WALL_QUERIES / serve_s,
                ttft_ms=(statistics.median(ttft) * 1e3,
                         q(ttft, n=100)[98] * 1e3),
                lat_ms=(statistics.median(lat) * 1e3,
                        q(lat, n=100)[98] * 1e3))


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 3: zamba2-1.2b, the hybrid family (Mamba2 SSD + one shared block)

HYBRID_ARCH = "zamba2-1.2b"


def phase_hybrid(torch, dev, card):
    """zamba2-1.2b at its published size (38 layers, nothing cut) on phase
    3's stream: graphed serves against the uncaptured oracle, graphed
    prefill against its eager body (the ssm and conv state leaves
    included), a profiled serve, and a contiguous serve whose tokens must
    equal the paged serve's bit for bit (B5 per slot runs on B1's span
    plan). Returns the path's result with its model, params and stream for
    phase 10."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServingEngine
    base = ARCHS[HYBRID_ARCH]
    cfg = base.for_device(dev)
    check(cfg.attention_impl == "cuda", "config did not select the kernels")
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize(dev)
    print(f"  {HYBRID_ARCH}: {cfg.n_layers} layers, "
          f"{base.param_count() / 1e9:.3f} B params, bf16, init "
          f"{time.perf_counter() - t0:.1f} s")
    stream = make_stream(cfg.vocab)
    pf = check_prefill_graphs(torch, dev, model, params, stream,
                              HYBRID_ARCH, card)
    eng = pf.pop("engine")
    res = serve_variant(torch, dev, model, params, stream, HYBRID_ARCH,
                        SERVE_REPEATS[HYBRID_ARCH], eng=eng)
    res["prefill"] = pf
    res["profile"] = profile_variant(torch, dev, model, params, stream,
                                     HYBRID_ARCH, eng=eng)
    eng = ServingEngine(model, params, max_batch=8, max_len=512,
                        decode_block=16, page_size=None)
    eng.warmup(prompt_lens=[len(p) for p, _ in stream])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(stream)]
    build.reset_launch_counts()
    eng.serve(reqs)
    torch.cuda.synchronize(dev)
    cont = dict(build.launch_counts)
    st = eng.stats
    check(st["decode_traces"] == 1
          and st["graph_replays"] == st["decode_steps"] > 0,
          f"{HYBRID_ARCH} contiguous: {st['graph_replays']} replays for "
          f"{st['decode_steps']} steps")
    check(all(np.array_equal(r.tokens, t)
              for r, t in zip(reqs, res["served"])),
          f"{HYBRID_ARCH}: contiguous tokens differ from the paged serve's")
    check(cont["decode_attention"] > 0
          and cont["fused_paged_decode_attention"] == 0,
          f"{HYBRID_ARCH} contiguous: launches {cont}")
    del eng
    torch.cuda.empty_cache()
    for k, n in cont.items():
        res["launches"][k] = res["launches"].get(k, 0) + n
    print(f"  {HYBRID_ARCH} contiguous (page_size None): tokens equal the "
          f"paged serve's bit for bit; launches {cont}")
    for name in ("flash_attention", "fused_paged_decode_attention",
                 "decode_attention"):
        check(res["launches"][name] > 0,
              f"{name} was not launched on the {HYBRID_ARCH} path")
    res["hybrid"] = (model, params, stream)
    return res


# ---------------------------------------------------------------------------
# phase 9: speculative decoding, llama3.2-1b at full width

SPEC_K = 4
SPEC_REPEATS = 2


def spec_delta(torch, dev, model, params, stream, k):
    """The bound of the token audit, from two measured gaps of the plain
    target's own logits, at this config on this card, over the stream's
    first 8 prompts: ``window``, the verify window's logits against ``k +
    1`` single-token decodes of the same rows from the same cache
    (teacher-forced, seeded tokens); ``prefill``, the first logits of a
    batch-1 prefill against those of a batch-8 one (a request's bf16
    tokens depend on that shape). A first difference between a
    speculating serve and the plain one must lie within twice their sum
    of a tie: the plain target's margin between its top token and the
    speculating serve's is at most that."""
    B, L = 8, 512
    rows = stream[:B]
    lens = np.array([len(p) for p, _ in rows], np.int64)
    S = int(lens.max())
    toks = np.zeros((B, S), np.int64)
    for b, (p, _m) in enumerate(rows):
        toks[b, :len(p)] = p
    to = lambda a: torch.from_numpy(np.asarray(a)).to(dev)   # noqa: E731
    rng = np.random.default_rng(5)
    feed = to(rng.integers(0, model.cfg.vocab, (B, k + 1)))
    with torch.no_grad():
        logits8, pc = model.prefill(params, {"tokens": to(toks),
                                             "length": to(lens)})
        first1 = torch.cat([model.prefill(params, {
            "tokens": to(toks[b:b + 1]), "length": to(lens[b:b + 1])})[0]
            for b in range(B)])
        prefill = (first1 - logits8).abs().max().item()
        cache = {}
        for name, (dims, dtype) in model.cache_shapes(B, L).items():
            leaf = torch.zeros(dims, dtype=dtype, device=dev)
            leaf.narrow(2, 0, S).copy_(pc[name])
            cache[name] = leaf
        seq_cache = {n: t.clone() for n, t in cache.items()}
        pos = to(lens.astype(np.int32))
        win, _ = model.decode_window(params, cache, feed, pos)
        seq = torch.stack([model.decode(params, seq_cache, feed[:, i:i + 1],
                                        pos + i)[0][:, -1]
                           for i in range(k + 1)], 1)
        window = (win - seq).abs().max().item()
        check(bool(torch.isfinite(win).all()), "spec delta: window logits")
    return window, prefill


def plain_margin(torch, dev, model, params, prompt, nb, tokens, j):
    """The plain target's margin at generated position ``j`` of a request
    it served as ``tokens``: its next-token logits after the prompt
    (prefilled at batch ``nb``, its row repeated) and ``tokens[:j]`` fed
    one step at a time at the engine's batch of 8 (every row alike, each
    computed alone), over the contiguous layout (the paged one gathers
    the same rows); the top logit minus the logit of the other token is
    returned with the logits."""
    from repro_torch.serving.engine import bucket_len
    B, L = 8, 512
    n = len(prompt)
    bucket = bucket_len(n, 8, L)
    toks = np.zeros((nb, bucket), np.int64)
    toks[:, :n] = prompt
    to = lambda a: torch.from_numpy(np.asarray(a)).to(dev)   # noqa: E731
    with torch.no_grad():
        logits, pc = model.prefill(params, {
            "tokens": to(toks), "length": to(np.full((nb,), n, np.int64))})
        cache = {}
        for name, (dims, dtype) in model.cache_shapes(B, L).items():
            leaf = torch.zeros(dims, dtype=dtype, device=dev)
            leaf.narrow(2, 0, bucket).copy_(pc[name][:, :1].expand(
                -1, B, -1, -1, -1))
            cache[name] = leaf
        last = logits[0, -1]
        for i in range(j):
            tok = to(np.full((B, 1), int(tokens[i]), np.int64))
            pos = to(np.full((B,), n + i, np.int32))
            last = model.decode(params, cache, tok, pos)[0][0, -1]
    return last


def check_spec_graphs(torch, dev, eng, label):
    """The propose, verify and resync graphs against their bodies on the
    same inputs, bit for bit: from one snapshot of every cache leaf (the
    target's and the draft's) and the round buffers, a replay of the graph
    and a run of the body must leave them the same bits."""
    progs = [eng._spec.propose_program(), eng._get_verify()]
    progs += [p for p, _inp in eng._spec._resync.values()][:2]
    state = (list(eng._cache.values()) + list(eng._spec.cache.values())
             + [eng._spec_out])
    for prog in progs:
        check(prog.graph is not None, f"{label}: {prog.name} not captured")
        snap = [t.clone() for t in state]
        prog.graph.replay()
        torch.cuda.synchronize(dev)
        graphed = [t.clone() for t in state]
        for t, v in zip(state, snap):
            t.copy_(v)
        with torch.no_grad():
            prog.body()
        torch.cuda.synchronize(dev)
        check(all(torch.equal(a, b) for a, b in zip(graphed, state)),
              f"{label}: {prog.name}'s graph differs from its body")
    print(f"  {label}: {', '.join(p.name for p in progs)}: each graph "
          f"replay equals its body on the same inputs, bit for bit")


def spec_serve(torch, dev, eng, stream, label, batch_of=None):
    """One serve of the stream; checks every request's length and, paged,
    the drained pool. Returns (requests, launches, wall s)."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import Request
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(stream)]
    if batch_of is not None:
        record_prefill_batches(eng, batch_of)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    got = dict(build.launch_counts)
    for r, (_p, m) in zip(reqs, stream):
        check(r.tokens is not None and len(r.tokens) == m,
              f"{label}: request {r.rid} returned {r.tokens}")
    if eng._paged:
        check(eng._alloc.n_free == eng.n_pages
              and eng._alloc.committed == 0,
              f"{label}: {eng._alloc.n_free} of {eng.n_pages} pages free, "
              f"{eng._alloc.committed} committed after the serve")
    return reqs, got, wall


def phase_spec(torch, dev, card, llama, cuda_tok_s):
    """Phase 9 on phase 3's llama3.2-1b bf16 params and stream: serves (a)
    an int8 draft, k = 4, paged (page 16); (b) the same, contiguous; (c)
    an int8 target with its own int8 draft, k = 3; (d) an independently
    initialised bf16 draft (seed 99), k = 4, paged: rollback every round;
    (e) (a) in f32. The target attends in plain PyTorch
    (``for_device(dev, speculate=True)``); the draft runs every kernel.
    Each against a plain graphed serve of the same target config."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models.quantize import quantize_params_dense
    from repro_torch.serving.engine import ServingEngine
    _model, params, stream = llama
    base = ARCHS["llama3.2-1b"]
    f32 = dataclasses.replace(base, dtype="float32", param_dtype="float32")
    int8 = dataclasses.replace(base, quantize="int8")
    f32_int8 = dataclasses.replace(f32, quantize="int8")
    tgt = {c.name + c.dtype + c.quantize: build_model(
        c.for_device(dev, speculate=True), dev) for c in (base, int8, f32)}
    check(all(m.cfg.attention_impl == "torch" for m in tgt.values()),
          "speculating targets must attend in plain PyTorch")
    qdraft = build_model(int8.for_device(dev), dev)
    qparams = quantize_params_dense(params)
    indep = build_model(base.for_device(dev), dev)
    iparams = indep.init(99)
    fparams = build_model(f32, dev).init(SEED)
    fqdraft = build_model(f32_int8.for_device(dev), dev)
    fqparams = quantize_params_dense(fparams)
    bt, it, ft = (tgt[c.name + c.dtype + c.quantize] for c in (base, int8,
                                                              f32))
    serves = [  # label, target, params, draft, draft params, k, page size
        ("(a) bf16, int8 draft, paged", bt, params, qdraft, qparams, 4, 16),
        ("(b) bf16, int8 draft, contiguous", bt, params, qdraft, qparams, 4,
         None),
        ("(c) int8 target, its int8 draft", it, qparams, qdraft, qparams, 3,
         16),
        ("(d) bf16, independent draft (seed 99)", bt, params, indep, iparams,
         4, 16),
        ("(e) f32, int8 draft, paged", ft, fparams, fqdraft, fqparams, 4, 16),
    ]
    geometry = dict(max_batch=8, max_len=512, decode_block=16)
    lens = [len(p) for p, _ in stream]
    launches: dict = {}
    plain: dict = {}
    out = []
    for label, target, tparams, dm, dp, k, ps in serves:
        key = (id(target), ps)
        if key not in plain:
            eng = ServingEngine(target, tparams, page_size=ps, **geometry)
            eng.warmup(prompt_lens=lens)
            batch_of: dict = {}
            rates = []
            for rep in range(SPEC_REPEATS):
                reqs, _got, wall = spec_serve(
                    torch, dev, eng, stream, f"{label} plain",
                    batch_of if rep == 0 else None)
                rates.append(sum(len(r.tokens) for r in reqs) / wall)
                if rep == 0:
                    toks = [r.tokens for r in reqs]
            plain[key] = dict(tokens=toks, tok_s=statistics.median(rates),
                              batch_of=batch_of)
            del eng
        ref = plain[key]
        kw = dict(geometry, page_size=ps, speculate=(dm, dp), spec_k=k)
        eng = ServingEngine(target, tparams, **kw)
        t0 = time.perf_counter()
        eng.warmup(prompt_lens=lens)
        torch.cuda.synchronize(dev)
        warm_s = time.perf_counter() - t0
        check(eng._spec._propose.graph is not None
              and eng._verify.graph is not None
              and all(p.graph is not None
                      for p, _ in eng._spec._resync.values()),
              f"{label}: warmup did not capture every speculative program")
        batch_of = {}
        rates, first = [], None
        for rep in range(SPEC_REPEATS):
            st0 = dict(eng.stats)
            sp0 = dict(eng._spec.stats)
            sp_s0 = eng.timing["spec_s"]
            reqs, got, wall = spec_serve(torch, dev, eng, stream, label,
                                         batch_of if rep == 0 else None)
            rates.append(sum(len(r.tokens) for r in reqs) / wall)
            if first is None:
                d = {n: v - st0[n] for n, v in eng.stats.items()}
                ds = {n: v - sp0[n] for n, v in eng._spec.stats.items()}
                first = (reqs, got, d, ds, eng.timing["spec_s"] - sp_s0)
        reqs, got, d, ds, spec_s = first
        for n, v in got.items():
            launches[n] = launches.get(n, 0) + v
        check(d["spec_rounds"] > 0 and d["decode_traces"] == 0,
              f"{label}: {d['spec_rounds']} rounds")
        draft_kernels = ["flash_attention", "decode_attention"]
        if dm.cfg.quantize == "int8_cuda":
            draft_kernels.append("int8_matmul")
        check(all(got.get(n, 0) > 0 for n in draft_kernels)
              and got.get("fused_paged_decode_attention", 0) == 0,
              f"{label}: launches {got}")
        check_spec_graphs(torch, dev, eng, label)
        del eng
        torch.cuda.empty_cache()
        if not out:
            # the oracle of serve (a): every program's body, uncaptured,
            # the same tokens, counts and launches (the graphs' launches
            # credited per replay); the other serves hold their graphs to
            # their bodies in ``check_spec_graphs`` alone
            oracle = uncaptured_engine()(target, tparams, **kw)
            oracle.warmup(prompt_lens=lens)
            oreqs, ogot, _ = spec_serve(torch, dev, oracle, stream,
                                        f"{label} uncaptured")
            check(all(np.array_equal(a.tokens, b.tokens)
                      for a, b in zip(reqs, oreqs)),
                  f"{label}: graphed tokens differ from the uncaptured "
                  f"bodies'")
            check(ogot == got, f"{label}: credited launches {got} against "
                  f"the uncaptured bodies' {ogot}")
            check(all(oracle.stats[n] == d[n] for n in (
                "spec_rounds", "spec_proposed", "spec_accepted",
                "decode_steps")),
                  f"{label}: uncaptured counts differ")
            del oracle
            print(f"  {label}: an uncaptured engine gives the same tokens, "
                  f"spec counts and launches per wrapper")
        # the token audit against the plain serve
        window, prefill = spec_delta(torch, dev, target, tparams, stream, k)
        bound_margin = 2 * (window + prefill)
        equal, ties = 0, []
        for r, want in zip(reqs, ref["tokens"]):
            if np.array_equal(r.tokens, want):
                equal += 1
                continue
            j = int(np.argmax(r.tokens != want))
            nb = ref["batch_of"][tuple(int(t) for t in r.prompt)]
            last = plain_margin(torch, dev, target, tparams, r.prompt, nb,
                                want, j)
            check(int(torch.argmax(last)) == int(want[j]),
                  f"{label}: request {r.rid}: the teacher-forced plain "
                  f"target does not reproduce its token at {j}")
            margin = (last[int(want[j])] - last[int(r.tokens[j])]).item()
            ties.append((r.rid, j, margin))
            check(margin <= bound_margin,
                  f"{label}: request {r.rid} first differs at {j} with a "
                  f"margin {margin:.4g} > {bound_margin:.4g}")
        rate = d["spec_accepted"] / d["spec_proposed"]
        med = statistics.median(rates)
        ms_round = spec_s / d["spec_rounds"] * 1e3
        print(f"  {label}, k={k}: {equal} of {len(stream)} requests equal "
              f"the plain serve bit for bit; first differences (rid, "
              f"position, plain margin) {[(a, b, round(c, 5)) for a, b, c in ties]}"
              f" within twice window {window:.3e} + prefill {prefill:.3e}")
        print(f"  {label}, k={k}: {med:.1f} tok/s (each "
              f"{', '.join(f'{x:.1f}' for x in rates)}) against the plain "
              f"serve's {ref['tok_s']:.1f} and phase 3's cuda-impl llama "
              f"{cuda_tok_s:.1f}; acceptance {rate:.3f}, {d['spec_rounds']} "
              f"rounds, {d['decode_dispatches'] - d['spec_rounds']} "
              f"segments, {ds['resyncs']} resyncs, {ms_round:.3f} ms a "
              f"round (propose + verify + read), warmup {warm_s:.2f} s "
              f"on {card}")
        out.append(dict(label=label, k=k, equal=equal, ties=ties,
                        tok_s=med, plain_tok_s=ref["tok_s"],
                        accept=rate, rounds=d["spec_rounds"],
                        resyncs=ds["resyncs"], ms_round=ms_round,
                        window=window, prefill=prefill))
    del qparams, iparams, fparams, fqparams
    torch.cuda.empty_cache()
    print(f"  phase launches {launches}")
    return dict(launches=launches, serves=out)


# ---------------------------------------------------------------------------
# phase 10: the hybrid engine's state rows under pressure, and hybrid
# speculation

# the pressure serve's counts, predicted from lengths alone by a CPU run of
# ``phase_hybrid_pressure`` at reduced width (the stream drawn at the full
# vocabulary, its tokens taken mod the reduced one)
HYBRID_PRESSURE_PREDICTED = {
    "staged": 9, "inseg_admissions": 4, "preemptions": 4,
    "preempt_readmits": 4, "pressure_stalls": 9, "prefill_dispatches": 0,
    "chunk_admits": 12, "decode_dispatches": 43, "decode_steps": 673,
    "busy_slot_steps": 3643, "peak_concurrency": 8}


def phase_hybrid_pressure(torch, dev, model, params, stream, card):
    """zamba2-1.2b at full width in phase 6's pressure configuration
    (staging ring, optimistic admission, slack victims, a quarter of the
    pool, ``chunk_threshold=0``, streaming) against a worst-case serve with
    every prompt fed: the tokens must be equal bit for bit, which holds
    only if the in-graph state reset of every ring refill and the reset of
    every recovery seat are right. The counts must be the CPU rehearsal's
    (``HYBRID_PRESSURE_PREDICTED``)."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    geometry = dict(max_batch=8, max_len=512, decode_block=16, page_size=16,
                    chunk_threshold=0)
    knobs = dict(stage_slots=PRESSURE_STAGE, admission="optimistic",
                 preempt_policy="slack", n_pages=PRESSURE_PAGES,
                 stream=True)
    lens = [len(p) for p, _ in stream]
    launches: dict = {}

    def serve(eng):
        before = dict(eng.stats)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        reqs, chunks = stream_serve(eng, stream)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        for k, n in build.launch_counts.items():
            launches[k] = launches.get(k, 0) + n
        return reqs, chunks, {k: v - before[k]
                              for k, v in eng.stats.items()}, wall

    oracle = ServingEngine(model, params, **geometry)
    oracle.warmup(prompt_lens=lens)
    want_reqs, _, sa, wall_o = serve(oracle)
    want = [r.tokens for r in want_reqs]
    del oracle
    eng = ServingEngine(model, params, **dict(geometry, **knobs))
    eng.warmup(prompt_lens=lens)
    reqs, chunks, d, wall = serve(eng)
    check_pressure_serve(eng, f"{HYBRID_ARCH} pressure serve", reqs, chunks,
                         d, want)
    counts = {k: d[k] for k in PRESSURE_COUNTS}
    check(d["inseg_admissions"] > 0 and d["preemptions"] > 0,
          f"{HYBRID_ARCH} pressure serve: no pressure ran ({counts})")
    check(counts == HYBRID_PRESSURE_PREDICTED,
          f"{HYBRID_ARCH} pressure counts {counts} against the CPU "
          f"rehearsal's {HYBRID_PRESSURE_PREDICTED}")
    check(d["swap_out"] == 0 and eng._prefix is None,
          f"{HYBRID_ARCH}: swap or prefix cache ran on per-slot state")
    toks = sum(len(w) for w in want)
    del eng
    torch.cuda.empty_cache()
    print(f"  {HYBRID_ARCH} pressure serve ({PRESSURE_STAGE} staging slots, "
          f"optimistic, slack, {PRESSURE_PAGES} pages, chunk_threshold 0): "
          f"tokens equal the worst-case serve's bit for bit, chunks "
          f"concatenate to them; counts {counts} (predicted "
          f"{HYBRID_PRESSURE_PREDICTED}); {toks / wall:.1f} tok/s against "
          f"the worst-case serve's {toks / wall_o:.1f} "
          f"({sa['decode_steps']} steps) on {card}")
    return dict(launches=launches, counts=counts, tok_s=toks / wall,
                oracle_tok_s=toks / wall_o)


def phase_hybrid_spec(torch, dev, card):
    """A hybrid target with a dense draft, reduced width, f32, paged and
    contiguous: the tokens must equal the plain serve's. No dense config in
    the registry shares zamba2-1.2b's 32,000-token vocabulary, so
    full-width hybrid speculation has no draft; the reduced configs share
    a vocabulary of 256. The hybrid target verifies in k + 1 single-token
    decodes inside its one verify graph and re-seats a slot through the
    teacher-forced replay on a mismatch."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServingEngine
    tcfg = ARCHS[HYBRID_ARCH].reduced().for_device(dev, speculate=True)
    target = build_model(tcfg, dev)
    tparams = target.init(SEED)
    draft = build_model(ARCHS["llama3.2-1b"].reduced().for_device(dev), dev)
    dparams = draft.init(1)
    rng = np.random.default_rng(11)
    stream = [(rng.integers(0, tcfg.vocab, size=int(rng.integers(3, 40))
                            ).astype(np.int32), int(rng.integers(8, 24)))
              for _ in range(12)]
    lens = [len(p) for p, _ in stream]
    geometry = dict(max_batch=4, max_len=64, decode_block=4, min_bucket=4)
    launches: dict = {}
    for ps in (8, None):
        runs = []
        for spec in (None, (draft, dparams)):
            kw = dict(geometry, page_size=ps)
            if spec is not None:
                kw.update(speculate=spec, spec_k=SPEC_K)
            eng = ServingEngine(target, tparams, **kw)
            eng.warmup(prompt_lens=lens)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
                    for i, (p, m) in enumerate(stream)]
            build.reset_launch_counts()
            eng.serve(reqs)
            torch.cuda.synchronize(dev)
            for k, n in build.launch_counts.items():
                launches[k] = launches.get(k, 0) + n
            runs.append((reqs, dict(eng.stats)))
            if eng._paged:
                check(eng._alloc.n_free == eng.n_pages,
                      f"hybrid spec page {ps}: pages left held")
            del eng
        (plain, _), (spec, st) = runs
        check(all(np.array_equal(a.tokens, b.tokens)
                  for a, b in zip(plain, spec)),
              f"hybrid spec page {ps}: tokens differ from the plain serve's")
        check(st["spec_rounds"] > 0, f"hybrid spec page {ps}: no round")
        print(f"  {HYBRID_ARCH} reduced (f32, target attn=torch) with a "
              f"reduced llama draft, page size {ps}: tokens equal the plain "
              f"serve's; {st['spec_rounds']} rounds, "
              f"{st['spec_accepted']}/{st['spec_proposed']} accepted, "
              f"{st['decode_steps']} steps on {card}")
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# phase 3's ssm path (xlstm-1.3b) and moe path (moonshot-v1-16b-a3b), both
# at their published sizes

SSM_ARCH = "xlstm-1.3b"
MOE_ARCH = "moonshot-v1-16b-a3b"
# moonshot serves with 4 slots. Its decode expert capacity is max(4,
# ceil(B * 6 * 1.25 / 64)) = 4 rows an expert at B <= 8, so with B = 4
# rows no decode token is ever dropped and an idle slot's row (routed too,
# as the reference routes it) cannot change a live row's output. At 8
# slots it can, and an idle row attends to the trash page in the paged
# layout but to its slot's stale rows in the contiguous one, so the two
# layouts need not agree there.
MOE_GEOMETRY = dict(max_batch=4)
MOE_TF_LAYERS = 4           # phase 4's f32 depth of moonshot (of 48)


def phase_ssm(torch, dev, card):
    """xlstm-1.3b at its published size (48 layers: 36 mLSTM, 12 sLSTM;
    nothing cut) on phase 3's stream and geometry. Its page size must be
    inert (no leaf has a sequence axis: the engine serves contiguously
    with no allocator). Graphed serves against the uncaptured oracle,
    graphed prefill against its eager body (all seven f32 state leaves),
    and a profiled serve, which must show no wrapper launch: no kernel
    runs on this path. Returns the path's result with its model, params
    and stream for phase 11."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine
    base = ARCHS[SSM_ARCH]
    model = build_model(base.for_device(dev), dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize(dev)
    state_mb = sum(np.prod(sh) * 4 for sh, _ in
                   model.cache_shapes(1, 1).values()) / 1e6
    print(f"  {SSM_ARCH}: {base.n_layers} layers, "
          f"{base.param_count() / 1e9:.3f} B params, bf16, init "
          f"{time.perf_counter() - t0:.1f} s; f32 state {state_mb:.1f} MB "
          f"a slot")
    stream = make_stream(base.vocab)
    probe = ServingEngine(model, params, **GEOMETRY)
    check(not probe._paged and probe._alloc is None
          and probe.pages_per_slot == 0,
          f"{SSM_ARCH}: page size {GEOMETRY['page_size']} was not inert")
    del probe
    pf = check_prefill_graphs(torch, dev, model, params, stream, SSM_ARCH,
                              card)
    eng = pf.pop("engine")
    res = serve_variant(torch, dev, model, params, stream, SSM_ARCH,
                        SERVE_REPEATS[SSM_ARCH], eng=eng)
    res["prefill"] = pf
    res["profile"] = profile_variant(torch, dev, model, params, stream,
                                     SSM_ARCH, kernels=False, eng=eng,
                                     n_reqs=4)
    del eng
    check(not any(res["launches"].values()),
          f"{SSM_ARCH}: kernel launches {res['launches']}")
    res["ssm"] = (model, params, stream)
    return res


# device-time classes of a moonshot profile, by kernel name: the attention
# kernels (by wrapper), the GEMMs (cuBLAS's ``nvjet`` kernels on the H100:
# the routed experts' bmm, 3 a layer, read 53 GB of the 58 GB a step
# streams; the shared experts', the attention projections' and the
# head's), the routing and dispatch (the router's softmax, the stable
# sort, the running counts, the indexed write and gathers), and the rest
# (norms, RoPE, elementwise)
GEMM_KERNEL = re.compile(r"nvjet|gemm|cutlass|xmma|sm90_", re.I)
ROUTE_KERNEL = re.compile(r"softmax|sort|radix|scan|cumsum|one_hot|index|"
                          r"gather|scatter", re.I)


def moe_shares(by_name):
    """Shares of a profile's device time: attention, GEMM, routing, other."""
    tot = {"attention": 0.0, "gemm": 0.0, "routing": 0.0, "other": 0.0}
    for name, (us, _n) in by_name.items():
        if wrapper_of(name) is not None:
            tot["attention"] += us
        elif GEMM_KERNEL.search(name):
            tot["gemm"] += us
        elif ROUTE_KERNEL.search(name):
            tot["routing"] += us
        else:
            tot["other"] += us
    busy = sum(tot.values())
    return {k: v / max(busy, 1e-9) for k, v in tot.items()}, busy


def phase_moe(torch, dev, card):
    """moonshot-v1-16b-a3b at its published size (48 layers, 64 routed
    experts top-6 + 2 shared, d 2048, 16/16 heads of 128; 57.8 GB of bf16
    weights), run first in phase 3, with nothing else on the card. On
    phase 3's stream with 4 slots (``MOE_GEOMETRY``), paged and
    contiguous: graphed serves against the uncaptured oracle, graphed
    prefill against its eager body, one prefill dispatch (of ``nbatch``
    1) per request, a profiled serve (flash's tensor-core body and the
    fused decode's, with the shares of device time of attention, GEMMs and
    routing), and a contiguous serve whose tokens must equal the paged
    serve's bit for bit. The expert FFN is the reference's single-device
    lowering: every expert runs over its capacity buffer, so a step reads
    every expert's weights."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import build
    from repro_torch.launch.serve import check_weights_fit
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServingEngine
    base = ARCHS[MOE_ARCH]
    cfg = base.for_device(dev)
    check(cfg.attention_impl == "cuda", "config did not select the kernels")
    check_weights_fit(cfg, torch.cuda.get_device_properties(dev).total_memory,
                      torch.cuda.get_device_name(dev))
    model = build_model(cfg, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize(dev)
    weights_gb = torch.cuda.memory_allocated(dev) / 1e9
    print(f"  {MOE_ARCH}: {base.n_layers} layers, "
          f"{base.param_count() / 1e9:.3f} B params "
          f"({base.active_param_count() / 1e9:.3f} B active a token), bf16: "
          f"{weights_gb:.2f} GB allocated, init {time.perf_counter() - t0:.1f}"
          f" s, init peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
          f" on {card}")
    stream = make_stream(cfg.vocab)
    pf = check_prefill_graphs(torch, dev, model, params, stream, MOE_ARCH,
                              card, geometry=MOE_GEOMETRY)
    eng = pf.pop("engine")
    check({nb for nb, _ in pf["keys"]} == {1}
          and {nb for nb, _ in eng._prefill_fns} == {1},
          f"{MOE_ARCH}: prefill keys {sorted(eng._prefill_fns)}")
    res = serve_variant(torch, dev, model, params, stream, MOE_ARCH,
                        SERVE_REPEATS[MOE_ARCH], geometry=MOE_GEOMETRY,
                        eng=eng)
    res["prefill"] = pf
    s = res["stats"]
    check(s["prefill_dispatches"] == s["admitted"] == len(stream),
          f"{MOE_ARCH}: {s['prefill_dispatches']} prefill dispatches for "
          f"{s['admitted']} admitted of {len(stream)}")
    # 4 requests: a profile of 8 held 711 k device events, and one flash
    # record of 384 was missing from each of 5 profiles
    prof = profile_variant(torch, dev, model, params, stream, MOE_ARCH,
                           geometry=MOE_GEOMETRY, eng=eng, n_reqs=4)
    del eng
    shares, busy = moe_shares(prof["by_name"])
    prof["shares"] = shares
    res["profile"] = prof
    print(f"  {MOE_ARCH} profile: {busy / 1e3:.1f} ms of device time over "
          f"{prof['steps']} decode steps and 4 prefill dispatches: "
          + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
          + f"; launches {prof['launches']} on {card}")
    geometry = dict(GEOMETRY, **MOE_GEOMETRY)
    lens = [len(p) for p, _ in stream]
    eng = ServingEngine(model, params, **dict(geometry, page_size=None))
    eng.warmup(prompt_lens=lens)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(stream)]
    build.reset_launch_counts()
    eng.serve(reqs)
    torch.cuda.synchronize(dev)
    cont = dict(build.launch_counts)
    st = eng.stats
    check(st["decode_traces"] == 1
          and st["graph_replays"] == st["decode_steps"] > 0,
          f"{MOE_ARCH} contiguous: {st['graph_replays']} replays for "
          f"{st['decode_steps']} steps")
    check(all(np.array_equal(r.tokens, t)
              for r, t in zip(reqs, res["served"])),
          f"{MOE_ARCH}: contiguous tokens differ from the paged serve's")
    check(cont["decode_attention"] > 0
          and cont["fused_paged_decode_attention"] == 0
          and cont["flash_attention"] > 0,
          f"{MOE_ARCH} contiguous: launches {cont}")
    del eng
    torch.cuda.empty_cache()
    for k, n in cont.items():
        res["launches"][k] = res["launches"].get(k, 0) + n
    print(f"  {MOE_ARCH} contiguous (page_size None): tokens equal the "
          f"paged serve's bit for bit; launches {cont}")
    for name in ("flash_attention", "fused_paged_decode_attention",
                 "decode_attention"):
        check(res["launches"][name] > 0,
              f"{name} was not launched on the {MOE_ARCH} path")
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"  {MOE_ARCH}: torch.cuda.max_memory_allocated "
          f"{res['peak_gb']:.2f} GB over the path on {card}")
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 11: the ssm engine's state rows (xlstm-1.3b at full width)

SSM_THRESHOLD = 64          # phase 11's chunked-prefill threshold


def rows_stream(vocab: int, n: int = 12, seed: int = 11):
    """Phase 11's stream: prompts of 16-160 tokens, 8-32 new tokens;
    shorter than phase 3's, since phase 11 serves it six times, once op by
    op."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(16, 161))
                          ).astype(np.int32), int(rng.integers(8, 33)))
            for _ in range(n)]
# phase 11's counts, predicted from lengths alone by a CPU run of
# ``phase_ssm_rows`` at reduced width (the stream drawn at the full
# vocabulary, its tokens taken mod the reduced one)
_RING = {"staged": 4, "inseg_admissions": 4, "preemptions": 0,
         "preempt_readmits": 0, "pressure_stalls": 0,
         "prefill_dispatches": 1, "chunk_admits": 6,
         "decode_dispatches": 15, "decode_steps": 230,
         "busy_slot_steps": 1333, "peak_concurrency": 8}
_FED = dict(_RING, prefill_dispatches=0, chunk_admits=8, decode_steps=234,
            busy_slot_steps=1420)
SSM_ROWS_PREDICTED = {
    "ring": _RING, "ring uncaptured": _RING, "fed": _FED,
    "fed, forced preempt": dict(_FED, preemptions=1, preempt_readmits=1,
                                decode_dispatches=17, decode_steps=267,
                                busy_slot_steps=1468)}


def ssm_serve(torch, dev, eng, stream, hook=None):
    """A streamed serve of ``stream`` on a warm engine; returns the
    requests, the counts it added and its wall seconds."""
    before = dict(eng.stats)
    t0 = time.perf_counter()
    reqs, chunks = stream_serve(eng, stream, hook)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    for r in reqs:
        check(r.tokens is not None and len(r.tokens) == r.max_new_tokens
              and chunks[r.rid] == [int(x) for x in r.tokens],
              f"request {r.rid}: tokens {r.tokens} or chunks")
    return reqs, {k: v - before[k] for k, v in eng.stats.items()}, wall


# phase 11's same-form check: f32 at full width, one group of layers (3
# mLSTM blocks and the sLSTM block; each layer's state starts on its own),
# a prompt of this many tokens fed one a step through decode from the
# empty state against the recurrent form's prefill of it. The same
# recurrence, its projections as GEMMs of other shapes: every state leaf
# within this share of the leaf's largest magnitude (5e-5 measured on the
# CPU at this width)
SSM_FORMS_LAYERS = 4
SSM_FORMS_LEN = 64
SSM_FORMS_RTOL = 1e-3
SSM_LEAVES = ("mC", "mn", "mm", "sh", "sc", "sn", "sm")


def ssm_reset_rows(torch, model, eng):
    """The rows a seat, a recovery and the step graph's ring refill write
    (the engine's ``_reset_rows``, one per leaf, batch axis leading)
    against the cells' own zero-token states (``_mlstm_state0``,
    ``slstm_state0``) at every layer, exactly, and against the reference's
    values: -1e30 stabilizers, the 1e-6 sLSTM normalizer, zeros
    elsewhere."""
    from repro_torch.models import xlstm as X
    cfg, rows = model.cfg, eng._reset_rows
    check(set(rows) == set(SSM_LEAVES), f"reset rows {sorted(rows)}")
    dev = rows["mC"].device
    own = (X._mlstm_state0(1, cfg.n_heads, cfg.head_dim, dev)
           + X.slstm_state0(1, cfg.d_model, dev))
    for name, ref in zip(SSM_LEAVES, own):
        got = rows[name]
        check(torch.equal(got, ref[:, None].expand_as(got)),
              f"reset row {name} is not the cells' zero-token state")
    neg, floor = float(np.float32(-1e30)), float(np.float32(1e-6))
    for name, want in (("mm", neg), ("sm", neg), ("sn", floor)):
        check(bool((rows[name] == want).all()),
              f"reset row {name} is not {want}")
    for name in ("mC", "mn", "sh", "sc"):
        check(not bool(rows[name].any()), f"reset row {name} is not 0")


def ssm_fed_forms(torch, dev, cfg, prompts):
    """f32, full width, ``SSM_FORMS_LAYERS`` layers, its own seeded
    weights: ``prompts`` (cut to ``SSM_FORMS_LEN`` tokens) fed one token a
    step through decode from ``empty_state`` (what a seated prompt goes
    through) against ``prefill_xlstm`` in the recurrent form (each cell
    from its own zero-token state): the next-token logits and all seven
    state leaves. Returns the largest gap of each, relative to the leaf's
    largest magnitude."""
    from repro_torch.models import build_model
    from repro_torch.models import xlstm as X
    cfg32 = dataclasses.replace(cfg, n_layers=SSM_FORMS_LAYERS,
                                dtype="float32", param_dtype="float32")
    m32 = build_model(cfg32, dev)
    p32 = m32.init(SEED)
    n = SSM_FORMS_LEN
    toks = torch.from_numpy(np.stack([p[:n] for p in prompts]).astype(
        np.int64)).to(dev)
    B = toks.shape[0]
    with torch.no_grad():
        want, wc = X.prefill_xlstm(m32.cfg, p32, toks, mode="recurrent")
        cache = m32.empty_state(B, n)
        for t in range(n):
            got, cache = m32.decode(p32, cache, toks[:, t:t + 1],
                                    torch.full((B,), t, dtype=torch.int32,
                                               device=dev))
    gaps = {"logits": ((got - want).abs().max()
                       / want.abs().max()).item()}
    for name in SSM_LEAVES:
        scale = wc[name].abs().max().clamp_min(1e-30)
        gaps[name] = ((cache[name] - wc[name]).abs().max() / scale).item()
    check(bool(torch.isfinite(got).all()), "fed forms: non-finite logits")
    check(max(gaps.values()) <= SSM_FORMS_RTOL,
          f"fed from the empty state against the recurrent prefill: "
          f"relative gaps {gaps} > {SSM_FORMS_RTOL}")
    del m32, p32
    return gaps


def ssm_alone(torch, dev, model, params, req, batch):
    """``req`` served alone: its prompt fed one token a step through
    ``model.decode`` from a fresh ``empty_state``, then greedy, with all
    ``batch`` rows alike (the engine's batch, so every product has the
    engine's shapes). Returns its generated tokens."""
    feed = [int(x) for x in req.prompt]
    cache = model.empty_state(batch, len(feed) + req.max_new_tokens)
    out = []
    with torch.no_grad():
        for t in range(len(feed) + req.max_new_tokens - 1):
            tok = feed[t] if t < len(feed) else out[-1]
            logits, cache = model.decode(
                params, cache,
                torch.full((batch, 1), tok, dtype=torch.int32, device=dev),
                torch.full((batch,), t, dtype=torch.int32, device=dev))
            if t + 1 >= len(feed):
                out.append(int(torch.argmax(logits[0, -1])))
    return np.array(out, np.int32)


def phase_ssm_rows(torch, dev, model, params, card, predicted=None,
                   stream=None):
    """xlstm-1.3b at full width: the engine's empty rows and what a seat,
    a recovery and the in-graph refill make of them.

    (a) A ring serve: the prompts straddle ``SSM_THRESHOLD`` (those past it
    are seated from the empty state and fed), ``PRESSURE_STAGE`` staging
    slots (the graph refills freed slots, resetting their rows to the
    empty state), against an uncaptured engine with the same knobs: the
    same tokens bit for bit. Its reset rows must be the cells' own
    zero-token states exactly (``ssm_reset_rows``). (b) A fed serve
    (``chunk_threshold=0``: every prompt seated and fed, the reason Queue
    C gives) uninterrupted, and the same with a forced ``preempt()``
    mid-serve: the preempted request recovers through a seat from the
    empty state to the uninterrupted tokens bit for bit, and so do the
    others. Every serve's counts must be ``predicted`` (the CPU
    rehearsal's, ``SSM_ROWS_PREDICTED``). (c) Two requests of the fed
    serve, the shortest one the graph refilled into a slot that held
    another request and the preempted one, equal the same request served
    alone from a fresh empty state, bit for bit (``ssm_alone``): a cell
    whose rows the refill left as they were would carry the earlier
    occupant's state into them. (d) The feed from the empty state against
    the recurrent prefill, in f32 (``ssm_fed_forms``). No output can see
    a zero stabilizer, so only (a)'s exact rows do: a cell's state is C
    and n scaled by exp(-m) and its output a ratio of the two, so with C
    and n at 0 the start of m cancels; and with m at -1e30 a stale C or n
    is scaled by exp(-1e30) = 0 at the first step. A reset that missed a
    cell's C and m alike changes the tokens, and (b) and (c) fail (a CPU
    rehearsal at reduced width with each of mC+mm and sc+sm left out of
    the reset). The stream is ``rows_stream``'s. Returns the phase's
    numbers."""
    from repro_torch.serving.engine import ServingEngine
    predicted = SSM_ROWS_PREDICTED if predicted is None else predicted
    stream = rows_stream(model.cfg.vocab) if stream is None else stream
    lens = [len(p) for p, _ in stream]
    ring = dict(GEOMETRY, chunk_threshold=SSM_THRESHOLD,
                stage_slots=PRESSURE_STAGE, stream=True)
    fed = dict(ring, chunk_threshold=0)
    n_over = sum(n > SSM_THRESHOLD for n in lens)
    counts = {}

    def run(cls, knobs, label, hook=None, rows=False):
        eng = cls(model, params, **knobs)
        eng.warmup(prompt_lens=lens)
        check(not eng._paged, f"{label}: paged")
        if rows:
            ssm_reset_rows(torch, model, eng)
        reqs, d, wall = ssm_serve(torch, dev, eng, stream, hook)
        counts[label] = {k: d[k] for k in PRESSURE_COUNTS}
        if cls is ServingEngine and dev.type == "cuda":
            check(d["graph_replays"] == d["decode_steps"] > 0
                  and eng.stats["decode_traces"] == 1,
                  f"{label}: {d['graph_replays']} replays for "
                  f"{d['decode_steps']} steps")
        del eng
        return reqs, d, wall

    r_ring, d_ring, w_ring = run(ServingEngine, ring, "ring", rows=True)
    # prompts over the threshold are seated (chunked admits) or staged
    # and refilled in the graph; the rest prefill
    check(0 < d_ring["chunk_admits"] <= n_over
          and d_ring["inseg_admissions"] > 0
          and d_ring["prefill_dispatches"] > 0,
          f"ring serve: {counts['ring']} for {n_over} prompts over "
          f"{SSM_THRESHOLD}")
    r_unc, _, _ = run(uncaptured_engine(), ring, "ring uncaptured")
    check(all(np.array_equal(a.tokens, b.tokens)
              for a, b in zip(r_ring, r_unc)),
          "ring serve: graphed tokens differ from the uncaptured body's")
    check(counts["ring uncaptured"] == counts["ring"],
          "ring serve: uncaptured counts differ")
    r_fed, d_fed, w_fed = run(ServingEngine, fed, "fed")
    forced = {}

    def hook(e):
        live = [s for s in range(e.max_batch) if e._slot_req[s] is not None
                and e._slot_pos[s] + 1 >= len(e._slot_prefix[s])]
        if "preempt" not in forced and e.stats["decode_steps"] >= 32 \
                and live:
            forced["preempt"] = e._slot_req[live[0]]
            e.preempt(live[0])

    r_pre, d_pre, _ = run(ServingEngine, fed, "fed, forced preempt", hook)
    p = forced.get("preempt")
    check(p is not None and p.preemptions >= 1
          and d_pre["preempt_readmits"] == d_pre["preemptions"] >= 1,
          f"forced preempt: {forced}, {counts['fed, forced preempt']}")
    check(all(np.array_equal(a.tokens, b.tokens)
              for a, b in zip(r_fed, r_pre)),
          "forced preempt: tokens differ from the uninterrupted serve's")
    print(f"  {SSM_ARCH} ring serve (threshold {SSM_THRESHOLD}, "
          f"{PRESSURE_STAGE} staging slots, page size inert): tokens equal "
          f"the uncaptured body's bit for bit; reset rows equal the cells' "
          f"zero-token states exactly; fed serve (threshold 0) with a "
          f"forced preempt of request {p.rid} after step 32: every token "
          f"equal to the uninterrupted serve's; {len(r_ring)} requests, "
          f"ring {sum(len(r.tokens) for r in r_ring) / w_ring:.1f} tok/s, "
          f"fed {sum(len(r.tokens) for r in r_fed) / w_fed:.1f} tok/s on "
          f"{card}")
    print(f"  {SSM_ARCH} phase 11 counts {counts}")
    if predicted:
        check(counts == predicted, f"phase 11 counts {counts} against the "
              f"CPU rehearsal's {predicted}")
    # (c) the ring refills of the fed serve take the requests past the
    # first max_batch, each into a slot another request held
    mb = GEOMETRY["max_batch"]
    refilled = min(r_fed[mb:], key=lambda r: len(r.prompt) + len(r.tokens))
    alone = {}
    for r in (refilled, r_fed[p.rid]):
        alone[r.rid] = ssm_alone(torch, dev, model, params, r, mb)
        check(np.array_equal(alone[r.rid], r.tokens),
              f"request {r.rid} of the fed serve differs from the same "
              f"request served alone from a fresh empty state")
    print(f"  {SSM_ARCH}: requests {sorted(alone)} of the fed serve (the "
          f"shortest refilled in the graph, the preempted one) equal each "
          f"served alone from a fresh empty state, bit for bit")
    # (d) the feed from the empty state against the recurrent prefill
    over = [q for q, _ in stream if len(q) >= SSM_FORMS_LEN][:8]
    gaps = ssm_fed_forms(torch, dev, model.cfg, over)
    print(f"  {SSM_ARCH} f32, {SSM_FORMS_LAYERS} layers: {len(over)} "
          f"prompts of {SSM_FORMS_LEN} tokens fed through decode from the "
          f"empty state against the recurrent prefill: relative gaps "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" (bound {SSM_FORMS_RTOL})")
    return dict(counts=counts, gaps=gaps, alone=sorted(alone),
                ring_tok_s=sum(len(r.tokens) for r in r_ring) / w_ring)


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
                                 pos_list=FUSED_LONG_POS),
              # zamba2-1.2b's shared block: K = 32 KV heads, G = 1
              phase_fused_decode(torch, dev, gen, K=32, G=1, D=64),
              # moonshot-v1-16b-a3b: K = 16, G = 1, D = 128, the write row
              # on span edges
              phase_fused_decode(torch, dev, gen, K=16, G=1, D=128,
                                 pos_list=FUSED_SPAN_POS)]
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
    # moonshot first, with nothing else on the card: its 57.8 GB of
    # weights, freed before the next path
    path_s = {}

    def timed(label, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        path_s[label] = time.perf_counter() - t1
        return out

    moe = timed(MOE_ARCH, phase_moe, torch, dev, card)
    bf16, int8 = timed("llama3.2-1b", phase_main_path, torch, dev, card)
    whisper = timed("whisper-base", phase_family, torch, dev,
                    "whisper-base", card)
    vision = timed("llama-3.2-vision-90b", phase_family, torch, dev,
                   "llama-3.2-vision-90b", card, VISION_LAYERS)
    hybrid = timed(HYBRID_ARCH, phase_hybrid, torch, dev, card)
    ssm = timed(SSM_ARCH, phase_ssm, torch, dev, card)
    paths = [moe, bf16, bf16["chunked"], int8, whisper, vision, hybrid, ssm]
    for k in kernels:
        k["launches"] = sum(r["launches"].get(k["name"], 0) for r in paths)
    for label, r in (("llama3.2-1b bf16", bf16),
                     (f"llama3.2-1b bf16 chunked ({CHUNK_THRESHOLD})",
                      bf16["chunked"]),
                     ("llama3.2-1b int8", int8), ("whisper-base", whisper),
                     (f"llama-3.2-vision-90b ({VISION_LAYERS} layers)",
                      vision), (HYBRID_ARCH, hybrid), (SSM_ARCH, ssm),
                     (MOE_ARCH, moe)):
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
        pf = r.get("prefill")
        if pf:
            print(f"  {label}: prefill {pf['ms']:.3f} ms a dispatch as "
                  f"graphs against {pf['eager_ms']:.3f} ms op by op; "
                  f"{pf['graphs']} prefill graphs, capture peak "
                  f"{pf['peak_gb']:.3f} GB on {card}")
    print("  phase 3 by path: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in path_s.items()))
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
    llama = bf16.pop("llama")
    pressure = phase_pressure(torch, dev, *llama, card)
    for k in kernels:
        k["launches"] += pressure["launches"][k["name"]]
    print(f"  phase 6 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("phase 7: prefix cache, host swap, contiguous layout (llama3.2-1b "
          "bf16, full width; whisper-base contiguous)")
    phase7 = phase_prefix_swap_layout(torch, dev, *llama, card,
                                      bf16["served"], pressure,
                                      whisper["served"])
    torch.cuda.empty_cache()
    for k in kernels:
        k["launches"] += phase7["launches"].get(k["name"], 0)
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("phase 8: the wall clock (ServingRuntime, two stepper threads on "
          "one card, a stepper fault, deadline enforcement; llama3.2-1b "
          "full width)")
    wall = phase_wall(torch, dev, card)
    for k in kernels:
        k["launches"] += wall["launches"][k["name"]]
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("phase 9: speculative decoding (llama3.2-1b full width, target "
          "attends in plain PyTorch, draft on the kernels)")
    spec = phase_spec(torch, dev, card, llama, bf16["tok_s"])
    del llama
    torch.cuda.empty_cache()
    for k in kernels:
        k["launches"] += spec["launches"].get(k["name"], 0)
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"phase 10: the hybrid engine's state rows under pressure "
          f"({HYBRID_ARCH} full width) and hybrid speculation (reduced)")
    hp = phase_hybrid_pressure(torch, dev, *hybrid.pop("hybrid"), card)
    torch.cuda.empty_cache()
    hs = phase_hybrid_spec(torch, dev, card)
    for k in kernels:
        k["launches"] += (hp["launches"].get(k["name"], 0)
                          + hs["launches"].get(k["name"], 0))
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"phase 11: the ssm engine's state rows ({SSM_ARCH} full width: "
          f"chunked seats, the staging ring, a forced preempt, the empty rows)")
    phase_ssm_rows(torch, dev, *ssm.pop("ssm")[:2], card)
    torch.cuda.empty_cache()
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
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
