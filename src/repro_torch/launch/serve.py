"""Standalone data-plane launcher of the port (``repro.launch.serve
--real-engine``).

Drives one continuous-batching engine directly — no control plane — with a
seeded mixed-length request stream and reports measured tokens/s and
dispatch counts:

    PYTHONPATH=src python -m repro_torch.launch.serve --real-engine --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --real-engine \\
        --arch whisper-base --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --real-engine \\
        --device cpu --reduced --chunk-threshold 12
    PYTHONPATH=src python -m repro_torch.launch.serve --real-engine \\
        --device cpu --reduced --n-pages 24 --stage-slots 4 \\
        --admission optimistic --preempt-policy lru
    PYTHONPATH=src python -m repro_torch.launch.serve --real-engine \\
        --device cpu --reduced --prefix-cache --n-pages 24 \\
        --admission optimistic --swap host --swap-budget-mb 64
    PYTHONPATH=src python -m repro_torch.launch.serve --real-engine \\
        --device cpu --reduced --page-size 0

``--arch`` takes llama3.2-1b (dense), whisper-base (audio) and
llama-3.2-vision-90b (vlm). On CUDA the config selects the kernel impls
(flash prefill, fused paged decode, the paged and contiguous decode kernels
of the cross-attention and, with ``--quantize int8``, the int8 GEMM; int8
is dense-only, as in ``repro``). A config whose weights do not fit the card
is refused before anything is allocated: the published 100-layer
llama-3.2-vision-90b takes 175 GB in bf16. Weights are random, made from a
fixed seed on the device. The control plane (``--backend``, ``--clock`` and
the Poisson cluster run) is not ported yet. ``--page-size 0`` serves the
contiguous KV layout. With ``--prefix-cache`` half the requests open with
one shared template (a system prompt's stand-in), as in ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS
from repro_torch.models import build_model
from repro_torch.models.quantize import quantize_params_dense
from repro_torch.models.transformer import DTYPES
from repro_torch.serving.engine import Request, ServingEngine


def check_weights_fit(cfg, capacity_bytes: int, where: str) -> None:
    """Refuse a config whose weights alone exceed the device's memory."""
    need = cfg.param_count() * DTYPES[cfg.param_dtype].itemsize
    if need > capacity_bytes:
        raise ValueError(
            f"{cfg.name}: its weights take {need / 1e9:.1f} GB "
            f"({cfg.param_count()} parameters in {cfg.param_dtype}) but "
            f"{where} holds {capacity_bytes / 1e9:.1f} GB")


def _real_engine_demo(arch: str, n_reqs: int, slots: int,
                      page_size: Optional[int] = 16,
                      quantize: str = "none",
                      device="cuda", reduced: bool = False,
                      max_len: int = 64, seed: int = 0,
                      chunk_threshold: Optional[int] = None,
                      n_pages: Optional[int] = None, stage_slots: int = 0,
                      admission: str = "worstcase",
                      preempt_policy: str = "slack",
                      prefix_cache: bool = False, prefix_evict: str = "lru",
                      swap: Optional[str] = None,
                      swap_budget_bytes: Optional[int] = None) -> dict:
    dev = resolve_device(device)
    base = ARCHS[arch].reduced() if reduced else ARCHS[arch]
    if quantize != "none" and base.family != "dense":
        raise ValueError(f"--quantize {quantize}: the int8 variants are "
                         f"dense-only; {arch} is {base.family}")
    cfg = dataclasses.replace(base, quantize=quantize).for_device(dev)
    if dev.type == "cuda":
        check_weights_fit(cfg, torch.cuda.get_device_properties(
            dev).total_memory, torch.cuda.get_device_name(dev))
    model = build_model(cfg, dev)
    params = model.init(seed)
    if quantize == "int8":
        # weight-only int8 variant: projections quantized from the fp init
        params = quantize_params_dense(params)
    eng = ServingEngine(model, params, max_batch=slots, max_len=max_len,
                        decode_block=16, page_size=page_size,
                        n_pages=n_pages, chunk_threshold=chunk_threshold,
                        stage_slots=stage_slots, admission=admission,
                        preempt_policy=preempt_policy,
                        prefix_cache=prefix_cache, prefix_evict=prefix_evict,
                        swap=swap, swap_budget_bytes=swap_budget_bytes)
    rng = np.random.default_rng(seed)
    # with the prefix cache on, half the requests open with one template
    tpl = (rng.integers(0, cfg.vocab, size=24).astype(np.int32)
           if prefix_cache else None)

    def prompt(i):
        body = rng.integers(0, cfg.vocab,
                            size=int(rng.integers(4, 29))).astype(np.int32)
        if tpl is not None and i % 2 == 0:
            # stays inside max_len 64 with max_new up to 32
            return np.concatenate([tpl, body])[:32]
        return body

    reqs = [Request(rid=i, prompt=prompt(i),
                    max_new_tokens=int(rng.integers(4, 33)))
            for i in range(n_reqs)]
    eng.warmup(prompt_lens=[len(r.prompt) for r in reqs])
    t0 = time.perf_counter()
    eng.serve(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in reqs)
    s = eng.stats
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    layout = (f"paged {eng.n_pages}x{eng.page_size}" if eng._paged
              else "contiguous")
    print(f"real engine [{cfg.name} {cfg.quantize} attn={cfg.attention_impl}"
          f" on {where}] ({layout}): "
          f"{len(reqs)} reqs / {toks} tokens in {wall * 1e3:.1f} ms = "
          f"{toks / wall:.0f} tok/s ({s['prefill_dispatches']}+"
          f"{s['decode_dispatches']} dispatches, "
          f"{s['decode_traces']} captured step graphs, peak "
          f"{s['peak_concurrency']} slots, {s['chunk_admits']} chunked "
          f"admits, {s['inseg_admissions']} in-segment admits, "
          f"{s['preemptions']} preemptions, segment occupancy "
          f"{eng.occupancy['slot_busy_frac']:.2f})")
    if eng.admission == "optimistic" or eng.stage_slots:
        print(f"  admission {eng.admission} (victims by "
              f"{eng.preempt_policy}), staging ring {eng.stage_slots}: "
              f"{s['staged']} staged, {s['preempt_readmits']} preempted "
              f"requests re-admitted, {s['pressure_stalls']} pressure "
              f"stalls")
    if eng._prefix is not None:
        print(f"  prefix cache: {s['prefix_hits']} hits, "
              f"{s['prefix_pages_reused']} pages reused, "
              f"{s['prefix_tokens_skipped']} prefill tokens skipped, "
              f"{s['cow_copies']} COW copies, {s['evictions']} evictions")
    if eng.swap is not None:
        print(f"  host swap: {s['swap_out']} out, {s['swap_in']} in, "
              f"{s['swap_fallbacks']} fallbacks to recompute, "
              f"{s['swap_bytes']} bytes")
    return {"tokens": toks, "wall_s": wall, "stats": dict(s)}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--real-engine", action="store_true",
                    help="drive one engine directly (the only mode ported)")
    ap.add_argument("--real-reqs", type=int, default=32)
    ap.add_argument("--real-slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged KV page size in positions (0: the "
                         "contiguous layout)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="paged KV pool size in pages (default: every slot "
                         "at max_len)")
    ap.add_argument("--stage-slots", type=int, default=0,
                    help="in-segment admission: device staging ring "
                         "capacity (0 = boundary-only admission; clamped "
                         "off for audio and vlm)")
    ap.add_argument("--admission", choices=["worstcase", "optimistic"],
                    default="worstcase",
                    help="paged admission control: reserve worst-case "
                         "pages, or admit on expected usage and preempt "
                         "under pressure (dense only)")
    ap.add_argument("--preempt-policy", choices=["slack", "lru"],
                    default="slack",
                    help="optimistic-admission victim choice: most SLO "
                         "slack, or the most recently admitted")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share common prompt prefixes at page "
                         "granularity, copy on write (dense, paged)")
    ap.add_argument("--prefix-evict", choices=["lru", "fifo"],
                    default="lru",
                    help="which cached prefix page a dry pool reclaims")
    ap.add_argument("--swap", choices=["host"], default=None,
                    help="copy a preempted request's KV pages to host "
                         "memory and restore them at re-admission instead "
                         "of replaying its prefix (paged)")
    ap.add_argument("--swap-budget-mb", type=int, default=None,
                    help="cap on parked host-swapped KV bytes; past it a "
                         "victim recomputes (needs --swap host)")
    ap.add_argument("--quantize", choices=["none", "int8"], default="none")
    ap.add_argument("--chunk-threshold", type=int, default=None,
                    help="chunk prompts longer than this through the "
                         "decode segments (dense family; clamped off for "
                         "audio and vlm)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized config instead of the full width")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if not args.real_engine:
        ap.error("only --real-engine is ported; the control plane "
                 "(--backend/--clock) comes in a later slice")
    if args.swap_budget_mb is not None and args.swap is None:
        ap.error("--swap-budget-mb bounds the host swap buffer; it needs "
                 "--swap host")
    _real_engine_demo(args.arch, args.real_reqs, args.real_slots,
                      page_size=args.page_size or None,
                      quantize=args.quantize,
                      device=args.device, reduced=args.reduced,
                      chunk_threshold=args.chunk_threshold,
                      n_pages=args.n_pages, stage_slots=args.stage_slots,
                      admission=args.admission,
                      preempt_policy=args.preempt_policy,
                      prefix_cache=args.prefix_cache,
                      prefix_evict=args.prefix_evict, swap=args.swap,
                      swap_budget_bytes=(None if args.swap_budget_mb is None
                                         else args.swap_budget_mb << 20))


if __name__ == "__main__":
    main()
