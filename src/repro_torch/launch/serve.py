"""Cluster serving launcher of the port (``repro.launch.serve``).

Brings up the INFaaS control plane (master + workers + autoscalers) over an
H100 hardware catalog, registers the selected architectures, and drives a
Poisson workload:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --workers 2 --rate 50 --duration 60 --slo-ms 100

``--backend`` picks the data plane behind the workers:

* ``sim`` (default): profile-driven executors; any scale, no model
  execution and no device.
* ``real``: every worker runs an ``EngineExecutor`` on ``--device``
  (default CUDA; full width unless ``--reduced``): jobs execute for real on
  continuous-batching engines, measured service times drive the clock, and
  variant profiles are re-fit from the measurements (reported at the end).

``--clock wall`` (needs ``--backend real``) runs the control plane against
``RealClock`` as a long-running server: a seeded Poisson client submits
payload-carrying queries live, stepper threads drive the engines, and
tokens stream back per decode segment (TTFT is reported beside completion
latency). SIGINT drains in-flight work and exits cleanly:

    PYTHONPATH=src python -m repro_torch.launch.serve --backend real \\
        --clock wall --workers 1 --cpu-workers 0 --rate 2 --duration 30 \\
        --slo-ms 600000 --no-autoscale --device cpu --reduced

``--real-engine`` instead drives one continuous-batching engine directly
(no control plane) with a seeded mixed-length stream and reports measured
tokens/s and dispatch counts:

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
    PYTHONPATH=src python -m repro_torch.launch.serve --real-engine \\
        --device cpu --reduced --speculate int8:3
    PYTHONPATH=src python -m repro_torch.launch.serve --real-engine \\
        --device cpu --reduced --arch zamba2-1.2b --speculate llama3.2-1b:4

``--arch`` takes any registered arch for the real data plane: llama3.2-1b
(dense), zamba2-1.2b (hybrid), moonshot-v1-16b-a3b (moe), xlstm-1.3b (ssm:
no attention, so a page size is inert), whisper-base (audio) and
llama-3.2-vision-90b (vlm) among them. On CUDA the config selects the
kernel impls (flash prefill, fused paged decode, the paged and contiguous
decode kernels of the cross-attention and, with ``--quantize int8``, the
int8 GEMM; int8 is dense-only, as in ``repro``). A config whose weights do
not fit the card is refused before anything is allocated: the published
100-layer llama-3.2-vision-90b takes 175 GB in bf16, qwen3-moe-235b-a22b
463 GB. moonshot-v1-16b-a3b's 57.8 GB fit one 80 GB card. Weights are
random, made from a fixed seed on the device. The paged layout with pages
of 16 is the default; ``--page-size 0`` serves the contiguous KV layout.
With ``--prefix-cache`` half the requests of the engine demo open with one
shared template (a system prompt's stand-in), as in ``repro``.

``--speculate DRAFT[:K]`` (real data plane only) speculates with draft
DRAFT, ``int8`` (the int8 variant of the served arch) or another arch id
of the same vocabulary, K tokens a round (default 4). On CUDA the target
is built with ``ArchConfig.for_device(dev, speculate=True)``: its
attention runs in plain PyTorch (the verify window runs outside the fused
decode kernel, as the reference's runs in XLA), which the ``attn=`` of
the demo's line shows; the draft takes every kernel.
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
from repro_torch.core.api import QueryPayload, QuerySpec
from repro_torch.models import build_model
from repro_torch.models.quantize import quantize_params_dense
from repro_torch.models.transformer import DTYPES
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.sim.metrics import pct, steady_metrics


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
                      swap_budget_bytes: Optional[int] = None,
                      speculate: Optional[str] = None) -> dict:
    dev = resolve_device(device)
    base = ARCHS[arch].reduced() if reduced else ARCHS[arch]
    if quantize != "none" and base.family != "dense":
        raise ValueError(f"--quantize {quantize}: the int8 variants are "
                         f"dense-only; {arch} is {base.family}")
    cfg = dataclasses.replace(base, quantize=quantize).for_device(
        dev, speculate=speculate is not None)
    if dev.type == "cuda":
        check_weights_fit(cfg, torch.cuda.get_device_properties(
            dev).total_memory, torch.cuda.get_device_name(dev))
    model = build_model(cfg, dev)
    fp_params = params = model.init(seed)
    if quantize == "int8":
        # weight-only int8 variant: projections quantized from the fp init
        params = quantize_params_dense(params)
    spec_kwargs = {}
    if speculate is not None:
        dname, _, ks = speculate.partition(":")
        if dname == "int8":
            # the int8 variant of the same arch: the same weights but for
            # rounding, so its argmaxes track the target closely
            dm = build_model(dataclasses.replace(
                base, quantize="int8").for_device(dev), dev)
            dp = quantize_params_dense(fp_params)
        else:
            dbase = ARCHS[dname].reduced() if reduced else ARCHS[dname]
            dm = build_model(dbase.for_device(dev), dev)
            dp = dm.init(seed + 1)
        spec_kwargs = dict(speculate=(dm, dp), spec_k=int(ks) if ks else 4)
    eng = ServingEngine(model, params, max_batch=slots, max_len=max_len,
                        decode_block=16, page_size=page_size,
                        n_pages=n_pages, chunk_threshold=chunk_threshold,
                        stage_slots=stage_slots, admission=admission,
                        preempt_policy=preempt_policy,
                        prefix_cache=prefix_cache, prefix_evict=prefix_evict,
                        swap=swap, swap_budget_bytes=swap_budget_bytes,
                        **spec_kwargs)
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
          f"{s['prefill_traces']} prefill programs, "
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
    if eng._spec is not None:
        print(f"  speculative decode (k={eng.spec_k}, draft "
              f"{eng._spec.model.cfg.name} attn="
              f"{eng._spec.model.cfg.attention_impl}): "
              f"{s['spec_rounds']} rounds, {s['spec_accepted']}/"
              f"{s['spec_proposed']} draft tokens accepted (rate "
              f"{eng.occupancy['spec_accept_rate']:.2f}), "
              f"{eng._spec.stats['resyncs']} draft resyncs")
    return {"tokens": toks, "wall_s": wall, "stats": dict(s)}


def _serve_wall(c, arch_names, vocabs, args) -> None:
    """Long-running wall-clock server: a seeded Poisson client submits
    payload-carrying queries on the RealClock scheduler thread, tokens
    stream back per decode segment, and SIGINT (or the duration horizon)
    drains in-flight work before a clean exit."""
    import signal
    import threading

    rng = np.random.default_rng(0)
    # the payload fits the default engine (max_len 32): several decode
    # segments a request, so TTFT precedes completion
    prompt_lens = (4, 13)
    max_new = 8
    handles: list = []
    streamed = {"chunks": 0, "tokens": 0}
    stop = threading.Event()
    loop = c.loop

    def on_sigint(signum, frame):
        print("\nSIGINT: draining in-flight work...", flush=True)
        stop.set()

    prev = signal.signal(signal.SIGINT, on_sigint)

    def count(chunk):
        streamed["chunks"] += 1
        streamed["tokens"] += len(chunk.tokens)

    def fire():
        # runs on the scheduler thread: the master's dispatch is one more
        # clock callback, so nothing crosses threads here
        if stop.is_set():
            return
        a = arch_names[int(rng.integers(len(arch_names)))]
        prompt = rng.integers(
            0, vocabs[a],
            size=int(rng.integers(*prompt_lens))).astype(np.int32)
        h = c.api.submit(QuerySpec.arch(
            a, latency_ms=args.slo_ms,
            payload=QueryPayload.of([prompt], max_new_tokens=max_new)))
        h.on_tokens(count)
        handles.append(h)

    # seeded Poisson arrivals over [0, duration), scheduled up front on
    # the wall clock (the scheduler thread fires them as time passes)
    t0 = loop.now()
    t = float(rng.exponential(1.0 / max(args.rate, 1e-9)))
    n_arrivals = 0
    while t < args.duration:
        loop.schedule_at(t0 + t, fire)
        n_arrivals += 1
        t += float(rng.exponential(1.0 / max(args.rate, 1e-9)))
    print(f"wall-clock server up [{'/'.join(arch_names)} on "
          f"{c.executors[0].device if c.executors else 'no device'}]: "
          f"{n_arrivals} arrivals over {args.duration:.0f} s; SIGINT drains",
          flush=True)

    while not stop.is_set():
        if loop.now() - t0 >= args.duration and \
                all(h.done for h in list(handles)):
            break
        time.sleep(0.05)

    # drain: queries already in the system stream out; SIGINT only stops
    # new arrivals (fire checks the flag)
    deadline = time.monotonic() + 30.0
    while not all(h.done for h in list(handles)):
        if time.monotonic() >= deadline:
            print("drain timeout: abandoning remaining work", flush=True)
            break
        time.sleep(0.05)
    for ex in getattr(c, "executors", []):
        ex.shutdown()
    loop.shutdown()
    signal.signal(signal.SIGINT, prev)

    done = [h for h in handles if h.done]
    results = [h.result(timeout=0.001) for h in done]
    ok = [r for r in results if r.ok]
    ttfts = [h.ttft for h in done if h.ttft is not None]
    lats = [r.latency for r in ok]
    wall = loop.now() - t0
    print(f"wall-clock serve [{'/'.join(arch_names)}]: "
          f"{n_arrivals} arrivals, {len(handles)} submitted, "
          f"{len(ok)} completed ok, "
          f"{sum(1 for r in results if r.failed)} failed "
          f"in {wall:.1f}s wall ({len(ok) / max(wall, 1e-9):.2f} q/s)")
    print(f"streamed: {streamed['tokens']} tokens in "
          f"{streamed['chunks']} chunks across {len(done)} queries")
    if ttfts and lats:
        print(f"TTFT p50={pct(ttfts, 50) * 1e3:.0f}ms "
              f"p99={pct(ttfts, 99) * 1e3:.0f}ms | completion "
              f"p50={pct(lats, 50) * 1e3:.0f}ms "
              f"p99={pct(lats, 99) * 1e3:.0f}ms")
    print("clean shutdown: drained in-flight work", flush=True)


def _validate(args) -> None:
    """The reference launcher's flag checks, with its messages (the paged
    layout is the port's default: ``--page-size 0`` takes the contiguous
    one, where the reference leaves ``--page-size`` out)."""
    contiguous = args.page_size == 0
    if args.speculate is not None:
        dname, _, ks = args.speculate.partition(":")
        if not dname or (ks and not ks.isdigit()):
            raise SystemExit("--speculate takes DRAFT[:K], e.g. 'int8:4' "
                             "or 'llama3.2-1b:7'")
    if args.backend != "real" and not args.real_engine and \
            (args.speculate is not None or args.quantize != "none"):
        raise SystemExit(
            "--speculate/--quantize reshape the real decode loop; combine "
            "them with --backend real or --real-engine (the sim backend "
            "has no decode loop to speculate in and no weights to "
            "quantize)")
    if args.swap_budget_mb is not None and args.swap is None:
        raise SystemExit("--swap-budget-mb bounds the host swap buffer; "
                         "it needs --swap host")
    # the port's engine demo takes --swap (the reference's does not), so
    # only the sim backend refuses it; --breaker and --deadline-enforce
    # act through the control plane, which --real-engine bypasses
    if (args.swap is not None and args.backend != "real"
            and not args.real_engine) \
            or ((args.breaker or args.deadline_enforce)
                and (args.backend != "real" or args.real_engine)):
        raise SystemExit(
            "--swap/--breaker/--deadline-enforce wire the control plane "
            "to the real data plane (host KV swap, engine pressure "
            "signals, engine-level cancellation); combine them with "
            "--backend real (the sim backend has no KV bytes to swap and "
            "no decode loop to cancel, and --real-engine bypasses the "
            "control plane)")
    if args.deadline_enforce and args.clock != "wall":
        raise SystemExit(
            "--deadline-enforce cancels overdue engine slots from the "
            "threaded stepper, which only exists under --clock wall; on "
            "the virtual clock it would be silently inert")
    if args.n_pages is not None and contiguous:
        raise SystemExit("--n-pages sizes the paged KV pool; it needs "
                         "--page-size above 0 (contiguous engines have no "
                         "pool)")
    if args.admission == "optimistic" and contiguous:
        raise SystemExit("--admission optimistic over-commits the paged "
                         "KV pool; it needs --page-size above 0 "
                         "(contiguous engines reserve whole slots and "
                         "cannot over-commit)")
    if args.prefix_cache and contiguous:
        raise SystemExit("--prefix-cache shares prompt prefixes at page "
                         "granularity; it needs --page-size above 0 "
                         "(contiguous slot rows have no pages to share)")
    if args.clock == "wall" and (args.backend != "real"
                                 or args.real_engine):
        raise SystemExit("--clock wall runs the control plane in real "
                         "time against live engines; it needs --backend "
                         "real (the sim executor resolves service times "
                         "instantly and has nothing to do on a wall "
                         "clock, and --real-engine bypasses the control "
                         "plane entirely)")
    if not args.real_engine and args.backend != "real" and (
            args.page_size is not None or args.n_pages is not None
            or args.chunk_threshold is not None or args.stage_slots
            or args.admission != "worstcase" or args.prefix_cache):
        raise SystemExit(
            "--page-size/--n-pages/--chunk-threshold/--stage-slots/"
            "--admission/--prefix-cache configure the real data plane; "
            "combine them with --backend real or --real-engine (the sim "
            "backend has no KV cache to page and no decode loop to "
            "refill)")
    if args.backend == "real" and not args.real_engine and \
            args.arch == "all":
        raise SystemExit("--backend real needs a single --arch "
                         "(each arch builds real model params)")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="architecture id, or 'all' (sim backend)")
    ap.add_argument("--backend", choices=["sim", "real"], default="sim",
                    help="worker data plane: profiled t(b) models (sim) or "
                         "real engines on --device (real)")
    ap.add_argument("--clock", choices=["virtual", "wall"],
                    default="virtual",
                    help="virtual: discrete-event simulation of time; "
                         "wall: long-running server on RealClock with "
                         "threaded engine stepping and token streaming "
                         "(needs --backend real)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--cpu-workers", type=int, default=1)
    ap.add_argument("--rate", type=float, default=50.0, help="queries/s")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--slo-ms", type=float, default=100.0)
    ap.add_argument("--no-autoscale", action="store_true")
    ap.add_argument("--hedge", action="store_true",
                    help="enable hedged-request straggler mitigation")
    ap.add_argument("--breaker", action="store_true",
                    help="health-aware routing: per-worker circuit "
                         "breaker fed by dispatch failures, engine "
                         "pressure signals and heartbeat staleness; real "
                         "backend only")
    ap.add_argument("--deadline-enforce", action="store_true",
                    help="cancel queries past their SLO deadline at the "
                         "engine (frees their pages at once; the result "
                         "carries a timed-out verdict); real backend, "
                         "wall clock")
    ap.add_argument("--real-engine", action="store_true",
                    help="drive one engine directly, without the control "
                         "plane")
    ap.add_argument("--real-reqs", type=int, default=32)
    ap.add_argument("--real-slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged KV page size in positions (default 16; 0: "
                         "the contiguous layout)")
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
    ap.add_argument("--speculate", default=None, metavar="DRAFT[:K]",
                    help="speculative decoding: draft DRAFT ('int8' = the "
                         "int8 variant of the served arch, or another arch "
                         "id) proposes K tokens a round (default 4); real "
                         "data plane only")
    ap.add_argument("--chunk-threshold", type=int, default=None,
                    help="chunk prompts longer than this through the "
                         "decode segments (dense family; clamped off for "
                         "audio and vlm)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the real data plane runs (the sim backend "
                         "needs no device)")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized configs instead of the full width")
    args = ap.parse_args(argv)
    _validate(args)
    page_size = 16 if args.page_size is None else (args.page_size or None)
    swap_budget = (None if args.swap_budget_mb is None
                   else args.swap_budget_mb << 20)
    if args.real_engine:
        resolve_device(args.device)
        _real_engine_demo(args.arch, args.real_reqs, args.real_slots,
                          page_size=page_size, quantize=args.quantize,
                          device=args.device, reduced=args.reduced,
                          chunk_threshold=args.chunk_threshold,
                          n_pages=args.n_pages,
                          stage_slots=args.stage_slots,
                          admission=args.admission,
                          preempt_policy=args.preempt_policy,
                          prefix_cache=args.prefix_cache,
                          prefix_evict=args.prefix_evict, swap=args.swap,
                          swap_budget_bytes=swap_budget,
                          speculate=args.speculate)
        return

    from repro_torch.core.master import MasterConfig
    from repro_torch.sim.cluster import make_cluster
    from repro_torch.sim.workload import poisson_arrivals
    archs = None if args.arch == "all" else [ARCHS[args.arch]]
    cfg = MasterConfig(hedge_enabled=args.hedge,
                       breaker_enabled=args.breaker)
    engine_cfg = None
    if args.backend == "real":
        from repro_torch.serving.executor import EngineExecutorConfig
        resolve_device(args.device)
        engine_cfg = EngineExecutorConfig(
            page_size=page_size, n_pages=args.n_pages,
            chunk_threshold=args.chunk_threshold,
            stage_slots=args.stage_slots, admission=args.admission,
            preempt_policy=args.preempt_policy,
            prefix_cache=args.prefix_cache, prefix_evict=args.prefix_evict,
            quantize=args.quantize, swap=args.swap,
            swap_budget_bytes=swap_budget,
            deadline_enforce=args.deadline_enforce,
            speculate=args.speculate)
    c = make_cluster(n_accel=args.workers, n_cpu=args.cpu_workers,
                     archs=archs, autoscale=not args.no_autoscale, cfg=cfg,
                     backend=args.backend, engine_cfg=engine_cfg,
                     clock=args.clock, device=args.device,
                     reduced=args.reduced)
    arch_names = [args.arch] if args.arch != "all" else list(ARCHS)

    if args.clock == "wall":
        vocabs = {a: (ARCHS[a].reduced() if args.reduced else ARCHS[a]).vocab
                  for a in arch_names}
        _serve_wall(c, arch_names, vocabs, args)
        return

    rng = np.random.default_rng(0)

    def fire(t):
        a = arch_names[rng.integers(len(arch_names))]
        c.api.submit(QuerySpec.arch(a, latency_ms=args.slo_ms))

    poisson_arrivals(c.loop, lambda t: args.rate, fire,
                     t_end=args.duration, seed=0)
    c.run_until(args.duration + 30.0)
    m = steady_metrics(c.master.metrics, 0.0, args.duration + 30.0,
                       warmup=min(20.0, args.duration / 3.0))
    print(f"served={m['completed']} thr={m['throughput_qps']:.1f} q/s "
          f"viol={m['violation_rate']:.3f} p50={m['p50_ms']:.1f}ms "
          f"p99={m['p99_ms']:.1f}ms")
    alive = sum(1 for w in c.store.workers.values() if w.alive)
    print(f"workers alive at end: {alive}")
    if args.backend == "real":
        measured = [v for v in c.store.registry.variants.values()
                    if v.profile.source == "measured"]
        for v in measured:
            print(f"measured profile {v.name}: "
                  f"t(b) = {v.profile.m * 1e3:.2f}ms*b + "
                  f"{v.profile.c * 1e3:.2f}ms")
        print(f"variants re-fit from real measurements: {len(measured)}")


if __name__ == "__main__":
    main()
