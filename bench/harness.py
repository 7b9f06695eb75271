"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names its configuration (``bench/configs/<file>``) and its traffic mix
(``bench/traffic/<mix>.json``); its check limit sits in
``bench/cells/<cell>.json``, its reference in ``bench/reference/<name>.py``
as the configuration names it, and every metric it reports is read by
``bench/metrics/<metric>.py`` (else the reader of the name's first part,
``mfu`` for ``mfu.open``). Adding a cell, a mix, a configuration or a
metric adds files and entries and edits none.

The timed path is the port's model-less user path on the wall clock:
``ServingRuntime.submit`` of ``QuerySpec.arch`` queries, the ``Master``'s
selection, the ``Worker``, the ``ThreadedEngineExecutor`` and its
``ServingEngine``. Set-up draws the weights from the seed on the device,
hands them to the executor's model cache (the int8 tree is the port's own
quantization of them), loads the configuration's variant, warms it for the
cell's prompt lengths, and sends one query through the whole path. A
closed loop's window opens once its clients' first queries are queued
behind a short lead-in query (``ramp``), so that it starts on a full job
and not on the first query served alone to its end. Model
autoscaling stays out of the window: no autoscaler runs and the workers'
monitor tick (and the master's heartbeat sweep, which shares its period)
falls after the run.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import gc
import importlib.util
import itertools
import json
import os
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from bench import costs, workload

ROOT = Path(__file__).resolve().parents[1]
DRAIN_S = 60.0          # a minute past the close for the last answers
MONITOR_OFF = 1e6       # the workers' monitor period: after any run
WATCHDOG_S = 1150.0     # a hung run's end
SPAN_S = 2.0            # the profiled span's length
ARM_S = 30.0            # it opens at a prefill of the window's last 30 s
SAMPLE = 12             # answers the check compares, the longest among them
LEAD_TOKENS = 48        # a closed loop's lead-in query (``ramp``): its job
                        # outlasts the clients' first sends
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


class CellError(Exception):
    """A cell whose files or entries are missing or malformed."""


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict              # the workload entry
    config: dict            # the configuration file
    mix: dict               # the traffic mix
    checks: dict            # the cell's check limits
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in confs:
        raise CellError(f"no configuration {w['config']!r}")
    cfg = json.loads((root / confs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    checks = json.loads((root / "bench" / "cells"
                         / f"{name}.json").read_text())

    def mine(m: dict) -> bool:
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and ("workloads" in m or m["moves"] in moved)]
    return Cell(name, w, cfg, mix, checks, e2e, layer, root)


def _load(path: Path, prefix: str):
    """The module of a file, loaded once a path."""
    name = f"{prefix}_{abs(hash(str(path)))}"
    if name not in sys.modules:
        if not path.exists():
            raise CellError(f"no file {path}")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read(run)`` of metric ``name``: ``metrics/<name>.py``, else
    the reader of the name's part before its first dot."""
    d = root / "bench" / "metrics"
    path = d / f"{name}.py"
    if not path.exists():
        path = d / f"{name.split('.')[0]}.py"
    return _load(path, "bench_metric").read


def reference(cell: "Cell"):
    """The plain reference module the cell's configuration names."""
    return _load(cell.root / "bench" / "reference"
                 / f"{cell.config['reference']}.py", "bench_reference")


# ---------------------------------------------------------------------------
# the client's record


@dataclasses.dataclass
class Query:
    prompt: np.ndarray
    max_new: int
    due: float                       # monotonic seconds
    sent: float = -1.0
    chunks: List[tuple] = dataclasses.field(default_factory=list)
    done: float = -1.0               # the handle completed
    ok: bool = False
    outputs: Optional[np.ndarray] = None

    @property
    def plen(self) -> int:
        return len(self.prompt)

    def first(self) -> Optional[float]:
        return self.chunks[0][0] if self.chunks else None

    def last(self) -> Optional[float]:
        """When the last of its tokens arrived (None if it never did)."""
        n = sum(k for _, k in self.chunks)
        return self.chunks[-1][0] if self.chunks and n >= self.max_new \
            else None

    def tokens(self):
        """(arrival time, output index) of every token that arrived."""
        i = 0
        for t, k in self.chunks:
            for _ in range(k):
                yield t, i
                i += 1


@dataclasses.dataclass
class Run:
    """What a reader reads: the cell, the client's record of every query,
    the engine's counters at the window's edges, and the profiled span."""
    cell: Cell
    seconds: float
    t0: float                        # the window opens (monotonic)
    t1: float                        # the window closes
    t_read: float                    # the engine metrics read [t0, t_read)
    t_end: float                     # the last answer was awaited until
    setup_s: float
    queries: List[Query]
    counters: Dict[str, dict]        # "t0"/"read" -> engine stats, timing
    span: Any = None                 # trace.Span of a --trace 1 run
    costs: Any = costs

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def loop(self) -> str:
        return self.cell.mix["loop"]

    def delta(self, key: str) -> float:
        """An engine counter's growth over [t0, t_read)."""
        return self.counters["read"][key] - self.counters["t0"][key]

    def tokens_in(self, a: float, b: float):
        """(query, output index) of every token that arrived in [a, b)."""
        for q in self.queries:
            for t, i in q.tokens():
                if a <= t < b:
                    yield q, i


# ---------------------------------------------------------------------------
# set-up


def process_age() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) \
            - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of a configuration file: the registry's
    architecture (its family and name, which name the variants) at the
    file's sizes."""
    from repro_torch.configs.registry import ARCHS
    return dataclasses.replace(
        ARCHS[cfg["arch"]], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), dtype=cfg["torch_dtype"],
        param_dtype=cfg["torch_dtype"])


def engine_counters(eng) -> dict:
    """A copy of the engine's counters (every key exists from its start)."""
    out = {f"stats.{k}": v for k, v in eng.stats.items()}
    out.update({f"timing.{k}": v for k, v in eng.timing.items()})
    return out


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Ctx:
    """A cluster set up for one cell, between its windows."""
    cell: Cell
    dev: Any
    cluster: Any
    runtime: Any
    executor: Any
    engine: Any
    params: dict
    spec: Callable
    mono_off: float          # monotonic time minus the control plane's


def setup(cell: Cell, seed: int, dev, lengths, trace: bool = False,
          log=lambda msg: None) -> Ctx:
    """Draw the weights, build the one-worker wall-clock cluster, load and
    warm the configuration's variant for prompt ``lengths``, and send one
    query through the whole path. Logs how long each phase took."""
    import torch
    from repro_torch.core.api import QueryPayload, QuerySpec
    from repro_torch.core.master import MasterConfig
    from repro_torch.core.worker import WorkerConfig
    from repro_torch.models.model import build_model
    from repro_torch.models.quantize import quantize_params_dense
    from repro_torch.serving.executor import EngineExecutorConfig
    from repro_torch.serving.runtime import ServingRuntime
    from repro_torch.sim.cluster import make_cluster

    marks = [("", time.monotonic())]

    def mark(name: str) -> None:
        sync(dev)
        marks.append((name, time.monotonic()))

    cfg = cell.config
    arch = arch_config(cfg)
    params = reference(cell).make_params(cfg, seed, dev,
                                        getattr(torch, cfg["torch_dtype"]))
    mark("weights")
    c = make_cluster(
        n_accel=1, archs=[arch], autoscale=False,
        cfg=MasterConfig(worker_autoscale=False,
                         worker=WorkerConfig(monitor_period=MONITOR_OFF)),
        backend="real", clock="wall", device=dev,
        engine_cfg=EngineExecutorConfig(**cfg["engine"]))
    (ex,) = c.executors
    (worker,) = c.master.workers.values()
    variant = c.store.registry.variants[cfg["variant"]]
    int8 = cfg["quantize"] == "int8"
    if int8 != (variant.framework == "torch-int8"):
        raise CellError(f"variant {variant.name} against quantize "
                        f"{cfg['quantize']!r}")
    ex._models[arch.name] = (build_model(arch.for_device(dev), dev), params)
    if int8:
        qarch = dataclasses.replace(arch, quantize="int8")
        ex._models[f"{arch.name}::int8"] = (
            build_model(qarch.for_device(dev), dev),
            quantize_params_dense(params))
    mark("cluster and models")
    with ex._lock:
        eng = ex._engine(variant)
        eng.warmup(prompt_lens=sorted(set(int(n) for n in lengths)))
    mark("engine warm-up")
    c.loop.schedule(0.0, lambda: worker.load_variant(variant))
    deadline = time.monotonic() + 120.0
    while not (c.store.instance(variant.name, worker.name) is not None
               and c.store.instance(variant.name, worker.name).running):
        if time.monotonic() > deadline:
            raise RuntimeError(f"{variant.name} never loaded")
        time.sleep(0.02)
    mark("variant load")
    rt = ServingRuntime(c)

    def spec(prompt, max_new):
        return QuerySpec.arch(
            arch.name, latency_ms=cfg["latency_ms"],
            payload=QueryPayload.of([prompt], max_new_tokens=max_new))

    try:
        warm = rt.submit(spec(list(range(1, 9)), 2)).result(timeout=120.0)
    except BaseException:
        rt.shutdown(drain=False, timeout=DRAIN_S)
        raise
    if not warm.ok or warm.variant != variant.name:
        rt.shutdown(drain=False, timeout=DRAIN_S)
        raise RuntimeError(f"the warm-up query: ok={warm.ok}, served by "
                           f"{warm.variant!r}")
    if trace:
        # the profiler's first start takes seconds (its device tracer
        # initializes): pay it here, not inside the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            sync(dev)
    mark("first query")
    log("set-up phases (s): " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])))
    return Ctx(cell, dev, c, rt, ex, eng, params, spec,
               time.monotonic() - c.loop.now())


def span_hooks(ctx: Ctx, span, t0: float, t1: float) -> Callable:
    """Open the profiled span at the first prefill dispatch of the
    window's last ``ARM_S`` seconds and close it before the first step
    ``SPAN_S`` later, both from the stepper thread between two device
    calls (a profiler stopped from another thread while the stepper
    launched a graph once hung the process). Returns the function that
    takes the hooks off."""
    eng, dev = ctx.engine, ctx.dev
    arm = max(t0, t1 - ARM_S)
    admit, step = eng._admit_group, eng.step

    def admit_hook(bucket, rs, slots):
        if not span.started and time.monotonic() >= arm:
            sync(dev)
            span.start(engine_counters(eng))
        return admit(bucket, rs, slots)

    def step_hook():
        # closed before a step, not after it: the stepper hands a step's
        # tokens to the clients after the step returns, so a span's last
        # tokens arrive inside it
        if span.started and not span.stopped \
                and time.monotonic() >= span.t_start + SPAN_S:
            sync(dev)
            span.stop(engine_counters(eng))
        return step()

    eng._admit_group, eng.step = admit_hook, step_hook

    def off():
        del eng._admit_group, eng.step
    return off


def ramp(ctx: Ctx, start_clients: Callable[[], None], clients: int,
         log=print) -> None:
    """A closed loop's lead-in. The worker runs one job at a time, a job
    being the queries pending when it starts; clients that all send at
    once would find the first query dispatched alone and wait out its
    whole answer. So one short query goes first and runs as a job of its
    own, ``start_clients`` sends the clients' first queries while it
    decodes, and the window opens when it has ended, on a full job."""
    first = threading.Event()
    h = ctx.runtime.submit(ctx.spec(list(range(1, 9)), LEAD_TOKENS))
    h.on_tokens(lambda ch: first.set())
    if not first.wait(120.0):
        raise RuntimeError("the lead-in query never started")
    start_clients()
    (worker,) = ctx.cluster.master.workers.values()
    li = worker.instances[ctx.cell.config["variant"]]
    deadline = time.monotonic() + 60.0
    while len(li.pending) < clients and not h.done \
            and time.monotonic() < deadline:
        time.sleep(0.001)
    queued = len(li.pending)
    if not h.result(timeout=120.0).ok:
        raise RuntimeError("the lead-in query failed")
    log(f"ramp: {queued} of {clients} clients' first queries queued "
        f"behind the lead-in query's job")


def window(ctx: Ctx, reqs, seconds: float, trace: bool, setup_t0: float,
           log=print) -> Run:
    """One measured window of ``reqs`` (``workload.draw``'s) on a set-up
    cluster, then up to ``DRAIN_S`` for the answers still out."""
    from bench import trace as tr
    mix, eng, rt = ctx.cell.mix, ctx.engine, ctx.runtime
    closed = mix["loop"] == "closed"
    t0 = time.monotonic() + 0.01
    t1 = t0 + seconds
    queries = [Query(r.prompt, r.max_new, t0 + r.due) for r in reqs]
    opened = threading.Event()       # a closed loop's t0 and t1 are set
    answered: "queue.Queue[Query]" = queue.Queue()
    sent: List[Query] = []

    def send(q: Query) -> None:
        q.sent = time.monotonic()
        h = rt.submit(ctx.spec(q.prompt, q.max_new))
        sent.append(q)
        h.on_tokens(lambda ch, q=q: q.chunks.append(
            (ch.t + ctx.mono_off, len(ch.tokens))))

        def done(h, q=q):
            res = h.result(timeout=0.0)
            q.done = time.monotonic()
            q.ok = res.ok
            if res.outputs:
                q.outputs = np.asarray(res.outputs[0], np.int32)
            answered.put(q)
        h.add_done_callback(done)

    def open_client():
        for q in queries:
            pause = q.due - time.monotonic()
            if pause > 0:
                time.sleep(pause)
            send(q)

    def closed_client():
        # the stream starts over if the window outlasts it
        stream = (dataclasses.replace(queries[i % len(queries)], chunks=[])
                  for i in itertools.count())
        for _ in range(mix["clients"]):
            q = next(stream)
            q.due = time.monotonic()
            send(q)
        opened.wait()
        while time.monotonic() < t1:
            try:
                answered.get(timeout=max(t1 - time.monotonic(), 0.0))
            except queue.Empty:
                break
            if time.monotonic() < t1:
                q = next(stream)
                q.due = time.monotonic()
                send(q)

    client = threading.Thread(
        target=closed_client if closed else open_client, name="bench-client")
    counters: Dict[str, dict] = {}
    if closed:
        try:
            ramp(ctx, client.start, mix["clients"], log)
        finally:
            t0 = time.monotonic()
            t1 = t0 + seconds
            counters["t0"] = engine_counters(eng)
            opened.set()
    else:
        while time.monotonic() < t0:
            time.sleep(0.001)
        counters["t0"] = engine_counters(eng)
        client.start()
    span = tr.Span() if trace else None
    if span is not None:
        hooks = span_hooks(ctx, span, t0, t1)
    try:
        if span is not None:
            time.sleep(max(t1 - SPAN_S - time.monotonic(), 0.0))
            with ctx.executor._lock:         # between two engine steps
                if not span.started:
                    sync(ctx.dev)
                    span.start(engine_counters(eng))
        time.sleep(max(t1 - time.monotonic(), 0.0))
        counters["t1"] = engine_counters(eng)
        if span is not None:
            with ctx.executor._lock:
                if not span.stopped:
                    sync(ctx.dev)
                    span.stop(engine_counters(eng))
                hooks()
    finally:
        client.join(DRAIN_S)
    t_end = t1 + DRAIN_S
    while time.monotonic() < t_end and any(q.done < 0 for q in sent):
        time.sleep(0.01)
    t_end = min(t_end, time.monotonic())
    # the engine metrics read the window up to the profiled span: stopping
    # the profiler holds the interpreter for seconds (it converts the
    # span's device records), which stalls every thread after the span
    t_read, counters["read"] = t1, counters["t1"]
    if span is not None:
        t_read, counters["read"] = span.t_start, span.marks["start"]
        t = time.monotonic()
        span.read()
        ks = span.kernels
        log(f"profiled span: {len(ks)} device and {len(span.host)} host "
            f"events read in {time.monotonic() - t:.1f} s; device events "
            f"from {ks[0][1] - span.t_start if ks else 0:+.3f} s to "
            f"{ks[-1][2] - span.t_stop if ks else 0:+.3f} s of the span's "
            f"ends, {span.window_s:.3f} s long")
    grew = {k: counters["read"][k] - counters["t0"][k]
            for k in ("stats.prefill_dispatches", "stats.decode_steps")}
    n_tok = sum(1 for q in sent for t, _ in q.tokens() if t0 <= t < t_read)
    log(f"engine metrics read {t_read - t0:.3f} s of the window: {n_tok} "
        f"tokens arrived, {grew['stats.prefill_dispatches']} prefill "
        f"dispatches, {grew['stats.decode_steps']} decode steps")
    lag = sorted(q.sent - q.due for q in sent)
    if lag:
        log(f"generator lag: p95 {lag[int(0.95 * (len(lag) - 1))] * 1e3:.3f}"
            f" ms, max {lag[-1] * 1e3:.3f} ms over {len(lag)} queries")
    return Run(ctx.cell, seconds, t0, t1, t_read, t_end, t0 - setup_t0,
               sent, counters, span)


def teardown(ctx: Ctx) -> None:
    """Stop the stepper and scheduler threads and free the program's state
    (the weights stay for the reference)."""
    import torch
    ctx.runtime.shutdown(drain=False, timeout=DRAIN_S)
    ctx.executor.engines.clear()
    ctx.executor._models.clear()
    ctx.cluster = ctx.runtime = ctx.executor = ctx.engine = None
    gc.collect()
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the check


def sample(run: Run, seed: int) -> List[Query]:
    """The answers the check reads: the longest and a seeded draw of the
    rest, ``SAMPLE`` in all."""
    fin = [q for q in run.queries if q.ok and q.outputs is not None
           and len(q.outputs) == q.max_new]
    if not fin:
        return []
    rng = np.random.default_rng(seed ^ 0x5EED)
    longest = max(range(len(fin)), key=lambda i: fin[i].max_new)
    rest = [i for i in range(len(fin)) if i != longest]
    n = min(SAMPLE - 1, len(rest))
    return [fin[i] for i in [longest] + list(rng.choice(rest, size=n,
                                                        replace=False))]


def gap_readings(run: Run, params, dev, seed: int, control: bool = False
                 ) -> Dict[str, Dict[str, float]]:
    """How far the served tokens of the sample lie below the plain
    reference's best logit: the widest gap (``max``), the mean gap over
    every served token (``mean``) and the share of served tokens that are
    not the reference's first choice (``flips``), as ``program``. With
    ``control``, the same of the tokens that the reference computed one
    precision lower puts first (int8 weights for a bf16 configuration,
    int4 for an int8 one), as ``control``."""
    import torch
    cfg = run.cfg
    picked = sample(run, seed)
    if not picked:
        return {}
    ref = reference(run.cell)
    seqs = [torch.as_tensor(np.concatenate([q.prompt, q.outputs[:-1]]),
                            dtype=torch.long, device=dev) for q in picked]
    bits = 8 if cfg["quantize"] == "int8" else None
    lower = 4 if cfg["quantize"] == "int8" else 8
    out = ref.served_logits(params, cfg, seqs, [q.plen - 1 for q in picked],
                            [bits, lower] if control else [bits])

    def stats(chosen):
        g = torch.cat([ref.gaps(lg, t) for lg, t in zip(out[0], chosen)])
        return {"max": float(g.max()), "mean": float(g.mean()),
                "flips": float((g > 0).float().mean())}

    read = {"program": stats([torch.as_tensor(q.outputs, device=dev)
                              for q in picked])}
    if control:
        read["control"] = stats([c.argmax(-1) for c in out[1]])
    return read


def check(run: Run, params, dev, seed: int) -> Dict[str, dict]:
    """Each number compared, with its limit: every query sent answered in
    full, and the mean gap of the sample's served tokens below the plain
    reference's best logits within the cell's ``mean_gap`` (a lower
    precision moves many tokens a little, an altered token one by a lot;
    the widest gap does not separate the two precisions, see PERF.md)."""
    unanswered = sum(not q.ok for q in run.queries)
    short = sum(q.ok and (q.outputs is None or len(q.outputs) != q.max_new
                          or sum(k for _, k in q.chunks) != q.max_new)
                for q in run.queries)
    read = gap_readings(run, params, dev, seed).get("program", {})
    return {"unanswered": {"value": unanswered, "limit": 0},
            "short_answers": {"value": short, "limit": 0},
            "mean_gap": {"value": read.get("mean"),
                         "limit": run.cell.checks["mean_gap"]}}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """A whole run of ``cell`` on ``device`` without the look for a chip:
    the result line as a dict."""
    import torch
    setup_t0 = time.monotonic() - process_age()
    dev = torch.device(device)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    reqs = workload.draw(cell.mix, seconds, seed, cell.config["vocab_size"])
    log(f"process start to set-up: {time.monotonic() - setup_t0:.3f} s")
    ctx = setup(cell, seed, dev, [len(r.prompt) for r in reqs], trace, log)
    try:
        run = window(ctx, reqs, seconds, trace, setup_t0, log)
    finally:
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        teardown(ctx)
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        v = reader(m["name"], cell.root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = check(run, ctx.params, dev, seed)
    correct = all(v["value"] is not None and v["value"] <= v["limit"]
                  for v in checks.values())
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(run.queries),
           "failed": sum(not q.ok for q in run.queries),
           "metrics": metrics, "device": device_rec}
    if trace and run.span is not None:
        device_rec["busy_s"] = run.span.busy_s()
        device_rec["window_s"] = run.span.window_s
        out["breakdown"] = {"device_ops": run.span.top_ops(),
                            "idle_gaps": run.span.idle_gaps()}
    out["check"] = checks
    return out


def jax_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(JAX_NAMES))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    torch.set_num_threads(4)
    # a run that hangs prints every thread's stack and exits non-zero
    # (the first run of a checkout, which builds, may take 1200 s)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = jax_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 4
    for name, v in out["check"].items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
