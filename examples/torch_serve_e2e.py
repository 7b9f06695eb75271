"""End-to-end driver on the PyTorch port: real serving of a small model
through the continuous-batching data plane (bucketed prefill admission,
paged decode segments, slot refill), with a measured latency fit.

The twin of ``examples/serve_e2e.py`` on ``repro_torch``. It serves the
registry's ``.reduced()`` llama3.2-1b (f32, head_dim 16) on ``--device``:
CUDA by default, which raises without a card; ``--device cpu`` runs the
plain PyTorch path. On the card ``cfg.for_device`` selects the kernels:
flash prefill and the fused paged decode at their f32 bodies, each decode
segment a replay of the engine's captured step graph.

Run:  PYTHONPATH=src python examples/torch_serve_e2e.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS
from repro_torch.core import profiler as prof
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ARCHS["llama3.2-1b"].reduced().for_device(dev)
    print(f"building {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) on "
          f"{dev}...")
    model = build_model(cfg, dev)
    params = model.init(0)
    engine = ServingEngine(model, params, max_batch=8, max_len=64,
                           decode_block=16)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, size=rng.integers(4, 12)
                                        ).astype(np.int32),
                    max_new_tokens=int(rng.integers(4, 17)))
            for i in range(20)]
    engine.warmup(prompt_lens=[len(r.prompt) for r in reqs])
    t0 = time.perf_counter()
    done = engine.serve(reqs)
    wall = time.perf_counter() - t0
    n_toks = sum(len(r.tokens) for r in done)
    print(f"served {len(done)} requests / {n_toks} tokens in "
          f"{wall*1e3:.1f} ms ({n_toks/wall:.0f} tok/s, "
          f"{len(done)/wall:.1f} req/s with continuous batching)")
    s = dict(engine.stats)
    print(f"  engine: {s['prefill_dispatches']} prefill + "
          f"{s['decode_dispatches']} decode dispatches for "
          f"{s['decode_steps']} decode steps; programs: "
          f"{s['prefill_traces']} prefill buckets, "
          f"{s['decode_traces']} captured decode graph")
    for r in done[:5]:
        print(f"  req {r.rid}: prompt_len={len(r.prompt)} -> "
              f"tokens {[int(t) for t in r.tokens]} "
              f"(latency {r.latency*1e3:.1f} ms)")
    budgets = [len(r.tokens) == r.max_new_tokens for r in done]

    # profile the real step like the INFaaS profiler would: warmup means
    # the measured t(b) is pure execution, no capture inside
    def step(batch: int) -> None:
        rs = [Request(rid=i, prompt=np.arange(8, dtype=np.int32),
                      max_new_tokens=4) for i in range(batch)]
        engine.serve(rs)

    m, c, lats = prof.profile_measured(step, batches=(1, 4, 8))
    print(f"\nmeasured latency fit: t(b) = {m*1e3:.2f}ms * b + {c*1e3:.2f}ms"
          f"  (raw: {[f'{x*1e3:.1f}ms' for x in lats]})")
    return {"served": len(done), "tokens": n_toks,
            "at_budget": sum(budgets), "stats": s, "m": m, "c": c,
            "latencies": lats}


if __name__ == "__main__":
    main()
